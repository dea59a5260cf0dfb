"""Resident wave feeds: the port's gathers, build_qt and the resident extend
wave against lariat_tpu.ops.resident (forward and reverse strands, out of
range positions, int32 and int64 descriptors); pac words against
fm_batch.pac_words_host; the index arithmetic of K1's descriptor entry (its
own gather, emulated) against build_qt, and on the card its one launch
against build_qt plus the twin. Exact: tolerance 0."""

import numpy as np
import pytest
import torch

from lariat_tpu.align import ksw
from lariat_tpu.ops import fm_batch
from lariat_tpu.ops import resident as jres
from lariat_tpu_torch.ops import resident

from test_rfa import dup_genome  # noqa: F401
from test_torch_sw_extend import cuda_device  # noqa: F401

torch.set_num_threads(1)


def _descs(rng, l_pac, n_reads, L, B=40):
    rid = rng.integers(0, n_reads, B)
    qdir = rng.choice([-1, 1], B)
    qstart = np.where(qdir > 0, rng.integers(-5, L, B),
                      rng.integers(0, L + 5, B))
    qlen = rng.integers(0, 100, B)
    # forward strand, reverse strand, both edges, and off either end
    tstart = np.concatenate([
        rng.integers(0, l_pac, B // 4),
        rng.integers(l_pac, 2 * l_pac, B // 4),
        np.array([0, l_pac - 1, l_pac, 2 * l_pac - 1, -3, 2 * l_pac + 2]),
        rng.integers(0, 2 * l_pac, B - B // 2 - 6)])
    tdir = rng.choice([-1, 1], B)
    tlen = rng.integers(0, 200, B)
    h0 = rng.integers(0, 60, B)
    w = rng.integers(1, 100, B)
    return rid, qstart, qdir, qlen, tstart, tdir, tlen, h0, w


@pytest.fixture(scope="module")
def setup(dup_genome):  # noqa: F811
    fm, _ = dup_genome
    rng = np.random.default_rng(5)
    reads = [rng.integers(0, 5, int(rng.integers(1, 151))).astype(np.uint8)
             for _ in range(9)]
    return fm, reads


def test_pac_words_from_fm_matches_host(setup):
    fm, _ = setup
    got = resident.pac_words_from_fm(fm, "cpu")
    want = np.asarray(fm_batch.pac_words_host(fm)).view(np.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_put_reads_matches(setup):
    _, reads = setup
    got = resident.put_reads(reads, "cpu")
    want = jres.put_reads(reads)
    assert (got.n, got.L) == (want.n, want.L)
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))


@pytest.mark.parametrize("wide", [False, True])
def test_gathers_and_build_qt_match(setup, wide):
    """int32 descriptors (pack_desc below 2^30 bp) and int64 ones (the
    hg38-scale layout) both gather what the reference gathers."""
    fm, reads = setup
    l_pac = int(fm.l_pac)
    rng = np.random.default_rng(17 + wide)
    desc = resident.pack_desc(*_descs(rng, l_pac, len(reads), 151), l_pac)
    np.testing.assert_array_equal(
        desc, jres.pack_desc(*(desc[:, k] for k in range(9)), l_pac))
    if wide:
        desc = desc.astype(np.int64)
    codes = resident.put_reads(reads, "cpu").codes
    pac = resident.pac_words_from_fm(fm, "cpu")
    jcodes = jres.put_reads(reads).codes
    jpac = np.asarray(fm_batch.pac_words_host(fm))
    q, t = resident.build_qt(codes, pac, l_pac, torch.from_numpy(desc),
                             Lq=128, Lt=192)
    jq, jt = jres.build_qt(jcodes, jpac, l_pac, desc, Lq=128, Lt=192)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    # the doubled text really is fetched: a reverse-strand window is the
    # complement of its forward mirror, and off-genome positions are N
    fwd = fm.fetch_fmd(100, 140)
    rev = resident.fetch_fmd_batch(
        pac, l_pac, torch.tensor([2 * l_pac - 1 - 100]), torch.tensor([-1]),
        40)[0]
    np.testing.assert_array_equal(rev.numpy(), 3 - fwd)
    off = resident.fetch_fmd_batch(pac, l_pac, torch.tensor([-2]),
                                   torch.tensor([1]), 4)[0]
    assert off.tolist()[:2] == [4, 4]


def test_extend_wave_resident_matches(setup):
    fm, reads = setup
    l_pac = int(fm.l_pac)
    rng = np.random.default_rng(23)
    desc = resident.pack_desc(*_descs(rng, l_pac, len(reads), 151), l_pac)
    opt_key = (6, 1, 6, 1, 5, 100, 1, -4)
    got = resident.extend_wave_resident(
        resident.put_reads(reads, "cpu").codes,
        resident.pac_words_from_fm(fm, "cpu"), l_pac,
        torch.from_numpy(desc), Lq=128, Lt=192, opt_key=opt_key)
    want = jres.extend_wave_resident(
        jres.put_reads(reads).codes, np.asarray(fm_batch.pac_words_host(fm)),
        l_pac, desc, np.asarray(ksw.fill_score_matrix(1, 4)), Lq=128,
        Lt=192, opt_key=opt_key, use_pallas=False)
    np.testing.assert_array_equal(got[:6].numpy(), np.asarray(want))


def emulate_desc_loads(codes, pac, l_pac, desc, Lq, Lt):
    """K1's descriptor entry (csrc/sw_extend.cu DescFeed) as its loads run,
    per task: query column j at reads[rid, qstart + j * qdir] (N out of
    range, the read too), target row i decoded from the pac word of the
    doubled-text position tstart + i * tdir -> (B, Lq) and (B, Lt) codes."""
    codes = np.asarray(codes)
    n_reads, L = codes.shape
    words = np.asarray(pac).view(np.uint32)
    B = desc.shape[0]
    q = np.full((B, Lq), 99, np.int64)
    t = np.full((B, Lt), 99, np.int64)
    for b in range(B):
        rid, qs, qd, _, ts, td = (int(v) for v in desc[b, :6])
        for j in range(Lq):
            pos = qs + j * qd
            ok = 0 <= rid < n_reads and 0 <= pos < L
            q[b, j] = codes[rid, pos] if ok else 4
        for i in range(Lt):
            p = ts + i * td
            c = 4
            if 0 <= p < 2 * l_pac:
                rev = p >= l_pac
                fwd = 2 * l_pac - 1 - p if rev else p
                c = (int(words[fwd >> 4]) >> ((15 - (fwd & 15)) * 2)) & 3
                c = 3 - c if rev else c
            t[b, i] = c
    return q, t


@pytest.mark.parametrize("wide", [False, True])
def test_desc_loads_match_build_qt(setup, wide):
    """The kernel's own gather (the index arithmetic of its descriptor
    entry) against build_qt on int32 and int64 descriptors: both strands,
    qdir and tdir -1, both ends of the doubled text and past them."""
    fm, reads = setup
    l_pac = int(fm.l_pac)
    rng = np.random.default_rng(29 + wide)
    desc = resident.pack_desc(*_descs(rng, l_pac, len(reads), 151), l_pac)
    if wide:
        desc = desc.astype(np.int64)
    codes = resident.put_reads(reads, "cpu").codes
    pac = resident.pac_words_from_fm(fm, "cpu")
    q, t = resident.build_qt(codes, pac, l_pac, torch.from_numpy(desc),
                             Lq=64, Lt=96)
    eq, et = emulate_desc_loads(codes.numpy(), pac.numpy(), l_pac, desc,
                                64, 96)
    np.testing.assert_array_equal(eq, q.numpy())
    np.testing.assert_array_equal(et, t.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("wide", [False, True])
def test_extend_wave_resident_kernel_matches_twin(setup, cuda_device, wide):
    """One launch of K1's descriptor entry against build_qt plus the twin,
    and against the tile entry on build_qt's tiles."""
    from lariat_tpu_torch.ops import _build, sw_extend
    fm, reads = setup
    l_pac = int(fm.l_pac)
    rng = np.random.default_rng(31 + wide)
    desc = resident.pack_desc(*_descs(rng, l_pac, len(reads), 151, B=300),
                              l_pac)
    if wide:
        desc = desc.astype(np.int64)
    opt_key = (6, 1, 6, 1, 5, 100, 1, -4)
    args = (resident.put_reads(reads, "cpu").codes,
            resident.pac_words_from_fm(fm, "cpu"))
    want = resident.extend_wave_resident(*args, l_pac,
                                         torch.from_numpy(desc), Lq=160,
                                         Lt=224, opt_key=opt_key)
    dev_args = [a.to(cuda_device) for a in args]
    desc_d = torch.from_numpy(desc).to(cuda_device)
    _build.reset_launches()
    got = resident.extend_wave_resident(*dev_args, l_pac, desc_d, Lq=160,
                                        Lt=224, opt_key=opt_key)
    torch.cuda.synchronize()
    assert _build.launches()["sw_extend"] == 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    q, t = resident.build_qt(*dev_args, l_pac, desc_d, 160, 224)
    cols = [desc_d[:, k].to(torch.int32).contiguous()
            for k in (resident.D_QL, resident.D_TL, resident.D_W,
                      resident.D_H0)]
    st_tiles, st_desc = (torch.full((desc.shape[0],), -1, dtype=torch.int32,
                                    device=cuda_device) for _ in range(2))
    tiles = sw_extend.extend_batch(q, cols[0], t, cols[1], cols[2], cols[3],
                                   steps=st_tiles)
    np.testing.assert_array_equal(tiles.cpu().numpy(), want.numpy())
    # both entries run one schedule, so count the same steps
    sw_extend.extend_desc(*dev_args, l_pac, desc_d, 160, 224, steps=st_desc)
    assert torch.equal(st_desc, st_tiles) and int(st_desc.min()) >= 0
