"""The port's device align step against lariat_tpu's (parallel/align_step.py
and ops/fm_batch.py, XLA on the CPU, ``use_pallas=False``): the single-code
rank and the backward-search step, the exact match under both N rules
(the whole read empties on N, the suffix skips it), the window fetch, the
SA lookup with its samples added, and ``align_step`` / ``align_step_smem``
on planted, random, N-bearing, short and genome-end reads, with int32 and
int64 indices. Every output is an integer: tolerance 0. The ``cuda`` cases
hold K7, K8, K5's lookup entry and both steps against their plain twins on
the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lariat_tpu.align import ksw
from lariat_tpu.ops import fm_batch as jfm
from lariat_tpu.parallel import align_step as jas
from lariat_tpu_torch.index import native_ops
from lariat_tpu_torch.ops import _build
from lariat_tpu_torch.ops import fm_batch as tfm
from lariat_tpu_torch.parallel import align_step as tas

from test_rfa import dup_genome  # noqa: F401
from test_torch_sw_extend import cuda_device  # noqa: F401

torch.set_num_threads(1)

MAT = np.asarray(ksw.fill_score_matrix(1, 4))
FIELDS = ("pos", "is_rev", "n_hits", "score", "mapped")


def _fmd(fm, dt, dev="cpu"):
    L2 = fm.L2.astype(np.int64 if dt == "int64" else np.int32)
    return tfm.DeviceFMIndex.from_numpy(tfm.fused_table(fm), L2, fm.primary,
                                        fm.seq_len, dev)


@pytest.fixture(scope="module")
def setup(dup_genome):  # noqa: F811
    fm, genome = dup_genome
    codes = fm.get_seq_codes(0, fm.l_pac).copy()
    return fm, codes, jfm.DeviceFMIndex.from_host(fm), \
        jas.DeviceGenome.from_host(fm)


def _genome(fm, dt, dev="cpu"):
    return tas.DeviceGenome.from_host(fm, _fmd(fm, dt, dev))


def _t(a, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))


def _rank_rows(fm, rng, n=2048):
    """Rows in [-1, seq_len] with the edges planted."""
    k = rng.integers(-1, fm.seq_len + 1, n)
    edges = [-1, 0, 1, fm.seq_len - 1, fm.seq_len,
             *range(fm.primary - 2, fm.primary + 3), 127, 128, 129, 255]
    k[:len(edges)] = edges
    return k


@pytest.mark.parametrize("dt", ["int32", "int64"])
def test_occ1_and_backward_ext_match_jax(setup, dt):
    fm, _, jdfm, _ = setup
    fmd = _fmd(fm, dt)
    rng = np.random.default_rng(3)
    k = _rank_rows(fm, rng)
    c = rng.integers(0, 4, len(k)).astype(np.int32)
    want = np.asarray(jfm.occ1_batch(jdfm, jnp.asarray(k.astype(np.int32)),
                                     jnp.asarray(c)))
    got = tfm.occ1_batch(fmd, _t(k), _t(c))
    assert got.dtype == fmd.idx_dtype
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper of K7's occ1 entry runs the twin on a CPU tensor
    np.testing.assert_array_equal(
        tfm.occ1_rank(fmd, _t(k).to(fmd.idx_dtype), _t(c)).numpy(), want)
    np.testing.assert_array_equal(
        want[:40], [fm.occ(int(a), int(b)) if 0 <= a < fm.seq_len else
                    (0 if a < 0 else int(fm.L2[b + 1] - fm.L2[b]))
                    for a, b in zip(k[:40], c[:40])])
    # one backward step from [k, l], k = 0 .. seq_len, l >= k - 1
    kk = rng.integers(0, fm.seq_len + 1, len(k))
    ll = np.minimum(kk - 1 + (rng.random(len(k)) ** 3 * 4000).astype(int),
                    fm.seq_len)
    kk[:6] = [0, 0, fm.primary, fm.primary + 1, fm.primary - 1, fm.seq_len]
    ll[:6] = [fm.seq_len, 0, fm.primary, fm.primary + 5, fm.primary + 1,
              fm.seq_len]
    jw = jfm.backward_ext_batch(jdfm, jnp.asarray(kk.astype(np.int32)),
                                jnp.asarray(ll.astype(np.int32)),
                                jnp.asarray(c))
    tw = tfm.backward_ext_batch(fmd, _t(kk), _t(ll), _t(c))
    for g, w in zip(tw, jw):
        assert g.dtype == fmd.idx_dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _exact_reads(codes, rng, B=64, L=80):
    """Reads of the genome (hits), with one mutation near the 3' end (empty
    early; some with an N later in the scan), N at the first base, the last
    base and mid-read, lens 0 and random reads."""
    reads = np.full((B, L), 4, np.uint8)
    lens = rng.integers(30, L + 1, B).astype(np.int32)
    for i in range(B):
        p = int(rng.integers(0, len(codes) - L))
        reads[i, :lens[i]] = codes[p:p + lens[i]]
    n = lens
    for i in range(8, 16):                  # mutated near the end
        reads[i, n[i] - 3] = (reads[i, n[i] - 3] + 1) % 4
    reads[12:16, 0] = 4                     # ... and an N scanned after it
    reads[16:20, 0] = 4                     # N at the first base
    rows = np.arange(20, 28)
    reads[rows[:4], n[rows[:4]] - 1] = 4    # N at the last base
    reads[rows[4:], n[rows[4:]] // 2] = 4   # N mid-read
    lens[28:30] = 0
    reads[30:36] = rng.integers(0, 4, (6, L))
    reads[36, :3] = 4
    return reads, lens


@pytest.mark.parametrize("dt", ["int32", "int64"])
def test_exact_match_batch_matches_jax(setup, dt):
    fm, codes, jdfm, _ = setup
    reads, lens = _exact_reads(codes, np.random.default_rng(5))
    jk, jl = (np.asarray(v) for v in jfm.exact_match_batch(
        jdfm, jnp.asarray(reads), jnp.asarray(lens)))
    fmd = _fmd(fm, dt)
    k, l = tfm.exact_match_batch(fmd, _t(reads), _t(lens))
    assert k.dtype == l.dtype == fmd.idx_dtype
    np.testing.assert_array_equal(k.numpy(), jk)
    np.testing.assert_array_equal(l.numpy(), jl)
    # the cases are what they claim: hits, then reads emptied by a
    # mismatch or an N, each with l = k - 1 (the kernel stops there)
    assert (jk[:8] <= jl[:8]).all()
    assert (jl[8:28] == jk[8:28] - 1).all()
    assert (jk[28:30] == 0).all() and (jl[28:30] == fm.seq_len).all()


@pytest.mark.parametrize("dt", ["int32", "int64"])
def test_exact_match_suffix_skips_n(setup, dt):
    """The suffix search skips an N as if it were deleted: a genome
    suffix with an N inserted (or appended) stays a hit, where the emptying
    rule gives an empty interval, so the test fails if the port empties
    instead. Spans under seed_len too."""
    fm, codes, jdfm, _ = setup
    rng = np.random.default_rng(6)
    reads, lens = _exact_reads(codes, rng)
    B, L = reads.shape
    seed_len = 32
    lens[40:44] = [5, 12, 31, 1]                  # span under seed_len
    for i in range(44, 52):                       # an N inserted in the suffix
        p, n = int(rng.integers(0, len(codes) - L)), int(lens[i])
        seg = codes[p:p + n - 1]
        reads[i, :n] = np.concatenate([seg[:n - 10], [4], seg[n - 10:]])
    rows = np.arange(52, 56)
    reads[rows, lens[rows] - 1] = 4               # N at its last base
    start = np.maximum(lens - seed_len, 0).astype(np.int32)
    idx = np.arange(L)[None, :]
    seeds = np.where((idx >= start[:, None]) & (idx < lens[:, None]), reads,
                     4).astype(np.uint8)
    jk, jl = (np.asarray(v) for v in jas.exact_match_batch_suffix(
        jdfm, jnp.asarray(seeds), jnp.asarray(start), jnp.asarray(lens),
        max_iters=seed_len))
    fmd = _fmd(fm, dt)
    k, l = tas.exact_match_batch_suffix(fmd, _t(seeds), _t(start), _t(lens),
                                        max_iters=seed_len)
    np.testing.assert_array_equal(k.numpy(), jk)
    np.testing.assert_array_equal(l.numpy(), jl)
    # skipped: still a hit; emptied under the other rule
    assert (jk[44:56] <= jl[44:56]).all()
    ek, el = tfm.backward_search(fmd, _t(seeds), _t(lens), _t(start),
                                 seed_len, skip_n=False)
    assert (ek[44:56] > el[44:56]).all()


@pytest.mark.parametrize("dt", ["int32", "int64"])
def test_fetch_window_matches_jax(setup, dt):
    fm, codes, _, jg = setup
    n = fm.l_pac
    length = 70
    start = np.concatenate([
        [-200, -70, -69, -40, -17, -16, -15, -1, 0, 1],
        np.arange(16) + 4096,                     # every in-word offset
        np.arange(16) - 48,                       # ... below 0 too
        [n - 100, n - 70, n - 69, n - 30, n - 1, n, n + 3, n + 100],
        np.random.default_rng(8).integers(-100, n + 100, 40)])
    want = np.asarray(jas.fetch_window_batch(
        jg, jnp.asarray(start.astype(np.int32)), length))
    g = _genome(fm, dt)
    got = tas.fetch_window_batch(g, _t(start), length)
    assert got.dtype == torch.int32 and got.shape == (len(start), length)
    np.testing.assert_array_equal(got.numpy(), want)
    for i in (0, 10, 30, 45, 47):
        s = int(start[i])
        ref = np.full(length, 4, np.int64)
        lo, hi = max(s, 0), min(s + length, n)
        if hi > lo:
            ref[lo - s:hi - s] = codes[lo:hi]
        np.testing.assert_array_equal(got[i].numpy(), ref)


@pytest.mark.parametrize("dt", ["int32", "int64"])
def test_sa_lookup_batch_matches_jax_and_native(setup, dt):
    fm, _, _, jg = setup
    rng = np.random.default_rng(9)
    rows = rng.integers(0, fm.seq_len + 1, 3000)
    rows[:6] = [0, fm.primary, fm.primary - 1, fm.primary + 1, fm.seq_len,
                fm.seq_len - 1]
    want = np.asarray(jas.sa_lookup_batch(jg, jnp.asarray(
        rows.astype(np.int32))))
    g = _genome(fm, dt)
    assert g.sa_samples is None
    got = tas.sa_lookup_batch(g, _t(rows).to(g.fmd.idx_dtype))
    assert got.dtype == torch.int64 and g.sa_samples is not None
    np.testing.assert_array_equal(got.numpy(), want)
    native = native_ops.sa_lookup_batch(fm, rows)
    assert native is not None
    np.testing.assert_array_equal(got.numpy()[1:], native[1:])
    # the host lookup (the seeding path) adds the samples on the host and
    # uploads none
    g2 = _genome(fm, dt)
    np.testing.assert_array_equal(tas.sa_lookup_batch_host(g2, fm, rows),
                                  got.numpy())
    assert g2.sa_samples is None


def _step_reads(codes, rng, B=48, L=100):
    """Planted forward and reverse reads (one substitution), reads at both
    genome ends, random (unmapped) reads, reads with N (inside the seed
    suffix and elsewhere), short reads and lens 0; returns (reads, lens,
    planted start or -1)."""
    n = len(codes)
    reads = np.full((B, L), 4, np.uint8)
    lens = np.full(B, L, np.int32)
    truth = np.full(B, -1, np.int64)
    for i in range(30):
        p = int(rng.integers(0, n - L))
        if i in (0, 1):
            p = 0
        elif i in (2, 3):
            p = n - L
        seg = codes[p:p + L].copy()
        if i % 2:
            seg = (3 - seg)[::-1]
        if i >= 4:
            q = int(rng.integers(0, L - 40))
            seg[q] = (seg[q] + 1) % 4
        reads[i] = seg
        truth[i] = p
    reads[30:38] = rng.integers(0, 4, (8, L))      # random: unmapped
    for i in range(38, 44):                         # N in and off the seed
        reads[i] = codes[1000 * i:1000 * i + L]
    reads[38:41, L - 5] = 4
    reads[41:44, 10] = 4
    reads[44:47] = codes[5000:5000 + L]
    lens[44:47] = [25, 12, 1]
    reads[47] = codes[7000:7000 + L]
    lens[47] = 0
    return reads, lens, truth


@pytest.fixture(scope="module")
def step_case(setup):
    fm, codes, _, jg = setup
    reads, lens, truth = _step_reads(codes, np.random.default_rng(21))
    want = {}
    for name, fn in (("align_step", jas.align_step),
                     ("align_step_smem", jas.align_step_smem)):
        res = fn(jg, jnp.asarray(reads), jnp.asarray(lens), jnp.asarray(MAT),
                 use_pallas=False)
        want[name] = {f: np.asarray(getattr(res, f)) for f in FIELDS}
    return reads, lens, truth, want


@pytest.mark.parametrize("dt", ["int32", "int64"])
@pytest.mark.parametrize("name", ["align_step", "align_step_smem"])
def test_align_step_matches_jax(setup, step_case, dt, name):
    """Every field on every lane, unmapped lanes' scores included."""
    fm = setup[0]
    reads, lens, truth, want = step_case
    g = _genome(fm, dt)
    clock = tas.StepClock(torch.device("cpu"))
    got = getattr(tas, name)(g, _t(reads), _t(lens), MAT, clock=clock)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), want[name][f],
                                      err_msg=f)
    w = want[name]
    assert w["mapped"][:30].all() and not w["mapped"][30:38].any()
    assert (w["pos"][:30] == truth[:30]).sum() >= 28
    assert (w["score"][30:38] != 0).any()           # unmapped lanes extend
    parts = set(clock.ms())
    assert {"sa_lookup", "fetch_window", "extend", "orient"} <= parts
    assert ("exact_match" in parts) == (name == "align_step")
    assert ("min_starts" in parts) == (name == "align_step_smem")
    # the same step through the plain twins explicitly
    plain = getattr(tas, name)(g, _t(reads), _t(lens), MAT, plain=True)
    for f in FIELDS:
        assert torch.equal(getattr(plain, f), getattr(got, f)), f


def test_align_step_refuses_other_matrices(setup):
    fm, codes, _, _ = setup
    g = _genome(fm, "int32")
    reads = _t(codes[:64].reshape(1, 64))
    lens = _t(np.array([64], np.int32))
    bad = MAT.copy()
    bad[0, 1] = -3
    for fn in (tas.align_step, tas.align_step_smem):
        with pytest.raises(ValueError, match="uniform"):
            fn(g, reads, lens, bad)
    res = tas.align_step(g, reads, lens, ksw.fill_score_matrix(2, 5))
    assert bool(res.mapped[0]) and int(res.pos[0]) == 0


def test_engine_seeding_genome_shares_pac_and_uploads_no_samples(
        dup_genome, monkeypatch):  # noqa: F811
    """The engine's DeviceGenome holds the waves' pac tensor and never
    uploads the SA samples on the seeding path."""
    from lariat_tpu_torch.align.batch_engine import TorchBatchAlignmentEngine
    fm, _ = dup_genome
    eng = TorchBatchAlignmentEngine(fm, device="cpu")
    fmd, dg = eng._seed_index()
    assert dg.pac_words is eng._pac_resident()[0]
    assert dg.pac() is dg.pac_words and dg.sa_samples is None
    rows = np.arange(0, 400, 7)
    tas.sa_lookup_batch_host(dg, fm, rows)
    assert dg.sa_samples is None


# ---- the kernels against their twins on the card --------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["int32", "int64"])
def test_exact_match_kernel_matches_twin(setup, cuda_device, dt):  # noqa: F811
    fm, codes, _, _ = setup
    reads, lens = _exact_reads(codes, np.random.default_rng(5))
    start = np.maximum(lens - 32, 0).astype(np.int32)
    k = _rank_rows(fm, np.random.default_rng(3))
    c = np.random.default_rng(4).integers(0, 4, len(k)).astype(np.int32)
    for skip_n, st, mi in ((False, None, None), (True, start, 32),
                           (False, start, 32), (True, None, None)):
        f = _fmd(fm, dt, cuda_device)
        args = (_t(reads).to(cuda_device), _t(lens).to(cuda_device),
                None if st is None else _t(st).to(cuda_device), mi, skip_n)
        before = _build.launches()["exact_match"]
        got = tfm.backward_search(f, *args)
        assert _build.launches()["exact_match"] == before + 1
        want = tfm.backward_search_plain(f, *args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    f = _fmd(fm, dt, cuda_device)
    kd = _t(k).to(cuda_device, f.idx_dtype)
    got = tfm.occ1_rank(f, kd, _t(c).to(cuda_device))
    assert torch.equal(got, tfm.occ1_batch(f, kd, _t(c).to(cuda_device)))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["int32", "int64"])
def test_fetch_window_and_lookup_kernels_match_twins(setup, cuda_device,
                                                     dt):  # noqa: F811
    fm = setup[0]
    n = fm.l_pac
    start = np.concatenate([np.arange(-40, 40), np.arange(n - 40, n + 40),
                            np.random.default_rng(2).integers(-5, n, 200)])
    g = _genome(fm, dt, cuda_device)
    sd = _t(start).to(cuda_device)
    got = tas.fetch_window_batch(g, sd, 183)
    assert torch.equal(got, tas.fetch_window_batch_plain(g, sd, 183))
    rows = np.random.default_rng(9).integers(0, fm.seq_len + 1, 5000)
    rows[:4] = [0, fm.primary, fm.primary + 1, fm.seq_len]
    kd = _t(rows).to(cuda_device, g.fmd.idx_dtype)
    got = tas.sa_lookup_batch(g, kd)
    assert torch.equal(got, tas.sa_lookup_batch_plain(g, kd))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  tas.sa_lookup_batch_host(g, fm, rows))


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["int32", "int64"])
@pytest.mark.parametrize("name", ["align_step", "align_step_smem"])
def test_align_step_on_card_matches_twins(setup, step_case, cuda_device, dt,
                                          name):  # noqa: F811
    fm = setup[0]
    reads, lens, _, want = step_case
    g = _genome(fm, dt, cuda_device)
    rd, ld = _t(reads).to(cuda_device), _t(lens).to(cuda_device)
    got = getattr(tas, name)(g, rd, ld, MAT)
    plain = getattr(tas, name)(g, rd, ld, MAT, plain=True)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(plain, f)), f
        np.testing.assert_array_equal(getattr(got, f).cpu().numpy(),
                                      want[name][f], err_msg=f)
