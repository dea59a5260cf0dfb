"""The port's device align step against lariat_tpu's (parallel/align_step.py
and ops/fm_batch.py, XLA on the CPU, ``use_pallas=False``): the single-code
rank and the backward-search step, the exact match under both N rules
(the whole read empties on N, the suffix skips it), the window fetch, the
SA lookup with its samples added, K1's step entry (the window fetch, the
orientation and the extension in one) and ``align_step`` /
``align_step_smem`` on planted, random, N-bearing, short and genome-end
reads, with int32 and int64 indices. K7's group schedule (``csrc/fm.cuh``
``occ1_pair_group``, the staged and masked bases of
``csrc/exact_match.cu``) and the step entry's window staging are emulated
in numpy and held against both packages. Every output is an integer:
tolerance 0. The ``cuda`` cases hold K7, K8, K5's lookup entry, the step
entry and both steps against their plain twins on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lariat_tpu.align import ksw
from lariat_tpu.ops import fm_batch as jfm
from lariat_tpu.ops import sw_batch as jsw
from lariat_tpu.parallel import align_step as jas
from lariat_tpu_torch.index import native_ops
from lariat_tpu_torch.ops import _build
from lariat_tpu_torch.ops import fm_batch as tfm
from lariat_tpu_torch.ops import resident, sw_extend
from lariat_tpu_torch.parallel import align_step as tas

from test_rfa import dup_genome  # noqa: F401
from test_torch_fm_batch import _keep_mask, _popcount
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


# ---- K7's group schedule (csrc/fm.cuh occ1_pair_group, exact_match.cu) -----

def _code_match(w, c):
    """Low bit of each 2-bit field of w set iff it equals c (arrays)."""
    y = w ^ (c.astype(np.uint64) * np.uint64(0x55555555))
    return ~(y | (y >> np.uint64(1))) & np.uint64(0x55555555)


def emulate_occ1_group(fused, L2, primary, seq_len, ka, kb, c, G):
    """occ1 at ka and kb for codes c (arrays) as K7's group of G threads
    computes them: checkpoint word c of both rows loaded by every thread
    (the second skipped when both ranks share a block), the bwt words split
    16/G a thread (the first G/2 threads rank ka; a thread whose words lie
    past its rank's position loads none), one popcount a word, summed by
    xor-shuffles within each half and swapped across the halves -> (ta,
    tb); every thread of the group must end with the same ranks."""
    H, WPT = G // 2, 8 // (G // 2)
    rows = fused.view(np.uint32).astype(np.uint64)

    def at(k):
        kk = np.clip(np.where(k >= primary, k - 1, k), 0, seq_len - 1)
        return (k >= 0) & (k != seq_len), (kk + 1) >> 7, (kk + 1) & 127

    la, ba, ra = at(ka)
    lb, bb, rb = at(kb)
    same = la & lb & (ba == bb)
    cka = np.where(la, rows[ba, c], 0)
    ckb = np.where(same, cka, np.where(lb, rows[bb, c], 0))
    cnt = []
    for g in range(G):
        on_b, part = g >= H, g & (H - 1)
        load, blk, rem = (lb, bb, rb) if on_b else (la, ba, ra)
        load = load & (rem > 16 * WPT * part)
        n = np.zeros(len(ka), np.uint64)
        for i in range(WPT):
            wi = part * WPT + i
            w = np.where(load, rows[blk, 4 + wi], 0).astype(np.uint64)
            n += _popcount(_code_match(w, c)
                           & _keep_mask(np.clip(rem - 16 * wi, 0, 16)))
        cnt.append(n.astype(np.int64))
    o = 1
    while o < H:                       # __shfl_xor_sync(gmask, cnt, o)
        cnt = [cnt[g] + cnt[g ^ o] for g in range(G)]
        o <<= 1
    L2 = np.asarray(L2, np.int64)
    tot = L2[c + 1] - L2[c]

    def edge(k, v):
        return np.where(k < 0, 0, np.where(k == seq_len, tot, v))

    outs = []
    for g in range(G):
        mine, other = cnt[g], cnt[g ^ H]
        pa, pb = (other, mine) if g >= H else (mine, other)
        outs.append((edge(ka, cka.astype(np.int64) + pa),
                     edge(kb, ckb.astype(np.int64) + pb)))
    for g in range(1, G):
        np.testing.assert_array_equal(outs[g][0], outs[0][0])
        np.testing.assert_array_equal(outs[g][1], outs[0][1])
    return outs[0]


def emulate_exact_match(fmd, reads, lens, start, n_iters, skip_n, G=8,
                        chunk=32):
    """K7 as its groups run it: each read's next ``chunk`` bases staged
    (base t at p = clip(len - 1 - t, 0, L - 1), N unless start <= p < len
    in the suffix form), then the chain over them on the group rank, an N
    skipped or emptying, a group leaving once its interval is empty ->
    (k, l, rank steps) int64 arrays."""
    B, L = reads.shape
    fused = fmd.fused.numpy()
    L2 = fmd.L2.numpy().astype(np.int64)
    lens = lens.astype(np.int64)
    s0 = np.zeros(B, np.int64) if start is None else start.astype(np.int64)
    n = np.minimum(n_iters, lens - s0)
    k = np.zeros(B, np.int64)
    l = np.full(B, fmd.seq_len, np.int64)
    ran = np.zeros(B, np.int64)
    done = np.zeros(B, bool)
    for t0 in range(0, max(int(n.max()), 0) if B else 0, chunk):
        j = np.arange(chunk)[None, :]
        p = np.clip(lens[:, None] - 1 - (t0 + j), 0, L - 1)
        keep = t0 + j < n[:, None]
        if start is not None:
            keep &= (p >= s0[:, None]) & (p < lens[:, None])
        staged = np.where(keep, np.take_along_axis(reads, p, 1), 4)
        for jj in range(chunk):
            live = ~done & (t0 + jj < n)
            c = staged[:, jj].astype(np.int64)
            is_n = live & (c >= 4)
            if not skip_n:
                l = np.where(is_n, k - 1, l)
                done |= is_n
            step = live & (c < 4)
            cc = np.clip(c, 0, 3)
            ta, tb = emulate_occ1_group(fused, L2, fmd.primary, fmd.seq_len,
                                        k - 1, l, cc, G)
            k = np.where(step, L2[cc] + ta + 1, k)
            l = np.where(step, L2[cc] + tb, l)
            ran += step
            done |= step & (k > l)
    return k, l, ran


def _suffix_reads(codes, rng, L=80):
    """``_exact_reads`` plus the suffix form's edges: lens 0, 1, 31, 32, L,
    L + 1 and past L + 31 (the mask turns base L - 1 into N there), Ns in
    the last 32 bases and before them."""
    reads, lens = _exact_reads(codes, rng, L=L)
    lens[36:44] = [0, 1, 31, 32, L, L + 1, L + 32, L + 200]
    for i in range(44, 50):
        reads[i, lens[i] - 1 - int(rng.integers(0, 32))] = 4  # in the suffix
    reads[50:54, 10] = 4                                      # before it
    return reads, lens


@pytest.mark.parametrize("dt", ["int32", "int64"])
def test_occ1_group_rank_emulation_matches_both(setup, dt):
    """K7's group rank, G 4 and 8, against both packages' ``occ1_batch``:
    rows around primary and at the edges, pairs in one block and in two,
    positions in the first and the second half of a block."""
    fm, _, jdfm, _ = setup
    fmd = _fmd(fm, dt)
    rng = np.random.default_rng(13)
    ka = _rank_rows(fm, rng)
    kb = np.minimum(ka + (rng.random(len(ka)) ** 4 * 600).astype(np.int64),
                    fm.seq_len)
    kb[::7] = ka[::7]
    c = rng.integers(0, 4, len(ka))
    wa, wb = (np.asarray(jfm.occ1_batch(jdfm, jnp.asarray(k.astype(
        np.int32)), jnp.asarray(c.astype(np.int32)))) for k in (ka, kb))
    for G in (4, 8):
        ta, tb = emulate_occ1_group(fmd.fused.numpy(), fmd.L2.numpy(),
                                    fm.primary, fm.seq_len, ka, kb, c, G)
        np.testing.assert_array_equal(ta, wa)
        np.testing.assert_array_equal(tb, wb)
        np.testing.assert_array_equal(
            tb, tfm.occ1_batch(fmd, _t(kb), _t(c)).numpy())


@pytest.mark.parametrize("dt", ["int32", "int64"])
def test_exact_match_mask_in_kernel_matches_jax(setup, dt):
    """The suffix form on the reads as they are, the seed mask applied
    where a base is read, against JAX's ``exact_match_batch_suffix`` on the
    masked seeds its ``align_step`` builds (the skip rule), and against the
    emptying rule on the suffix moved to the front (JAX
    ``exact_match_batch``); the twin and the emulated kernel schedule
    agree under both rules, and masking first changes nothing."""
    fm, codes, jdfm, _ = setup
    rng = np.random.default_rng(17)
    reads, lens = _suffix_reads(codes, rng)
    B, L = reads.shape
    seed_len = 32
    start = np.maximum(lens - seed_len, 0).astype(np.int32)
    idx = np.arange(L)[None, :]
    seeds = np.where((idx >= start[:, None]) & (idx < lens[:, None]), reads,
                     4).astype(np.uint8)
    jk, jl = (np.asarray(v) for v in jas.exact_match_batch_suffix(
        jdfm, jnp.asarray(seeds), jnp.asarray(start), jnp.asarray(lens),
        max_iters=seed_len))
    fmd = _fmd(fm, dt)
    for skip_n in (True, False):
        k, l = tfm.backward_search(fmd, _t(reads), _t(lens), _t(start),
                                   seed_len, skip_n=skip_n)
        mk, ml = tfm.backward_search(fmd, _t(seeds), _t(lens), _t(start),
                                     seed_len, skip_n=skip_n)
        assert torch.equal(k, mk) and torch.equal(l, ml)
        ek, el, _ = emulate_exact_match(fmd, reads, lens, start, seed_len,
                                        skip_n)
        np.testing.assert_array_equal(k.numpy(), ek)
        np.testing.assert_array_equal(l.numpy(), el)
        if skip_n:
            np.testing.assert_array_equal(k.numpy(), jk)
            np.testing.assert_array_equal(l.numpy(), jl)
            continue
        # the emptying rule: the masked suffix moved to the front, its
        # length the span (reads with lens <= L; the mask leaves the rest
        # all N past L - 1, checked above against the masked seeds)
        span = np.clip(lens - start, 0, None)
        ok = lens <= L
        front = np.full_like(reads, 4)
        for i in np.flatnonzero(ok):
            front[i, :span[i]] = reads[i, start[i]:lens[i]]
        fk, fl = (np.asarray(v) for v in jfm.exact_match_batch(
            jdfm, jnp.asarray(front), jnp.asarray(span.astype(np.int32))))
        np.testing.assert_array_equal(k.numpy()[ok], fk[ok])
        np.testing.assert_array_equal(l.numpy()[ok], fl[ok])
    # the cases are what they claim: past L + 31 the read's base L - 1 is
    # masked, so both lanes are N only (whole index under the skip rule)
    assert (jk[42:44] == 0).all() and (jl[42:44] == fm.seq_len).all()
    assert (jk[:8] <= jl[:8]).all()


@pytest.mark.parametrize("skip_n", [False, True])
def test_exact_match_whole_read_emulation(setup, skip_n):
    """The whole-read form (no mask, chains past one staged chunk) as the
    kernel runs it, against the twin, and under the emptying rule against
    JAX's ``exact_match_batch``."""
    fm, codes, jdfm, _ = setup
    reads, lens = _suffix_reads(codes, np.random.default_rng(19))
    fmd = _fmd(fm, "int32")
    k, l = tfm.backward_search(fmd, _t(reads), _t(lens), skip_n=skip_n)
    ek, el, ran = emulate_exact_match(fmd, reads, lens, None, reads.shape[1],
                                      skip_n)
    np.testing.assert_array_equal(k.numpy(), ek)
    np.testing.assert_array_equal(l.numpy(), el)
    assert ran.max() > 32                      # past the first chunk
    if not skip_n:
        jk, jl = (np.asarray(v) for v in jfm.exact_match_batch(
            jdfm, jnp.asarray(reads), jnp.asarray(lens)))
        np.testing.assert_array_equal(ek, jk)
        np.testing.assert_array_equal(el, jl)


# ---- K1's step entry (csrc/sw_extend.cu StepFeed) ---------------------------

def emulate_step_targets(pac_words, l_pac, fwd_start, n):
    """The step entry's window as its warp stages it: lane k (then k + 32,
    ...) loads word floor(fwd_start / 16) + k when it holds text and writes
    its 16 codes that fall in [0, n), 4 at positions outside [0, l_pac)."""
    words = pac_words.view(np.uint32).astype(np.int64)
    out = np.full((len(fwd_start), n), -1, np.int64)
    for b, s in enumerate(fwd_start.astype(np.int64)):
        w0 = s >> 4
        off = int(s - (w0 << 4))
        for k in range((off + n + 15) >> 4):
            wi = w0 + k
            p0 = wi << 4
            word = int(words[wi]) if 0 <= wi and p0 < l_pac else 0
            for e in range(16):
                i = 16 * k + e - off
                if 0 <= i < n:
                    p = p0 + e
                    out[b, i] = ((word >> (2 * (15 - e))) & 3
                                 if 0 <= p < l_pac else 4)
    assert (out >= 0).all()
    return out


def _step_hits(fm, codes, rng, B=40, L=90, W=32):
    """Reads and their hits as the step's SA lookup gives them: forward and
    reverse hits (Ns in some reads, short and empty reads), windows that
    cross 0 and l_pac, and unmapped lanes (start -1 - qb) -> (reads, lens,
    fwd_start int64, is_rev bool)."""
    n = fm.l_pac
    reads = np.full((B, L), 4, np.uint8)
    lens = np.full(B, L, np.int32)
    fwd = rng.integers(0, n - L, B).astype(np.int64)
    is_rev = np.arange(B) % 2 == 1
    for i in range(B):
        seg = codes[fwd[i]:fwd[i] + L].copy()
        if is_rev[i]:
            seg = (3 - seg)[::-1]
        seg[int(rng.integers(0, L))] = int(rng.integers(0, 4))
        reads[i] = seg
    fwd[:4] = [-20, -5, -L - W - 3, 0]                   # across 0
    fwd[4:8] = [n - L, n - L + 10, n - 3, n + 5]         # across l_pac
    fwd[8:12] = -1 - np.array([0, 5, 58, 118])           # unmapped lanes
    reads[12:16, rng.integers(0, L, 4)] = 4              # N in reads
    reads[16:18, 0] = 4
    lens[18:22] = [0, 1, 31, L - 7]
    reads[22:26] = rng.integers(0, 5, (4, L))            # random, with N
    return reads, lens, fwd, is_rev


def test_step_entry_staging_emulation(setup):
    """The step entry's window staging and its in-place orientation against
    the twins and JAX's ``fetch_window_batch`` / revcomp."""
    fm, codes, _, jg = setup
    reads, lens, fwd, is_rev = _step_hits(fm, codes, np.random.default_rng(23))
    B, L = reads.shape
    n = L + 32
    pac = resident.pac_words_from_fm(fm, "cpu")
    got = emulate_step_targets(pac.numpy(), fm.l_pac, fwd, n)
    np.testing.assert_array_equal(
        got, resident.fetch_forward_batch(pac, fm.l_pac, _t(fwd), n).numpy())
    np.testing.assert_array_equal(got, np.asarray(jas.fetch_window_batch(
        jg, jnp.asarray(fwd.astype(np.int32)), n)))
    # qcode(b, j) for j < min(lens, L): reads[b, j], or the complement of
    # reads[b, clip(len - 1 - j, 0, L - 1)] (N stays N) on a reverse hit
    oriented = sw_extend.orient_reads(_t(reads), _t(lens),
                                      _t(is_rev)).numpy()
    for b in range(B):
        for j in range(min(int(lens[b]), L)):
            c = int(reads[b, j]) if not is_rev[b] else int(
                reads[b, min(max(int(lens[b]) - 1 - j, 0), L - 1)])
            want = c if not is_rev[b] else (3 - c if c < 4 else 4)
            assert oriented[b, j] == want


def test_extend_step_plain_matches_jax(setup):
    """``extend_step``'s twin against the reference align step's window
    fetch, orientation and ``extend_batch``, every output row."""
    fm, codes, _, jg = setup
    reads, lens, fwd, is_rev = _step_hits(fm, codes, np.random.default_rng(29))
    B, L = reads.shape
    W = 32
    jlens = jnp.asarray(lens)
    target = jas.fetch_window_batch(jg, jnp.asarray(fwd.astype(np.int32)),
                                    L + W)
    jr = jnp.asarray(reads)
    idx = jnp.arange(L, dtype=jnp.int32)[None, :]
    rev_idx = jnp.clip(jlens[:, None] - 1 - idx, 0, L - 1)
    rc = jnp.take_along_axis(jr, rev_idx, axis=1)
    revcomp = jnp.where(idx < jlens[:, None], jnp.where(rc < 4, 3 - rc, 4), 4)
    oriented = jnp.where(jnp.asarray(is_rev)[:, None], revcomp, jr)
    want = jsw.extend_batch(oriented, jlens, target,
                            jnp.full((B,), L + W, jnp.int32),
                            jnp.asarray(MAT), jnp.full((B,), W, jnp.int32),
                            jnp.full((B,), 19, jnp.int32))
    pac = resident.pac_words_from_fm(fm, "cpu")
    got = sw_extend.extend_step(_t(reads), _t(lens), _t(fwd), _t(is_rev),
                                pac, fm.l_pac, W, h0=19, match_sc=1,
                                mismatch_sc=-4, n_sc=-1)
    assert got.shape == (8, B) and got.dtype == torch.int32
    for r, f in enumerate(("score", "qle", "tle", "gtle", "gscore",
                           "max_off")):
        np.testing.assert_array_equal(got[r].numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert not got[6:].any()
    assert (got[0, 26:] > 19).sum() >= 10          # planted hits extend
    with pytest.raises(ValueError, match="steps"):
        sw_extend.extend_step(_t(reads), _t(lens), _t(fwd), _t(is_rev), pac,
                              fm.l_pac, W,
                              steps=torch.zeros(B, dtype=torch.int32))


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
    assert {"sa_lookup", "orient", "fetch_extend"} <= parts
    assert not parts & {"seed_mask", "fetch_window", "extend"}
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


def _k7_group():
    """kGroup as csrc/exact_match.cu builds it."""
    import re
    with open(_build.CSRC_DIR + "/exact_match.cu") as f:
        return int(re.search(r"constexpr int kGroup = (\d+);", f.read())[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["int32", "int64"])
def test_exact_match_kernel_counts_its_steps(setup, cuda_device,
                                             dt):  # noqa: F811
    """K7 on the unmasked reads (suffix form, both rules; whole read) equals
    its twin and the emulated group schedule, and its count of each read's
    rank steps equals the emulation's."""
    fm, codes, _, _ = setup
    reads, lens = _suffix_reads(codes, np.random.default_rng(17))
    start = np.maximum(lens - 32, 0).astype(np.int32)
    f = _fmd(fm, dt, cuda_device)
    fc = _fmd(fm, dt)
    for st, mi, skip_n in ((start, 32, True), (start, 32, False),
                           (None, None, False)):
        args = (_t(reads).to(cuda_device), _t(lens).to(cuda_device),
                None if st is None else _t(st).to(cuda_device), mi, skip_n)
        steps = torch.full((len(lens),), -1, dtype=torch.int32,
                           device=cuda_device)
        got = tfm.backward_search(f, *args, steps=steps)
        want = tfm.backward_search_plain(f, *args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        ek, el, ran = emulate_exact_match(
            fc, reads, lens, st, reads.shape[1] if mi is None else mi,
            skip_n, G=_k7_group())
        np.testing.assert_array_equal(got[0].cpu().numpy(), ek)
        np.testing.assert_array_equal(steps.cpu().numpy(), ran)


@pytest.mark.cuda
def test_extend_step_kernel_matches_twin(setup, cuda_device):  # noqa: F811
    """K1's step entry against ``extend_step_plain`` on the card, one launch
    through the step entry, and its warp-step count filled for every
    task."""
    fm, codes, _, _ = setup
    reads, lens, fwd, is_rev = _step_hits(fm, codes, np.random.default_rng(29))
    B = len(lens)
    pac = resident.pac_words_from_fm(fm, cuda_device)
    args = (_t(reads).to(cuda_device), _t(lens).to(cuda_device),
            _t(fwd).to(cuda_device), _t(is_rev).to(cuda_device), pac,
            fm.l_pac, 32)
    before = _build.entry_launches()["lariat_sw_extend_step"]
    steps = torch.full((B,), -1, dtype=torch.int32, device=cuda_device)
    got = sw_extend.extend_step(*args, steps=steps)
    assert _build.entry_launches()["lariat_sw_extend_step"] == before + 1
    want = sw_extend.extend_step_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int(steps.min()) >= 0
