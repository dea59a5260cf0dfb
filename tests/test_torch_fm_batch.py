"""The port's device FM index and its rank twins against lariat_tpu's
(ops/fm_batch.py, XLA on the CPU): the fused table, the index built from
the JAX index's arrays, and occ4 / bidirectional extension / LF on 4,096
rows with the edges (k = -1, k = seq_len, rows around primary, intervals
that cross it), with int32 and int64 indices. Integer outputs: tolerance
0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lariat_tpu.ops import fm_batch as jfm
from lariat_tpu_torch.ops import fm_batch as tfm

from test_rfa import dup_genome  # noqa: F401

torch.set_num_threads(1)


def _indices(jdfm, dtype):
    fused, L2 = np.asarray(jdfm.fused), np.asarray(jdfm.L2)
    return tfm.DeviceFMIndex.from_numpy(fused, L2.astype(dtype),
                                        int(jdfm.primary), int(jdfm.seq_len),
                                        "cpu")


@pytest.fixture
def indices(dup_genome):  # noqa: F811
    fm, _ = dup_genome
    jdfm = jfm.DeviceFMIndex.from_host(fm)
    return fm, jdfm, {dt.__name__: _indices(jdfm, dt)
                      for dt in (np.int32, np.int64)}


def test_fused_table_and_from_host(indices):
    fm, jdfm, idx = indices
    ref = np.asarray(jfm._fused_table(fm))
    assert ref.dtype == np.uint32
    np.testing.assert_array_equal(tfm.fused_table(fm), ref)
    host = tfm.DeviceFMIndex.from_host(fm, "cpu")
    via = idx["int32"]
    assert host.idx_dtype == via.idx_dtype == torch.int32
    assert (host.primary, host.seq_len) == (via.primary, via.seq_len) == (
        fm.primary, fm.seq_len)
    assert torch.equal(host.fused, via.fused)
    assert torch.equal(host.L2, via.L2)
    np.testing.assert_array_equal(host.fused.numpy().view(np.uint32), ref)
    assert idx["int64"].idx_dtype == torch.int64


def _rows(fm, rng, n=4096):
    """Row indices in [-1, seq_len] with the edges planted."""
    k = rng.integers(-1, fm.seq_len + 1, n).astype(np.int64)
    edges = [-1, 0, 1, fm.seq_len - 1, fm.seq_len,
             *range(fm.primary - 3, fm.primary + 4), 127, 128, 129]
    k[:len(edges)] = edges
    return k


def _intervals(fm, rng, n=4096):
    """(x0, x1, s, c): query-side rows qpos in [1, seq_len] with sizes that
    keep qpos - 1 + s <= seq_len; some cross primary."""
    x0 = rng.integers(1, fm.seq_len + 1, n).astype(np.int64)
    x1 = rng.integers(1, fm.seq_len + 1, n).astype(np.int64)
    s = (rng.random(n) ** 4 * (fm.seq_len + 1 - np.maximum(x0, x1))
         ).astype(np.int64)
    m = 64
    x0[:m] = x1[:m] = fm.primary - rng.integers(0, 40, m)
    s[:m] = rng.integers(0, 80, m)
    s[m:m + 8] = 0
    c = rng.integers(0, 4, n).astype(np.int32)
    return x0, x1, s, c


def _j(a, jdfm):
    return jnp.asarray(a.astype(np.asarray(jdfm.L2).dtype))


@pytest.mark.parametrize("dt", ["int32", "int64"])
def test_occ4_and_lf_match_jax(indices, dt):
    fm, jdfm, idx = indices
    fmd = idx[dt]
    rng = np.random.default_rng(11)
    k = _rows(fm, rng)
    want = np.asarray(jfm.occ4_fused_batch(jdfm, _j(k, jdfm)))
    got = tfm.occ4_fused_batch(fmd, torch.from_numpy(k))
    assert got.dtype == fmd.idx_dtype
    np.testing.assert_array_equal(got.numpy(), want)
    # LF on every row but primary (callers mask it), against the host index
    kl = k[(k >= 0) & (k < fm.seq_len) & (k != fm.primary)]
    want = np.asarray(jfm.lf_batch(jdfm, _j(kl, jdfm)))
    got = tfm.lf_batch(fmd, torch.from_numpy(kl)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:50], [fm.lf(int(v)) for v in kl[:50]])


@pytest.mark.parametrize("dt", ["int32", "int64"])
def test_bwt_extend_matches_jax(indices, dt):
    fm, jdfm, idx = indices
    fmd = idx[dt]
    rng = np.random.default_rng(12)
    x0, x1, s, c = _intervals(fm, rng)
    for is_back in (True, False):
        want = jfm.bwt_extend_batch(jdfm, _j(x0, jdfm), _j(x1, jdfm),
                                    _j(s, jdfm), is_back)
        got = tfm.bwt_extend_batch(fmd, torch.from_numpy(x0),
                                   torch.from_numpy(x1), torch.from_numpy(s),
                                   is_back)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    back = rng.random(len(c)) < 0.5
    want = jfm.bwt_extend_dir_batch(jdfm, _j(x0, jdfm), _j(x1, jdfm),
                                    _j(s, jdfm), jnp.asarray(c),
                                    jnp.asarray(back))
    got = tfm.bwt_extend_dir_batch(fmd, torch.from_numpy(x0),
                                   torch.from_numpy(x1), torch.from_numpy(s),
                                   torch.from_numpy(c),
                                   torch.from_numpy(back))
    for g, w in zip(got, want):
        assert g.dtype == fmd.idx_dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---- K4a's group rank (csrc/fm.cuh occ4_pair_group), emulated ----------------

def _popcount(x):
    """Bits set in each value below 2**32 (SWAR, as fm_batch does)."""
    x = x.astype(np.uint64)
    x = x - ((x >> np.uint64(1)) & np.uint64(0x55555555))
    x = (x & np.uint64(0x33333333)) + ((x >> np.uint64(2))
                                       & np.uint64(0x33333333))
    x = (x + (x >> np.uint64(4))) & np.uint64(0x0F0F0F0F)
    return ((x * np.uint64(0x01010101)) >> np.uint64(24)) & np.uint64(0xFF)


def _field_match(w, c):
    y = w ^ np.uint64(c * 0x55555555)
    return ~(y | (y >> np.uint64(1))) & np.uint64(0x55555555)


def _keep_mask(n):
    n = n.astype(np.int64)
    return np.where(n <= 0, 0, (0xFFFFFFFF << (32 - 2 * n)) & 0xFFFFFFFF
                    ).astype(np.uint64)


def emulate_group_rank(fused, L2, primary, seq_len, ka, kb, G, need=None,
                       per_thread=False):
    """occ4 at ka and kb (arrays) as a group of G threads computes them:
    both checkpoint rows loaded by every thread (the second skipped when
    both ranks share a block), bwt words split 16/G a thread (the first G/2
    threads rank ka), a byte a code, summed by xor-shuffles within each half
    and swapped across the halves -> (ta, tb, rows fetched); every thread of
    the group must end with the same counts. ``need`` False turns a lane's
    loads off (its counts are then unused); ``per_thread`` returns each
    thread's (ta, tb) in place of the first thread's."""
    H, WPT = G // 2, 8 // (G // 2)
    rows = fused.view(np.uint32).astype(np.uint64)

    def at(k):
        kk = np.clip(np.where(k >= primary, k - 1, k), 0, seq_len - 1)
        return (k >= 0) & (k != seq_len), (kk + 1) >> 7, (kk + 1) & 127

    la, ba, ra = at(ka)
    lb, bb, rb = at(kb)
    if need is not None:
        la, lb = la & need, lb & need
    same = la & lb & (ba == bb)
    zero = np.zeros((len(ka), 4), np.uint64)
    ca = np.where(la[:, None], rows[ba, :4], zero)
    cb = np.where((lb & ~same)[:, None], rows[bb, :4], zero)
    cb = np.where(same[:, None], ca, cb)
    packed = []
    for g in range(G):
        on_b, part = g >= H, g & (H - 1)
        load, blk, rem = (lb, bb, rb) if on_b else (la, ba, ra)
        p = np.zeros(len(ka), np.uint64)
        for i in range(WPT):
            wi = part * WPT + i
            w = np.where(load, rows[blk, 4 + wi], 0).astype(np.uint64)
            keep = _keep_mask(np.clip(rem - 16 * wi, 0, 16))
            for c in range(4):
                p += _popcount(_field_match(w, c) & keep) << np.uint64(8 * c)
        packed.append(p & np.uint64(0xFFFFFFFF))
    o = 1
    while o < H:                       # __shfl_xor_sync(gmask, packed, o)
        packed = [(packed[g] + packed[g ^ o]) & np.uint64(0xFFFFFFFF)
                  for g in range(G)]
        o <<= 1
    other = [packed[g ^ H] for g in range(G)]
    L2 = np.asarray(L2, np.int64)
    tot = L2[1:] - L2[:4]
    outs = []
    for g in range(G):
        pa, pb = (other[g], packed[g]) if g >= H else (packed[g], other[g])
        res = []
        for k, ck, pk in ((ka, ca, pa), (kb, cb, pb)):
            cnt = np.stack([(pk >> np.uint64(8 * c)) & np.uint64(0xFF)
                            for c in range(4)], axis=1)
            v = (ck + cnt).astype(np.int64)
            v = np.where((k == seq_len)[:, None], tot[None, :], v)
            res.append(np.where((k < 0)[:, None], 0, v))
        outs.append(res)
    for g in range(1, G):
        np.testing.assert_array_equal(outs[g][0], outs[0][0])
        np.testing.assert_array_equal(outs[g][1], outs[0][1])
    fetched = la.astype(np.int64) + (lb & ~same)
    if per_thread:
        return outs, fetched
    return outs[0][0], outs[0][1], fetched


@pytest.mark.parametrize("dt", ["int32", "int64"])
@pytest.mark.parametrize("G", [4, 8, 16])
def test_group_rank_matches_occ4(indices, dt, G):
    """The group rank against the port's and the JAX package's
    occ4_fused_batch at k < 0, k == seq_len, around primary, k & 127 in {0,
    127}, both ranks in one block (the one-row reuse) and in two; the rows
    fetched against rank_rows."""
    fm, jdfm, idx = indices
    fmd = idx[dt]
    rng = np.random.default_rng(13 + G)
    ka = _rows(fm, rng, n=600)
    blk = rng.integers(0, fm.seq_len // 128, 40)
    ka[-80:-40] = blk * 128                   # k & 127 == 0
    ka[-40:] = blk * 128 + 127                # k & 127 == 127
    s = np.where(rng.random(len(ka)) < 0.5, rng.integers(0, 4, len(ka)),
                 rng.integers(0, 400, len(ka)))
    s[:8] = 0
    kb = np.minimum(ka + s, fm.seq_len)
    kb[8:12] = -1
    fused = np.asarray(jdfm.fused)
    ta, tb, rows = emulate_group_rank(fused, np.asarray(jdfm.L2),
                                      fm.primary, fm.seq_len, ka, kb, G)
    for k, got in ((ka, ta), (kb, tb)):
        want = tfm.occ4_fused_batch(fmd, torch.from_numpy(k)).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, np.asarray(jfm.occ4_fused_batch(jdfm, _j(k, jdfm))))
    ok = kb >= ka          # rank_rows takes qpos = ka + 1 and s = kb - ka
    want_rows = tfm.rank_rows(fmd, torch.from_numpy(ka[ok] + 1),
                              torch.from_numpy(kb[ok] - ka[ok])).numpy()
    np.testing.assert_array_equal(rows[ok], want_rows)
    assert (rows == 1).any() and (rows == 2).any()
    # the rows one extension marks are the rows it counts; none where not
    # needed
    for i in np.nonzero(ok)[0][:60]:
        touched = torch.zeros(fmd.fused.shape[0], dtype=torch.bool)
        need = torch.tensor([i % 7 != 0])
        n = tfm.rank_rows(fmd, torch.tensor([ka[i] + 1]),
                          torch.tensor([kb[i] - ka[i]]), need, touched)
        assert int(touched.sum()) == int(n[0]) == (rows[i] if need else 0)


# ---- K5's LF step (csrc/fm.cuh lf), emulated --------------------------------

def emulate_lf(fused, L2, primary, k):
    """LF of rows k as K5's thread computes it: the checkpoint piece and
    the first piece of bwt words always, the second piece only when the base
    lies in it (pos >= 64; zeros otherwise), the word and the checkpoint
    picked by two-level selects -> (lf, pieces loaded a row)."""
    rows = fused.view(np.uint32).astype(np.uint64)
    kx = np.where(k > primary, k - 1, k)
    blk, pos = kx >> 7, kx & 127
    high = pos >= 64
    ck, lo = rows[blk, 0:4], rows[blk, 4:8]
    hi = np.where(high[:, None], rows[blk, 8:12], np.uint64(0))
    v = np.where(high[:, None], hi, lo)

    def pick(a, i):
        return np.where(i & 2, np.where(i & 1, a[:, 3], a[:, 2]),
                        np.where(i & 1, a[:, 1], a[:, 0]))

    word = pick(v, (pos >> 4) & 3)
    c = ((word >> ((15 - (pos & 15)) * 2).astype(np.uint64))
         & np.uint64(3)).astype(np.int64)
    base = pick(ck, c)
    w = np.concatenate([lo, hi], axis=1)
    cnt = np.zeros(len(k), np.uint64)
    for i in range(8):
        keep = _keep_mask(np.clip(pos + 1 - 16 * i, 0, 16))
        cnt += _popcount(_field_match(w[:, i], c.astype(np.uint64)) & keep)
    L2 = np.asarray(L2, np.int64)
    return (L2[c] + base.astype(np.int64) + cnt.astype(np.int64),
            2 + high.astype(np.int64))


@pytest.mark.parametrize("dt", ["int32", "int64"])
def test_lf_pieces_matches_lf_batch(indices, dt):
    """K5's LF, which skips the row's second piece of bwt words below pos
    64, against the port's and the JAX package's lf_batch at k == primary,
    primary +- 1, k & 127 in {0, 127}, k & 15 in {0, 15} and random rows."""
    fm, jdfm, idx = indices
    fmd = idx[dt]
    rng = np.random.default_rng(21)
    k = rng.integers(0, fm.seq_len, 2000).astype(np.int64)
    blk = rng.integers(0, fm.seq_len // 128, 60) * 128
    edges = [fm.primary, fm.primary - 1, fm.primary + 1, 0, 15, 16, 127,
             128, fm.seq_len - 1]
    k = np.concatenate([edges, blk, blk + 127, blk + 15, blk + 64,
                        blk + 63, blk + 79, k])
    k = k[(k >= 0) & (k < fm.seq_len)]
    got, pieces = emulate_lf(np.asarray(jdfm.fused), np.asarray(jdfm.L2),
                             fm.primary, k)
    np.testing.assert_array_equal(
        got, tfm.lf_batch(fmd, torch.from_numpy(k)).numpy())
    np.testing.assert_array_equal(
        got, np.asarray(jfm.lf_batch(jdfm, _j(k, jdfm))))
    kx = np.where(k > fm.primary, k - 1, k)
    for m in (0, 15):
        assert ((kx & 15) == m).any()
    for m in (0, 127):
        assert ((kx & 127) == m).any()
    assert set(np.unique(pieces)) == {2, 3}


# ---- K4b's pair rank (csrc/fm.cuh occ4_pair), emulated -----------------------

def emulate_pair_rank(fused, L2, primary, seq_len, ka, kb):
    """occ4 at ka and kb as one K4b thread computes them (fm.cuh
    `occ4_pair` :305, `load_pieces` :247, `bit_planes` :261, `top_bits`
    :271, `occ4_from` :280): a row's checkpoint piece
    once when both ranks fall in its block; of its bwt pieces the first
    when the larger rank there counts any base, the second only past base
    64 (zeros otherwise); counted by bit planes (``bit_planes``: the
    fields' low bits and high bits, two words a plane word), a plane
    word's mask from ``top_bits``, one popcount each for the low bits, the
    high bits and both, code 0 the rest of the rem bases -> (ta, tb, rows
    fetched, 16-byte pieces loaded)."""
    rows = fused.view(np.uint32).astype(np.uint64)

    def at(k):
        kk = np.clip(np.where(k >= primary, k - 1, k), 0, seq_len - 1)
        return (k >= 0) & (k != seq_len), (kk + 1) >> 7, (kk + 1) & 127

    la, ba, ra = at(ka)
    lb, bb, rb = at(kb)
    same = la & lb & (ba == bb)

    def load(on, blk, rem):
        ck = np.where(on[:, None], rows[blk, 0:4], np.uint64(0))
        lo = np.where((on & (rem > 0))[:, None], rows[blk, 4:8],
                      np.uint64(0))
        hi = np.where((on & (rem > 64))[:, None], rows[blk, 8:12],
                      np.uint64(0))
        pieces = on.astype(np.int64) * (1 + (rem > 0) + (rem > 64))
        return ck, np.concatenate([lo, hi], axis=1), pieces

    ca, wa, pa = load(la, ba, np.where(same, np.maximum(ra, rb), ra))
    cb, wb, pb = load(lb & ~same, bb, rb)
    cb = np.where(same[:, None], ca, cb)
    wb = np.where(same[:, None], wa, wb)
    L2 = np.asarray(L2, np.int64)
    tot = L2[1:] - L2[:4]

    def top_bits(bits):
        b = np.clip(bits, 0, 32).astype(np.uint64)
        return np.where(b == 0, 0, (np.uint64(0xFFFFFFFF) << (np.uint64(32)
                                                             - b))
                        & np.uint64(0xFFFFFFFF)).astype(np.uint64)

    def count(k, ck, w, rem):
        # bit planes, two words a plane word (bit_planes), one popcount
        # each for the low bits, the high bits and both (occ4_from)
        m5, ma = np.uint64(0x55555555), np.uint64(0xAAAAAAAA)
        one = np.uint64(1)
        lo = hi = both = np.zeros(len(k), np.int64)
        for j in range(4):
            we, wo = w[:, 2 * j], w[:, 2 * j + 1]
            pl = (we & m5) | ((wo << one) & ma)
            ph = ((we >> one) & m5) | (wo & ma)
            m = ((top_bits(2 * rem - 64 * j) & m5)
                 | (top_bits(2 * rem - 64 * j - 32) & ma))
            lo = lo + _popcount(pl & m).astype(np.int64)
            hi = hi + _popcount(ph & m).astype(np.int64)
            both = both + _popcount(pl & ph & m).astype(np.int64)
        cnt = np.stack([rem - lo - hi + both, lo - both, hi - both, both],
                       axis=1)
        v = ck.astype(np.int64) + cnt
        v = np.where((k == seq_len)[:, None], tot[None, :], v)
        return np.where((k < 0)[:, None], 0, v)

    return (count(ka, ca, wa, ra), count(kb, cb, wb, rb),
            la.astype(np.int64) + (lb & ~same), pa + pb)


@pytest.mark.parametrize("dt", ["int32", "int64"])
def test_pair_rank_matches_occ4(indices, dt):
    """K4b's pair rank against the port's and the JAX package's
    occ4_fused_batch at k = -1, k = seq_len, around primary, rem (the
    bases counted in the block) 0, 63, 64 and 127 for either rank, both
    ranks in one block (one row, the pieces of the larger rank) and in two;
    the rows fetched against rank_rows."""
    fm, jdfm, idx = indices
    fmd = idx[dt]
    rng = np.random.default_rng(31)
    ka = _rows(fm, rng, n=800)
    blk = rng.integers(0, fm.seq_len // 128 - 1, 40) * 128
    # kp = kk + 1 = k + 1 below primary: rem r at k = blk + r - 1
    for j, r in enumerate((0, 63, 64, 127)):
        ka[640 + 40 * j:680 + 40 * j] = blk + r - 1
    s = np.where(rng.random(len(ka)) < 0.6, rng.integers(0, 3, len(ka)),
                 rng.integers(0, 300, len(ka)))
    s[:8] = 0
    kb = np.minimum(ka + s, fm.seq_len)
    kb[8:12] = -1
    kb[12:16] = fm.seq_len
    kb[-20:] = ka[-20:] - ka[-20:] % 128 + 127     # rem 0 -> rem 127, one row
    for k in (ka, kb):
        rem = (np.clip(np.where(k >= fm.primary, k - 1, k), 0,
                       fm.seq_len - 1) + 1) & 127
        assert {0, 63, 64, 127} <= set(rem[(k >= 0) & (k < fm.seq_len)])
    fused = np.asarray(jdfm.fused)
    ta, tb, rows, pieces = emulate_pair_rank(
        fused, np.asarray(jdfm.L2), fm.primary, fm.seq_len, ka, kb)
    for k, got in ((ka, ta), (kb, tb)):
        want = tfm.occ4_fused_batch(fmd, torch.from_numpy(k)).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, np.asarray(jfm.occ4_fused_batch(jdfm, _j(k, jdfm))))
    ok = kb >= ka          # rank_rows takes qpos = ka + 1 and s = kb - ka
    want_rows = tfm.rank_rows(fmd, torch.from_numpy(ka[ok] + 1),
                              torch.from_numpy(kb[ok] - ka[ok])).numpy()
    np.testing.assert_array_equal(rows[ok], want_rows)
    assert (rows == 1).any() and (rows == 2).any()
    # one row holds 1-3 pieces; two rows 2-6
    assert ((pieces >= rows) & (pieces <= 3 * rows)).all()
    assert set(np.unique(pieces[rows == 1])) == {1, 2, 3}
