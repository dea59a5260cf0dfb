"""K4a's planes entry and K9 (the compaction) against lariat_tpu's
``min_starts_twoptr(emit_direct=False)``, ``compact_starts``,
``compact_starts_packed`` and ``smems_from_starts`` (XLA and numpy on the
CPU): the planes twin on messy, segdup and low-complexity reads in int32
and int64 indices, both ``bwd_init`` modes, with a budget that leaves lanes
undone; the compaction twins on those planes at round-1 and round-2 mids,
``min_seed`` 0 and 19, and a cap that overflows, and on planes made from a
seed at widths 151 to 1,100 (x0, x1, s past 2^31 in int64); the port's
``smems_from_starts`` read by read, and the compaction's first ``count``
slots equal to it on lanes whose planes are done. Integer outputs:
tolerance 0. Also the JAX package's own cross-check: its compaction of the
planes equals its direct slots at round 1; and K9's schedule in numpy
(``emulate_compact``: its windows, ballots and slot search) against the
twin. The ``cuda`` cases hold both kernels against their twins on the
card."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lariat_tpu.ops import smem_device as jsd
from lariat_tpu_torch.ops import smem_device as tsd

from test_rfa import dup_genome  # noqa: F401
from test_smem_device import _messy_reads
from test_torch_smem_device import (L, _batch, _low_complexity, _segdup,
                                    idx)  # noqa: F401
from test_torch_sw_extend import cuda_device  # noqa: F401

torch.set_num_threads(1)


def _reads(genome):
    return (_messy_reads(genome, np.random.default_rng(15), n=40)
            + _low_complexity(genome)
            + _segdup(genome, np.random.default_rng(16)))


def _lanes(lens, bwd_init, seed=4):
    """(start_e, min_intv, mid) a lane: round 1 from 0 with min_intv 1 and
    mid L + 2; round 2 from a mid inside the read, min_intv 1-5."""
    R = len(lens)
    if not bwd_init:
        return (np.zeros(R, np.int32), np.ones(R, np.int64),
                np.full(R, L + 2, np.int32))
    rng = np.random.default_rng(seed)
    mid = rng.integers(0, np.maximum(lens, 1)).astype(np.int32)
    return mid, rng.integers(1, 6, R).astype(np.int64), mid.copy()


def _jax_planes(jdfm, rmat, start, lens, mi, max_steps, bwd_init):
    return jsd.min_starts_twoptr(
        jdfm, jnp.asarray(rmat), jnp.asarray(start), jnp.asarray(lens),
        jnp.asarray(mi), L, max_steps=max_steps, bwd_init=bwd_init)


def _port_planes(fmd, rmat, start, lens, mi, max_steps, bwd_init):
    return tsd.min_starts_twoptr_planes(
        fmd, torch.from_numpy(rmat), torch.from_numpy(start),
        torch.from_numpy(lens), torch.from_numpy(mi), L,
        max_steps=max_steps, bwd_init=bwd_init)


# (bwd_init, max_steps): each round at the reference's default budget
# (8L), round 2 at the collect's 32L, and budgets that leave lanes undone
PLANES_CASES = [(False, 0), (True, 32 * L), (False, 40), (True, 24)]


@pytest.mark.parametrize("dt", ["int32", "int64"])
@pytest.mark.parametrize("bwd_init,max_steps", PLANES_CASES)
def test_planes_twin_matches_jax(idx, dt, bwd_init, max_steps):  # noqa: F811
    fm, genome, jdfm, fmd, fmd64 = idx
    rmat, lens = _batch(_reads(genome))
    start, mi, _ = _lanes(lens, bwd_init)
    want = _jax_planes(jdfm, rmat, start, lens, mi, max_steps, bwd_init)
    got = _port_planes(fmd if dt == "int32" else fmd64, rmat, start, lens,
                       mi, max_steps, bwd_init)
    for name, w, g in zip(("b", "x0", "x1", "s", "valid", "done"), want,
                          got[:6]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert got[1].dtype == (torch.int32 if dt == "int32" else torch.int64)
    done = bool(np.asarray(want[5]))
    assert done == (max_steps in (0, 32 * L))   # the small budgets cut
    aux = got[6].numpy()
    assert bool(aux[:, 0].all()) == done
    assert aux[:, 1].max() <= tsd._budget(max_steps or 8 * L)


def _synthetic(width, bwd_init, dt, R=128, seed=9):
    """Planes of ``width`` columns made from a seed, in the layout of K4a's
    planes entry: b(e) a running maximum of e less a match length, with
    dips that break its monotonicity, columns past the lane's length and
    random ones invalid, x0, x1, s random (past 2^31 in int64); lanes as
    ``_lanes`` makes them (round 2: from a mid inside the read). Returns
    (b, x0, x1, s, valid, done) numpy arrays, start, lens, mid."""
    rng = np.random.default_rng(seed + width + 7 * bwd_init)
    e = np.arange(1, width + 1)
    b = np.maximum.accumulate(e[None, :] - rng.integers(0, 40, (R, width)),
                              axis=1)
    dip = rng.random((R, width)) < 0.05
    b = np.clip(np.where(dip, b - rng.integers(0, 3, (R, width)), b), 0,
                None).astype(np.int32)
    lens = rng.integers(0, width + 1, R).astype(np.int32)
    lens[:4] = 0, 1, width, width
    valid = (rng.random((R, width)) > 0.03) & (e[None, :] <= lens[:, None])
    top = (1 << 40) if dt == "int64" else (1 << 31) - 1
    x0, x1, s = (rng.integers(0, top, (R, width)).astype(
        np.int64 if dt == "int64" else np.int32) for _ in range(3))
    if bwd_init:
        mid = rng.integers(0, np.maximum(lens, 1)).astype(np.int32)
        start = mid.copy()
    else:
        start = np.zeros(R, np.int32)
        mid = np.full(R, width + 2, np.int32)
    return (b, x0, x1, s, valid, np.bool_(not bwd_init)), start, lens, mid


def _compact_inputs(idx, bwd_init, width=None, dt="int64"):
    """The compaction's inputs: the JAX planes of the module's batch at L
    (``width`` None), else ``_synthetic`` planes of that width."""
    if width is not None:
        return _synthetic(width, bwd_init, dt)
    fm, genome, jdfm, fmd, fmd64 = idx
    rmat, lens = _batch(_reads(genome))
    start, mi, mid = _lanes(lens, bwd_init)
    planes = _jax_planes(jdfm, rmat, start, lens, mi, 32 * L, bwd_init)
    return planes, start, lens, mid


# (bwd_init, min_seed, cap): round-1 mids (L + 2) and round-2 mids below
# L, min_seed 0 and 19, the collect's caps, and caps that overflow
COMPACT_CASES = [(False, 19, 32), (False, 0, 32), (True, 19, 16),
                 (True, 0, 16), (False, 0, 2), (True, 0, 1)]
# plane widths: the module's batch (None, L 192), an unaligned 151, 250
# (one window of K9), 300 (two windows) and 1,100 (ballots past K9's
# shared memory)
WIDTHS = [None, 151, 250, 300, 1100]


@pytest.mark.parametrize("dt", ["int32", "int64"])
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("bwd_init,min_seed,cap", COMPACT_CASES)
def test_compact_twins_match_jax(idx, dt, width, bwd_init, min_seed,  # noqa: F811
                                 cap):
    planes, start, lens, mid = _compact_inputs(idx, bwd_init, width, dt)
    b, x0, x1, s, valid, done = planes
    want = jsd.compact_starts(b, x0, x1, s, valid, jnp.asarray(start),
                              jnp.asarray(lens), jnp.asarray(mid),
                              min_seed, cap)
    wpk = jsd.compact_starts_packed(b, x0, x1, s, valid, jnp.asarray(start),
                                    jnp.asarray(lens), jnp.asarray(mid),
                                    done, min_seed, cap)
    tdt = torch.int32 if dt == "int32" else torch.int64
    tb, tx0, tx1, ts, tv = (torch.from_numpy(np.array(a)) for a in planes[:5])
    tx0, tx1, ts = (v.to(tdt) for v in (tx0, tx1, ts))
    args = (tb, tx0, tx1, ts, tv, torch.from_numpy(start),
            torch.from_numpy(lens), torch.from_numpy(mid))
    got = tsd.compact_starts(*args, min_seed, cap)
    for name, w, g in zip(("qb", "qe", "x0", "x1", "s", "counts",
                           "overflow"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert got[2].dtype == tdt
    gpk = tsd.compact_starts_packed(*args, torch.tensor(bool(done)),
                                    min_seed, cap)
    np.testing.assert_array_equal(gpk.numpy(), np.asarray(wpk))
    if cap < 16:
        assert bool(np.asarray(want[6]))    # the small caps overflow


def test_jax_compaction_equals_direct_slots_at_round_1(idx):  # noqa: F811
    """The reference's two paths agree at round 1 (mid L + 2, where the
    direct path's midpoint pruning never fires): compact_starts of its
    planes holds the direct slots of min_starts_twoptr(emit_direct=True),
    lane for lane."""
    fm, genome, jdfm, _, _ = idx
    rmat, lens = _batch(_reads(genome))
    start, mi, mid = _lanes(lens, False)
    cap = 32
    planes = _jax_planes(jdfm, rmat, start, lens, mi, 8 * L, False)
    qb, qe, x0, x1, s, counts, ovf = (np.asarray(a) for a in
                                      jsd.compact_starts(
        *planes[:5], jnp.asarray(start), jnp.asarray(lens),
        jnp.asarray(mid), 19, cap))
    meta, big = (np.asarray(a) for a in jsd.min_starts_twoptr(
        jdfm, jnp.asarray(rmat), jnp.asarray(start), jnp.asarray(lens),
        jnp.asarray(mi), L, max_steps=8 * L, emit_direct=True, min_seed=19,
        cap=cap, mid=jnp.asarray(mid)))
    assert bool(np.asarray(planes[5])) and not bool(ovf)
    assert int(meta[0, -1]) & 3 == 1
    np.testing.assert_array_equal(meta[:, cap], counts)
    k = np.arange(cap)[None, :] < counts[:, None]
    np.testing.assert_array_equal(np.where(k, meta[:, :cap] >> 16, 0),
                                  np.where(k, qb, 0))
    np.testing.assert_array_equal(np.where(k, meta[:, :cap] & 0xFFFF, 0),
                                  np.where(k, qe, 0))
    for j, v in enumerate((x0, x1, s)):
        np.testing.assert_array_equal(
            np.where(k, big[:, j * cap:(j + 1) * cap], 0), np.where(k, v, 0))
    assert counts.sum() > 50


def _cuda_fmd(fm, dev, dt):
    from lariat_tpu_torch.ops import fm_batch as tfm
    f = tfm.DeviceFMIndex.from_host(fm, dev)
    if dt == "int64":
        f = tfm.DeviceFMIndex(f.fused, f.L2.long(), f.primary, f.seq_len)
    return f


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["int32", "int64"])
@pytest.mark.parametrize("bwd_init,max_steps", PLANES_CASES)
def test_planes_kernel_matches_twin(idx, cuda_device, dt, bwd_init,  # noqa: F811
                                    max_steps):
    fm, genome = idx[:2]
    rmat, lens = _batch(_reads(genome))
    start, mi, _ = _lanes(lens, bwd_init)
    f = _cuda_fmd(fm, cuda_device, dt)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (rmat, start, lens, mi)]
    got = tsd.min_starts_twoptr_planes(f, *args, L, max_steps=max_steps,
                                       bwd_init=bwd_init)
    want = tsd.min_starts_twoptr_plain(
        f, *args[:4], None, L, tsd._budget(max_steps or 8 * L), bwd_init, 0,
        0, planes=True)
    torch.cuda.synchronize()
    for g, w in zip(got[:5] + got[6:], want):
        assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["int32", "int64"])
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("bwd_init,min_seed,cap", COMPACT_CASES)
def test_compact_kernel_matches_twin(idx, cuda_device, dt, width,  # noqa: F811
                                     bwd_init, min_seed, cap):
    """K9 in both layouts against its twins: all lanes, all but 3 (not a
    multiple of the lanes a block) and none; each at ``cap`` and then at a
    cap no lane passes, whose overflow flag and flags column must read 0
    after a call that overflowed; ``done`` True and False."""
    planes, start, lens, mid = _compact_inputs(idx, bwd_init, width, dt)
    tdt = torch.int32 if dt == "int32" else torch.int64
    tb, tx0, tx1, ts, tv = (torch.from_numpy(np.array(a)).to(cuda_device)
                            for a in planes[:5])
    full = (tb, tx0.to(tdt), tx1.to(tdt), ts.to(tdt), tv,
            *(torch.from_numpy(a).to(cuda_device) for a in (start, lens,
                                                            mid)))
    R, W = tb.shape
    for rows in (R, R - 3, 0):
        args = [a[:rows] for a in full]
        for cp in (cap, W):
            got = tsd.compact_starts(*args, min_seed, cp)
            want = tsd.compact_starts_plain(*args, min_seed, cp)
            for done in (True, False):
                d = torch.tensor(done, device=cuda_device)
                gpk = tsd.compact_starts_packed(*args, d, min_seed, cp)
                wpk = tsd.compact_starts_packed_plain(*args, d, min_seed,
                                                      cp)
                torch.cuda.synchronize()
                assert torch.equal(gpk.cpu(), wpk.cpu())
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w.cpu())
            assert got[2].dtype == tdt
        assert not bool(got[6])
        if rows:
            assert int(gpk[0, -1]) == 0      # done False, no overflow


def _k9_constants():
    """kWarps, kWin and kMaxChunks of ``csrc/compact.cu``."""
    path = os.path.join(os.path.dirname(tsd.__file__), "..", "csrc",
                        "compact.cu")
    with open(path) as f:
        src = f.read()
    return tuple(int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
                 for n in ("kWarps", "kWin", "kMaxChunks"))


def _select_bit(w, r):
    """compact.cu's select_bit: the position of the set bit of rank r."""
    pos = 0
    for sh in (16, 8, 4, 2, 1):
        lo = w & ((1 << sh) - 1)
        c = bin(lo).count("1")
        if r >= c:
            r, w, pos = r - c, w >> sh, pos + sh
        else:
            w = lo
    return pos


def emulate_compact(b, valid, start, end, mid, min_seed, C, kwin):
    """K9's schedule (``csrc/compact.cu``) in numpy, lane by lane: each
    window of ``kwin`` columns and the column past it staged at the 16-byte
    offset of its place in the planes, a thread a column over 32-column
    chunks, b and valid of the next column from the next thread (the last
    thread reads the staged window), a ballot a chunk and the count; then a
    thread a slot finding its column from the ballots (popcounts, then
    select_bit), qb from the staged window when the lane fits one. Returns
    the kept columns and their qb (R, C), and the counts."""
    R, Lw = b.shape
    big = 1 << 30
    fb, fv = b.reshape(-1).astype(np.int64), valid.reshape(-1)
    nch = -(-Lw // 32)
    cols = np.zeros((R, C), np.int64)
    qbs = np.zeros((R, C), np.int64)
    counts = np.zeros(R, np.int64)
    t = np.arange(32)
    for lane in range(R):
        bal, total = [0] * nch, 0
        for c0 in range(0, Lw, kwin):
            wend, n = min(kwin, Lw - c0), min(kwin + 1, Lw - c0)
            g = lane * Lw + c0
            boff, voff = g % 4, g % 16
            sb = np.full(kwin + 8, -7, np.int64)
            sv = np.zeros(kwin + 32, bool)
            sb[boff:boff + n] = fb[g:g + n]
            sv[voff:voff + n] = fv[g:g + n]
            for j0 in range(0, wend, 32):
                jw = j0 + t
                inn = jw < wend
                bj = np.where(inn, sb[boff + np.minimum(jw, kwin)], big)
                vj = inn & sv[voff + np.minimum(jw, kwin)]
                bn, vn = np.append(bj[1:], bj[31]), np.append(vj[1:], vj[31])
                has = jw[31] + 1 < n
                bn[31] = sb[boff + jw[31] + 1] if has else big
                vn[31] = has and sv[voff + jw[31] + 1]
                e = c0 + jw + 1
                em = (vj & (e > start[lane]) & (e <= end[lane])
                      & (bj <= mid[lane]) & (e - bj >= min_seed)
                      & (~vn | (bn > bj)))
                bal[(c0 + j0) >> 5] = int(sum(1 << int(k)
                                              for k in np.nonzero(em)[0]))
                total += int(em.sum())
        counts[lane] = total
        last = (1 << (Lw & 31)) - 1 if Lw & 31 else (1 << 32) - 1
        for k in range(C):
            emitted = k < total
            r = k if emitted else k - total
            for c in range(nch):
                m = bal[c] if emitted else ~bal[c] & (
                    last if c == nch - 1 else (1 << 32) - 1)
                cnt = bin(m).count("1")
                if r < cnt:
                    j = c * 32 + _select_bit(m, r)
                    break
                r -= cnt
            cols[lane, k] = j
            qbs[lane, k] = sb[boff + j] if Lw <= kwin else fb[lane * Lw + j]
    return cols, qbs, counts


@pytest.mark.parametrize("width", [151, 192, 250, 300, 1100])
@pytest.mark.parametrize("bwd_init,cap", [(False, 32), (True, 2),
                                          (False, 5000)])
def test_compact_schedule_emulation(width, bwd_init, cap):
    """``emulate_compact`` at compact.cu's constants on 45 lanes (not a
    multiple of its lanes a block; each at another 16-byte offset) equals
    the twin: slots, counts and overflow; and the wrapper's ballot
    threshold is the kernel's."""
    kwarps, kwin, kmax = _k9_constants()
    assert kmax == tsd.COMPACT_SHARED_CHUNKS and 45 % kwarps
    (b, x0, x1, s, valid, _), start, lens, mid = _synthetic(
        width, bwd_init, "int64", R=45)
    C = min(cap, width)
    cols, qbs, counts = emulate_compact(b, valid, start, lens, mid, 19, C,
                                        kwin)
    t = [torch.from_numpy(a) for a in (b, x0, x1, s, valid, start, lens,
                                       mid)]
    want = tsd.compact_starts_plain(*t, 19, cap)
    rows = np.arange(45)[:, None]
    for got, w in zip((qbs, cols + 1, x0[rows, cols], x1[rows, cols],
                       s[rows, cols], counts), want):
        np.testing.assert_array_equal(got, w.numpy())
    assert bool(want[6]) == bool((counts > cap).any())


@pytest.mark.parametrize("bwd_init", [False, True])
@pytest.mark.parametrize("min_seed", [0, 19])
def test_smems_from_starts_matches_jax(idx, bwd_init, min_seed):  # noqa: F811
    """The port's ``smems_from_starts`` equals the JAX package's, read by
    read, on the JAX planes of both rounds (round 2's lanes start at their
    mid, so their planes hold only columns past it)."""
    fm, genome, jdfm = idx[:3]
    rmat, lens = _batch(_reads(genome))
    start, mi, _ = _lanes(lens, bwd_init)
    planes = [np.asarray(a) for a in _jax_planes(
        jdfm, rmat, start, lens, mi, 32 * L, bwd_init)[:5]]
    n = 0
    for r in range(rmat.shape[0]):
        lane = [p[r] for p in planes]
        want = jsd.smems_from_starts(*lane, int(lens[r]), min_seed)
        got = tsd.smems_from_starts(*lane, int(lens[r]), min_seed)
        assert got == want, r
        n += len(got)
    assert n > 20


@pytest.mark.parametrize("min_seed", [0, 19])
def test_compact_first_slots_equal_smems_from_starts(idx, min_seed):  # noqa: F811
    """On lanes whose planes are done (the port's planes twin, round 1),
    with start_e 0, end_e the read's length and mid L + 2, the first
    ``count`` slots of ``compact_starts_plain`` are the port's
    ``smems_from_starts`` of the read, in order."""
    fm, genome, jdfm, fmd, fmd64 = idx
    rmat, lens = _batch(_reads(genome))
    start, mi, mid = _lanes(lens, False)
    b, x0, x1, s, valid, _, aux = _port_planes(fmd, rmat, start, lens, mi,
                                               8 * L, False)
    qb, qe, cx0, cx1, cs, counts, _ = tsd.compact_starts_plain(
        b, x0, x1, s, valid, torch.from_numpy(start), torch.from_numpy(lens),
        torch.from_numpy(mid), min_seed, L)
    done = aux[:, 0].numpy() == 1
    assert done.sum() > 100
    planes = [a.numpy() for a in (b, x0, x1, s, valid)]
    for r in np.nonzero(done)[0]:
        want = tsd.smems_from_starts(*(p[r] for p in planes), int(lens[r]),
                                     min_seed)
        k = int(counts[r])
        got = list(zip(*(v[r, :k].tolist() for v in (cx0, cx1, cs, qb, qe))))
        assert got == want, r
