"""Device 3-round SMEM seeding -- the port of lariat_tpu/ops/smem_device.py:
the wrappers of kernels K4a-K4c (``csrc/smem.cu``), their plain PyTorch
twins, and the host drivers around them.

Reference semantics: native/seed.cpp collect_intv (bwa mem_collect_intv).
Round 1 finds all SMEMs of length >= min_seed_len; round 2 re-seeds long,
low-occurrence SMEMs from their midpoint with min_intv = s + 1; round 3
takes bwt_seed_strategy1's forward-greedy seeds; then one stable (qb, qe)
sort per read. The drivers are the reference's numpy, line for line, so
the (n, 5) int64 rows ``[x0, x1, s, qb, qe]`` come out in the same order.

``LARIAT_SEED_TRACE=1`` (read once, at import) prints the reference's
``[seedtrace]`` lines: each phase of a collect in host wall ms (round 1
and 3's launches, round 1's download with the straggler rerun, its
assembly, round 2, round 3's assembly, the merge; then the rbeg schedule
and the SA walk), the straggler count of each two-pointer round, and round
2's lanes and flags. A launch returns before the card is done, as a JAX
dispatch does, so the kernels' time falls in the phase that first waits
on them (round 1's download); the trace adds no synchronisation.

  K4a ``min_starts_twoptr``  two-pointer minimal-start machine, one lane per
                             read (or reseed request); plateau-end seeds go
                             straight into per-lane slots
      ``min_starts_twoptr_planes``  its planes entry (the reference's
                             ``emit_direct=False``): b(e), x0, x1, s and
                             valid as (R, L) planes, no midpoint pruning
  K9  ``compact_starts``     the emission rule and left-compaction of those
      ``compact_starts_packed``  planes into slots (``csrc/compact.cu``);
                             ``smems_from_starts`` is the same rule on one
                             read's planes on the host
  K4b ``min_starts_kernel``  the exhaustive per-(read, e) backward
                             extension, run only when K4a blows its step
                             cap or overflows its slots
  K4c ``strategy1``          the round-3 forward-greedy walker, packed as
                             the reference's ``_pack_r3``

The reference runs each as an XLA while/fori loop whose trip count is the
slowest lane's; on the card every lane runs its own state machine to its
end or its budget (K4b one thread a lane on the pair rank; K4a and K4c a
group of 8 threads a lane on the group rank, every thread running the same
transition). A finished lane's transition is the identity, so per-lane
budgets give the reference's outputs lane for lane. The reference checks
its step cap once per two transitions (its ``UNROLL``), so a cap of
``max_steps`` allows ``ceil(max_steps / 2) * 2`` transitions; the port
gives each lane exactly that.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import _build
from .fm_batch import DeviceFMIndex, bwt_extend_dir_batch, rank_rows

SEED_TRACE = os.environ.get("LARIAT_SEED_TRACE") == "1"
# transitions per step-cap check in the reference's while loop
UNROLL = 2
CAP1, CAP2 = 32, 16


def _strace(tag: str, t0: float) -> float:
    """Print the ms since ``t0`` under ``tag`` when the trace is on; returns
    the time now (the next phase's start)."""
    if SEED_TRACE:
        print(f"[seedtrace] {tag:14s} {(time.time() - t0) * 1e3:7.1f}ms",
              flush=True)
    return time.time()


def _budget(max_steps: int) -> int:
    return -(-max_steps // UNROLL) * UNROLL


def _single(L2: torch.Tensor, c: torch.Tensor):
    """Bi-interval of the one-base string c (clamped to 0..3), int64."""
    cc = c.clamp(0, 3)
    return L2[cc] + 1, L2[3 - cc] + 1, L2[cc + 1] - L2[cc]


def _base_at(rd: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """(R,) codes rd[lane, pos], 4 where pos is out of range."""
    L = rd.shape[1]
    inb = (pos >= 0) & (pos < L)
    c = rd.gather(1, pos.clamp(0, L - 1)[:, None])[:, 0]
    return torch.where(inb, c, 4)


def _fm_args(fmd: DeviceFMIndex):
    return (fmd.fused, fmd.L2, fmd.primary, fmd.seq_len,
            int(fmd.idx_dtype == torch.int64))


def _twoptr_flags(meta: torch.Tensor, aux: torch.Tensor, cap: int) -> None:
    """Column cap+2 of every meta row: bit 0 every lane done, bit 1 a slot
    overflow, bits 2+ the reference's transition count (the slowest lane's,
    rounded up to whole unrolled iterations)."""
    done = meta[:, cap + 1].bool().all().to(torch.int32)
    ovf = (aux[:, 0] > cap).any().to(torch.int32)
    steps = (aux[:, 1].max() + 1) // UNROLL * UNROLL
    meta[:, cap + 2] = done | (ovf << 1) | (steps.to(torch.int32) << 2)


def min_starts_twoptr_plain(fmd: DeviceFMIndex, reads: torch.Tensor,
                            start_e: torch.Tensor, end_e: torch.Tensor,
                            min_intv: torch.Tensor, mid: torch.Tensor,
                            L: int, budget: int, bwd_init: bool,
                            min_seed: int, cap: int,
                            touched: Optional[torch.Tensor] = None,
                            planes: bool = False):
    """Plain twin of K4a: every lane steps in lock step (the reference's
    body, with masks) -> (meta, big, aux); aux = (R, 3) int32 [seeds
    counted, transitions run, fused rows read (``rank_rows``)] per lane.
    ``touched`` (a bool per fused row) gets the rows read set.

    ``planes`` is the twin of the planes entry (the reference's
    ``emit_direct=False``: no midpoint pruning; ``mid``, ``min_seed`` and
    ``cap`` unused) -> (b, x0, x1, s, valid, aux): (R, L) planes, b int32,
    x0, x1, s in the index dtype, valid bool, and aux = [lane done,
    transitions run, fused rows read]."""
    dev = reads.device
    R = reads.shape[0]
    rd = reads.long()
    L2 = fmd.L2.long()
    se, ee = start_e.long(), end_e.long()
    md = None if planes else mid.long()
    mi = min_intv.long().clamp(min=1)
    one = torch.ones(R, dtype=torch.long, device=dev)
    zero = torch.zeros(R, dtype=torch.long, device=dev)
    x0, x1, s = one, one, zero
    if bwd_init:
        # round-2 reseeds: b(start_e + 1) comes from a fresh backward scan;
        # an N at start_e leaves the machine empty at start_e + 1
        c0 = rd.gather(1, se.clamp(0, L - 1)[:, None])[:, 0]
        is_n0 = c0 >= 4
        s0 = _single(L2, c0)
        e = torch.where(is_n0, se + 1, se)
        b = e.clone()
        bwd, p, etgt = ~is_n0, se.clone(), se + 1
        bx0 = torch.where(is_n0, 1, s0[0])
        bx1 = torch.where(is_n0, 1, s0[1])
        bs = torch.where(is_n0, 0, s0[2])
    else:
        e, b = se.clone(), se.clone()
        bwd = torch.zeros(R, dtype=torch.bool, device=dev)
        p, etgt, bx0, bx1, bs = zero, zero, one, one, zero
    n, used, nrows = zero, zero, zero
    rows = torch.arange(R, device=dev)
    if planes:
        opl = torch.zeros((4, R, L), dtype=torch.long, device=dev)
        oval = torch.zeros((R, L), dtype=torch.bool, device=dev)
    else:
        slots = torch.zeros((R, cap), dtype=torch.long, device=dev)
        outb = torch.zeros((R, 3, cap), dtype=torch.long, device=dev)
    for _ in range(budget):
        fwd_live = ~bwd & (e + 1 <= ee)
        bwd_live = bwd & (etgt <= ee)
        live = fwd_live | bwd_live
        if not bool(live.any()):
            break
        used = used + live.long()
        c_f = _base_at(rd, e)
        c_b = _base_at(rd, p - 1)
        empty = fwd_live & (b == e)
        nf = c_f >= 4
        bwd_free = bwd_live & ((p <= 0) | (c_b >= 4))
        do_bwd = bwd_live & ~bwd_free
        do_fwd = fwd_live & ~empty & ~nf
        need = do_bwd | do_fwd
        rx0 = torch.where(do_bwd, bx0, x0)
        rx1 = torch.where(do_bwd, bx1, x1)
        rs = torch.where(need, torch.where(do_bwd, bs, s), 0)
        rc = torch.where(do_bwd, c_b, c_f).clamp(0, 3)
        nx0, nx1, ns = (v.long() for v in bwt_extend_dir_batch(
            fmd, torch.where(need, rx0, 1), torch.where(need, rx1, 1), rs,
            rc, do_bwd))
        nrows = nrows + rank_rows(fmd, torch.where(do_bwd, rx0, rx1), rs,
                                  need, touched)
        acc = need & (ns >= mi)
        sc0, sc1, scs = _single(L2, c_f)
        fwd_emit = fwd_live & (empty | nf | acc)
        bwd_exit = bwd_free | (do_bwd & ~acc)
        fwd_acc = do_fwd & acc
        bwd_acc = do_bwd & acc
        n_e = torch.where(fwd_emit, e + 1, torch.where(bwd_exit, etgt, e))
        n_b = torch.where(fwd_live & nf, e + 1,
                          torch.where(bwd_exit, p, b))
        fresh = empty & ~nf
        n_x0 = torch.where(bwd_exit, bx0, torch.where(
            fresh, sc0, torch.where(fwd_acc, nx0, x0)))
        n_x1 = torch.where(bwd_exit, bx1, torch.where(
            fresh, sc1, torch.where(fwd_acc, nx1, x1)))
        n_s = torch.where(bwd_exit, bs, torch.where(
            fwd_live & nf, 0, torch.where(
                empty, scs, torch.where(fwd_acc, ns, s))))
        n_s = torch.where(empty & nf, 0, n_s)
        enter_bwd = do_fwd & ~acc
        n_bwd = torch.where(bwd_exit, False, bwd | enter_bwd)
        n_p = torch.where(enter_bwd, e, torch.where(bwd_acc, p - 1, p))
        n_etgt = torch.where(enter_bwd, e + 1, etgt)
        n_bx0 = torch.where(enter_bwd, sc0, torch.where(bwd_acc, nx0, bx0))
        n_bx1 = torch.where(enter_bwd, sc1, torch.where(bwd_acc, nx1, bx1))
        n_bs = torch.where(enter_bwd, scs, torch.where(bwd_acc, ns, bs))
        if planes:
            # every transition that settles a column writes it (an N
            # leaves it invalid); each column is written once
            w = fwd_emit | bwd_exit
            ri = rows[w]
            col = (torch.where(bwd_exit, etgt, e + 1) - 1)[w]
            for j, v in enumerate((
                    torch.where(bwd_exit, p, b),
                    torch.where(bwd_exit, bx0, torch.where(empty, sc0, nx0)),
                    torch.where(bwd_exit, bx1, torch.where(empty, sc1, nx1)),
                    torch.where(bwd_exit, bs, torch.where(empty, scs, ns)))):
                opl[j, ri, col] = v[w]
            oval[ri, col] = ~(fwd_live & nf)[w]
            e, b, x0, x1, s = n_e, n_b, n_x0, n_x1, n_s
            bwd, p, etgt = n_bwd, n_p, n_etgt
            bx0, bx1, bs = n_bx0, n_bx1, n_bs
            continue
        # midpoint pruning: a FWD lane whose b passed mid never emits again
        n_e = torch.where(~n_bwd & (n_b > md), ee + 1, n_e)
        # a plateau ends when FWD fails, an N breaks it, or the lane
        # reaches end_e; its seed is [b, e) (or the new state's at end_e)
        em1 = (enter_bwd | (fwd_live & nf)) & (b < e)
        em2 = (fwd_emit | bwd_exit) & (n_e == ee) & (n_b < n_e)
        sqb = torch.where(em2, n_b, b)
        sqe = torch.where(em2, n_e, e)
        keep = ((em1 | em2) & ((sqe - sqb) >= min_seed) & (sqb <= md)
                & (sqe > se))
        w = keep & (n < cap)
        ri, k = rows[w], n[w]
        slots[ri, k] = (sqb[w] << 16) | sqe[w]
        outb[ri, 0, k] = torch.where(em2, n_x0, x0)[w]
        outb[ri, 1, k] = torch.where(em2, n_x1, x1)[w]
        outb[ri, 2, k] = torch.where(em2, n_s, s)[w]
        n = n + keep.long()
        e, b, x0, x1, s = n_e, n_b, n_x0, n_x1, n_s
        bwd, p, etgt, bx0, bx1, bs = n_bwd, n_p, n_etgt, n_bx0, n_bx1, n_bs
    live = torch.where(bwd, etgt, e + 1) <= ee
    if planes:
        dt = fmd.idx_dtype
        aux = torch.stack([(~live).long(), used, nrows], dim=1)
        return (opl[0].to(torch.int32), opl[1].to(dt), opl[2].to(dt),
                opl[3].to(dt), oval, aux.to(torch.int32))
    meta = torch.cat([slots, n.clamp(max=cap)[:, None],
                      (~live).long()[:, None],
                      torch.zeros((R, 1), dtype=torch.long, device=dev)],
                     dim=1).to(torch.int32)
    big = outb.reshape(R, 3 * cap).to(fmd.idx_dtype)
    aux = torch.stack([n, used, nrows], dim=1).to(torch.int32)
    return meta, big, aux


def min_starts_twoptr(fmd: DeviceFMIndex, reads: torch.Tensor,
                      start_e: torch.Tensor, end_e: torch.Tensor,
                      min_intv: torch.Tensor, L: int, *, max_steps: int,
                      min_seed: int, cap: int, mid: torch.Tensor,
                      bwd_init: bool = False):
    """K4a, the reference's ``min_starts_twoptr(emit_direct=True)``: the
    plateau-end SMEMs of every lane, [b, e) for e in (start_e, end_e] with
    b <= mid, length >= min_seed and interval size >= min_intv.

    reads (R, L) codes (uint8 for the kernel); start_e, end_e, mid (R,);
    min_intv (R,). Returns the reference's two planes and the lanes' walk
    lengths: meta int32 (R, cap+3) = [qb<<16|qe slots | count | lane_done |
    flags] (flags bit 0: every lane done, bit 1: a slot overflowed, bits
    2+: transitions run), big (R, 3*cap) in the index dtype = [x0 | x1 | s]
    slots, and aux (R, 3) int32 = [seeds counted, transitions run, fused
    rows read] per lane."""
    dev = reads.device
    R = reads.shape[0]
    dt = fmd.idx_dtype
    budget = _budget(max_steps)
    start_e, end_e, mid = (v.to(dev, torch.int32).contiguous()
                           for v in (start_e, end_e, mid))
    min_intv = min_intv.to(dev, dt).contiguous()
    if not _build.on_cuda(reads):
        meta, big, aux = min_starts_twoptr_plain(
            fmd, reads, start_e, end_e, min_intv, mid, L, budget, bwd_init,
            min_seed, cap)
    else:
        _build.check("reads", reads, dev, (R, L), (torch.uint8,))
        _build.check("fused", fmd.fused, dev, tuple(fmd.fused.shape))
        meta = torch.zeros((R, cap + 3), dtype=torch.int32, device=dev)
        big = torch.zeros((R, 3 * cap), dtype=dt, device=dev)
        aux = torch.empty((R, 3), dtype=torch.int32, device=dev)
        _build.launch("smem_twoptr", reads, start_e, end_e, min_intv, mid,
                      *_fm_args(fmd), R, L, budget, int(bwd_init),
                      int(min_seed), cap, meta, big, aux, size=R)
    _twoptr_flags(meta, aux, cap)
    return meta, big, aux


def min_starts_twoptr_planes(fmd: DeviceFMIndex, reads: torch.Tensor,
                             start_e: torch.Tensor, end_e: torch.Tensor,
                             min_intv: torch.Tensor, L: int, *,
                             max_steps: int = 0, bwd_init: bool = False):
    """K4a's planes entry, the reference's ``min_starts_twoptr(
    emit_direct=False)``: per lane, b(e), x0(e), x1(e), s(e) and valid(e)
    for every end e in (start_e, end_e], at column e - 1, where b(e) is the
    greedy backward stop from e under ``min_intv``; no midpoint pruning.

    reads (R, L) codes (uint8 for the kernel); start_e, end_e, min_intv
    (R,); ``max_steps`` defaults to 8L, and each lane gets the reference's
    budget (``_budget``). Returns (b (R, L) int32, x0, x1, s (R, L) in the
    index dtype, valid (R, L) bool, done (a 0-d bool: every lane finished),
    aux (R, 3) int32 = [lane done, transitions run, fused rows read])."""
    dev = reads.device
    R = reads.shape[0]
    dt = fmd.idx_dtype
    budget = _budget(max_steps or 8 * L)
    start_e, end_e = (v.to(dev, torch.int32).contiguous()
                      for v in (start_e, end_e))
    min_intv = min_intv.to(dev, dt).contiguous()
    if not _build.on_cuda(reads):
        out = min_starts_twoptr_plain(fmd, reads, start_e, end_e, min_intv,
                                      None, L, budget, bwd_init, 0, 0,
                                      planes=True)
    else:
        _build.check("reads", reads, dev, (R, L), (torch.uint8,))
        _build.check("fused", fmd.fused, dev, tuple(fmd.fused.shape))
        out = (torch.zeros((R, L), dtype=torch.int32, device=dev),
               *(torch.zeros((R, L), dtype=dt, device=dev) for _ in range(3)),
               torch.zeros((R, L), dtype=torch.bool, device=dev),
               torch.empty((R, 3), dtype=torch.int32, device=dev))
        _build.launch("smem_planes", reads, start_e, end_e, min_intv,
                      *_fm_args(fmd), R, L, budget, int(bwd_init), *out,
                      size=R)
    aux = out[5]
    return (*out[:5], aux[:, 0].bool().all(), aux)


def compact_starts_plain(b, x0, x1, s, valid, start_e, end_e, mid,
                         min_seed: int, cap: int):
    """Plain twin of K9, the reference's formulation: the emission mask, a
    stable argsort of ~emit a lane and five gathers -> (qb, qe, x0, x1, s)
    (R, min(cap, L)), counts (R,) int32, overflow (a 0-d bool)."""
    R, L = b.shape
    e = torch.arange(1, L + 1, dtype=torch.int32, device=b.device)[None, :]
    big = torch.full((R, 1), 1 << 30, dtype=b.dtype, device=b.device)
    bnext = torch.cat([torch.where(valid[:, 1:], b[:, 1:], big), big], dim=1)
    emit = (valid & (e > start_e[:, None]) & (e <= end_e[:, None])
            & (b.long() <= mid[:, None].long()) & ((e - b) >= min_seed)
            & (bnext > b))
    counts = emit.sum(dim=1).to(torch.int32)
    order = torch.argsort((~emit).to(torch.int8), dim=1, stable=True)
    order = order[:, :cap]

    def take(a):
        return torch.gather(a, 1, order)

    return (take(b), take(e.expand(R, L)), take(x0), take(x1), take(s),
            counts, (counts > cap).any())


# ballots a lane of K9 keeps in shared memory (compact.cu's kMaxChunks);
# a lane of more 32-column chunks keeps them in a scratch of the call
COMPACT_SHARED_CHUNKS = 32


def _on(v: torch.Tensor, dev, dtype) -> torch.Tensor:
    """``v`` itself when it is a contiguous ``dtype`` tensor on ``dev``,
    else a converted copy."""
    if v.dtype == dtype and v.device == dev and v.is_contiguous():
        return v
    return v.to(dev, dtype).contiguous()


def _compact_args(b, x0, x1, s, valid, start_e, end_e, mid, done):
    """K9's inputs in the C entry's order up to ``min_seed``, checked (the
    checks read only metadata), and the ballot scratch of lanes past
    ``COMPACT_SHARED_CHUNKS`` chunks (0 when none is needed)."""
    dev = b.device
    R, L = b.shape
    _build.check("b", b, dev, (R, L))
    if x0.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"x0: dtype {x0.dtype}, expected int32 or int64")
    for name, v in (("x0", x0), ("x1", x1), ("s", s)):
        _build.check(name, v, dev, (R, L), (x0.dtype,))
    _build.check("valid", valid, dev, (R, L), (torch.bool,))
    if done is not None:
        done = _on(done, dev, torch.bool)
        _build.check("done", done, dev, (), (torch.bool,))
    chunks = -(-L // 32)
    far = (torch.empty(R * chunks, dtype=torch.int32, device=dev)
           if chunks > COMPACT_SHARED_CHUNKS else 0)
    return ((b, x0, x1, s, valid,
             *(_on(v, dev, torch.int32) for v in (start_e, end_e, mid)),
             0 if done is None else done, int(x0.dtype == torch.int64), R,
             L), far)


def compact_starts(b, x0, x1, s, valid, start_e, end_e, mid, min_seed: int,
                   cap: int):
    """K9, the reference's ``compact_starts``: the SMEM emission rule over
    the planes (valid, e in (start_e, end_e], b <= mid, e - b >= min_seed,
    b(e + 1) > b(e); mid >= L for round 1) and the emitted (qb, qe, x0, x1,
    s) packed left a lane, e ascending, into C = min(cap, L) slots (past a
    lane's count, its first non-emitted columns, as the stable sort leaves
    them). Returns (qb, qe (R, C) int32, x0, x1, s (R, C) in the planes'
    dtype, counts (R,) int32 uncapped, overflow: a 0-d bool, any count >
    cap). On the card: one memset and one K9 launch, which writes the
    overflow flag too; nothing waits for the card."""
    if not _build.on_cuda(b):
        return compact_starts_plain(b, x0, x1, s, valid, start_e, end_e,
                                    mid, min_seed, cap)
    args, far = _compact_args(b, x0, x1, s, valid, start_e, end_e, mid, None)
    dev = b.device
    R, L = b.shape
    C = min(cap, L)
    # two allocations for the five slot planes: the host's time, not the
    # card's, sets a call's pace
    out = (*torch.empty((2, R, C), dtype=torch.int32, device=dev),
           *torch.empty((3, R, C), dtype=x0.dtype, device=dev))
    counts = torch.empty(R, dtype=torch.int32, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    _build.launch("compact", *args, int(min_seed), C, *out, counts, overflow,
                  0, 0, far, size=R)
    return (*out, counts, overflow)


def compact_starts_packed_plain(b, x0, x1, s, valid, start_e, end_e, mid,
                                done, min_seed: int, cap: int):
    """Plain twin of K9's packed layout: ``compact_starts_plain``'s outputs
    concatenated as the reference does."""
    qb, qe, x0c, x1c, sc, counts, ovf = compact_starts_plain(
        b, x0, x1, s, valid, start_e, end_e, mid, min_seed, cap)
    flags = done.long() | (ovf.long() << 1)
    return torch.cat([qb.long(), qe.long(), x0c.long(), x1c.long(),
                      sc.long(), counts.long()[:, None],
                      flags.expand(b.shape[0], 1)], dim=1)


def compact_starts_packed(b, x0, x1, s, valid, start_e, end_e, mid, done,
                          min_seed: int, cap: int):
    """K9 in the reference's ``compact_starts_packed`` layout: one int64
    (R, 5C + 2) matrix [qb | qe | x0 | x1 | s | count | flags], flags =
    done | overflow << 1 on every row (``done`` a 0-d bool, the planes'
    all-lanes-done flag). On the card: one memset (the launch's ticket
    scratch) and one K9 launch, whose lanes write done into the flags
    column and whose last block adds the overflow there; nothing waits for
    the card."""
    if not _build.on_cuda(b):
        return compact_starts_packed_plain(b, x0, x1, s, valid, start_e,
                                           end_e, mid, done, min_seed, cap)
    args, far = _compact_args(b, x0, x1, s, valid, start_e, end_e, mid, done)
    dev = b.device
    R, L = b.shape
    C = min(cap, L)
    packed = torch.empty((R, 5 * C + 2), dtype=torch.int64, device=dev)
    scratch = torch.empty(2, dtype=torch.int32, device=dev)
    _build.launch("compact", *args, int(min_seed), C, 0, 0, 0, 0, 0, 0, 0,
                  packed, scratch, far, size=R)
    return packed


def min_starts_kernel_plain(fmd: DeviceFMIndex, reads: torch.Tensor,
                            read_idx: torch.Tensor, e: torch.Tensor,
                            min_intv: torch.Tensor, L: int,
                            touched: Optional[torch.Tensor] = None):
    """Plain twin of K4b (all lanes in lock step); ``touched`` (a bool per
    fused row) gets the rows its extensions read set."""
    flat = reads.reshape(-1).long()
    L2 = fmd.L2.long()
    ri = read_idx.long() * L
    e = e.long()
    mi = min_intv.long().clamp(min=1)

    def base_at(pos):
        return flat[ri + pos.clamp(0, L - 1)]

    c0 = base_at(e - 1)
    valid = (e >= 1) & (c0 < 4)
    x0, x1, s = _single(L2, c0)
    b = torch.where(valid, e - 1, e)
    alive = valid
    for t in range(L - 1):
        if not bool(alive.any()):
            break
        pos = e - 2 - t
        c = base_at(pos)
        can = alive & (pos >= 0) & (c < 4)
        n0, n1, ns = (v.long() for v in bwt_extend_dir_batch(
            fmd, torch.where(can, x0, 1), torch.where(can, x1, 1),
            torch.where(can, s, 0), c.clamp(0, 3), torch.ones_like(can)))
        if touched is not None:
            rank_rows(fmd, x0, s, can, touched)
        acc = can & (ns >= mi)
        x0 = torch.where(acc, n0, x0)
        x1 = torch.where(acc, n1, x1)
        s = torch.where(acc, ns, s)
        b = torch.where(acc, pos, b)
        alive = acc
    dt = fmd.idx_dtype
    return b.to(torch.int32), x0.to(dt), x1.to(dt), s.to(dt), valid


def min_starts_kernel(fmd: DeviceFMIndex, reads: torch.Tensor,
                      read_idx: torch.Tensor, e: torch.Tensor,
                      min_intv: torch.Tensor, L: int,
                      counts: Optional[torch.Tensor] = None):
    """K4b: per lane i, the minimal start b such that q[b..e[i]) of read
    read_idx[i] has interval size >= min_intv[i], stepping back over
    non-N bases. Returns (b int32, x0, x1, s in the index dtype, valid
    bool), each (N,); valid is False where q[e-1] is N or e < 1.

    ``counts``, an (N, 2) int32 CUDA tensor, gets each lane's [extensions
    run, fused rows fetched] (the kernel's own count; a CPU call takes
    none)."""
    dev = reads.device
    N = int(read_idx.shape[0])
    read_idx, e = (v.to(dev, torch.int32).contiguous() for v in (read_idx, e))
    min_intv = min_intv.to(dev, fmd.idx_dtype).contiguous()
    if not _build.on_cuda(reads):
        if counts is not None:
            raise ValueError("counts are kept by the kernel, on a CUDA "
                             "tensor")
        return min_starts_kernel_plain(fmd, reads, read_idx, e, min_intv, L)
    _build.check("reads", reads, dev, (reads.shape[0], L), (torch.uint8,))
    if counts is not None:
        _build.check("counts", counts, dev, (N, 2))
    dt = fmd.idx_dtype
    b = torch.empty(N, dtype=torch.int32, device=dev)
    x0, x1, s = (torch.empty(N, dtype=dt, device=dev) for _ in range(3))
    valid = torch.empty(N, dtype=torch.bool, device=dev)
    _build.launch("smem_exhaustive", reads, read_idx, e, min_intv,
                  *_fm_args(fmd), N, L, b, x0, x1, s, valid,
                  0 if counts is None else counts, size=N)
    return b, x0, x1, s, valid


def strategy1_plain(fmd: DeviceFMIndex, reads: torch.Tensor,
                    lens: torch.Tensor, max_intv: int, L: int, min_len: int,
                    cap: int, touched: Optional[torch.Tensor] = None):
    """Plain twin of K4c before packing: per read (count, qb, qe, x0, x1,
    s), the slots (R, cap) in emission order (ascending qb); ``touched`` (a
    bool per fused row) gets the rows its extensions read set."""
    dev = reads.device
    R = reads.shape[0]
    rd = reads.long()
    L2 = fmd.L2.long()
    lens = lens.long()
    rows = torch.arange(R, device=dev)
    x = torch.zeros(R, dtype=torch.long, device=dev)
    x0, x1, s = torch.ones_like(x), torch.ones_like(x), torch.zeros_like(x)
    n = torch.zeros_like(x)
    out = torch.zeros((5, R, cap), dtype=torch.long, device=dev)
    for t in range(L):
        inb = t < lens
        c = rd[:, t]
        at_start = (t == x) & inb
        is_n = c >= 4
        sx0, sx1, ss = _single(L2, c)
        ext = inb & (t > x) & ~is_n
        n0, n1, ns = (v.long() for v in bwt_extend_dir_batch(
            fmd, torch.where(ext, x0, 1), torch.where(ext, x1, 1),
            torch.where(ext, s, 0), c.clamp(0, 3), torch.zeros_like(ext)))
        if touched is not None:
            rank_rows(fmd, x1, s, ext, touched)
        emit = ext & (ns < max_intv) & ((t - x) >= min_len) & (n < cap)
        ri, k = rows[emit], n[emit]
        for j, v in enumerate((x, torch.full_like(x, t + 1), n0, n1, ns)):
            out[j, ri, k] = v[emit]
        n = n + emit.long()
        restart = inb & (is_n | emit)
        fresh = at_start & ~is_n
        x0 = torch.where(fresh, sx0, torch.where(ext, n0, x0))
        x1 = torch.where(fresh, sx1, torch.where(ext, n1, x1))
        s = torch.where(fresh, ss, torch.where(ext, ns, s))
        x = torch.where(restart, t + 1, x)
    dt = fmd.idx_dtype
    return (n.to(torch.int32), out[0].to(torch.int32), out[1].to(torch.int32),
            out[2].to(dt), out[3].to(dt), out[4].to(dt))


def pack_r3(n3, qb3, qe3, ox0, ox1, os3):
    """The reference's ``_pack_r3``: meta int32 (R, cap+1) = [qb<<16|qe
    slots | count], big (R, 3*cap) = [x0 | x1 | s]."""
    meta = torch.cat([(qb3.to(torch.int32) << 16) | qe3.to(torch.int32),
                      n3.to(torch.int32)[:, None]], dim=1)
    return meta, torch.cat([ox0, ox1, os3], dim=1)


def strategy1(fmd: DeviceFMIndex, reads: torch.Tensor, lens: torch.Tensor,
              max_intv: int, L: int, min_len: int, cap: int):
    """K4c: bwt_seed_strategy1 per read (round-3 forward-greedy seeds:
    from each scan start, extend forward until the interval size drops
    below max_intv with length > min_len, emit, restart past it), packed
    as ``pack_r3`` -> (meta, big)."""
    dev = reads.device
    R = reads.shape[0]
    lens = lens.to(dev, torch.int32).contiguous()
    if not _build.on_cuda(reads):
        return pack_r3(*strategy1_plain(fmd, reads, lens, max_intv, L,
                                        min_len, cap))
    _build.check("reads", reads, dev, (R, L), (torch.uint8,))
    meta = torch.zeros((R, cap + 1), dtype=torch.int32, device=dev)
    big = torch.zeros((R, 3 * cap), dtype=fmd.idx_dtype, device=dev)
    fused, L2, primary, seq_len, idx64 = _fm_args(fmd)
    _build.launch("smem_strategy1", reads, lens, fused, L2, primary, seq_len,
                  int(max_intv), idx64, R, L, int(min_len), cap, meta, big,
                  size=R)
    return meta, big


def _pad_pow2(n: int) -> int:
    out = 128
    while out < n:
        out <<= 1
    return out


def _emit_full(bh, x0h, x1h, sh, vh, start_a, end_a, mid_a, L, min_seed):
    """Host emission from full per-e planes (the exhaustive fallback):
    [b(e), e) is an SMEM iff valid, e in (start, end], b <= mid, long
    enough, and b(e+1) > b(e)."""
    Rn = bh.shape[0]
    e_mat = np.arange(1, L + 1, dtype=np.int64)[None, :]
    BIG = np.int64(1 << 60)
    bnext = np.full((Rn, L), BIG, np.int64)
    bnext[:, :-1] = np.where(vh[:, 1:], bh[:, 1:].astype(np.int64), BIG)
    emit = (vh & (e_mat > start_a[:, None]) & (e_mat <= end_a[:, None])
            & (bh.astype(np.int64) <= mid_a[:, None])
            & ((e_mat - bh) >= min_seed) & (bnext > bh))
    ri, ei = np.nonzero(emit)          # lane-major, e-ascending
    m = np.stack([x0h[ri, ei].astype(np.int64),
                  x1h[ri, ei].astype(np.int64),
                  sh[ri, ei].astype(np.int64),
                  bh[ri, ei].astype(np.int64),
                  ei.astype(np.int64) + 1], axis=1)
    return ri, m


def _slots(meta, big, cap, n_rows):
    """(row, (n, 5) [x0, x1, s, qb, qe]) of the filled slots, row-major
    and slot-ascending."""
    cnt = meta[:n_rows, cap]
    kmask = np.arange(cap, dtype=np.int32)[None, :] < cnt[:, None]
    ri, ki = np.nonzero(kmask)
    qbqe = meta[:n_rows, :cap][ri, ki].astype(np.int64)
    b = big[:n_rows]
    m = np.stack([b[:, j * cap:(j + 1) * cap][ri, ki].astype(np.int64)
                  for j in range(3)] + [qbqe >> 16, qbqe & 0xFFFF], axis=1)
    return ri, m


def smems_from_starts(b: np.ndarray, x0: np.ndarray, x1: np.ndarray,
                      s: np.ndarray, valid: np.ndarray, length: int,
                      min_seed_len: int) -> List[Tuple]:
    """Round-1 SMEM list for ONE read from its per-e arrays (e = 1..L,
    array index e-1): the port's copy of the reference's
    ``smems_from_starts``, host code on one read's planes (K4a's planes
    entry, ``min_starts_twoptr_planes``). Returns (x0, x1, s, b, e) tuples
    in e order.

    [b(e), e) is an SMEM iff it is right-maximal: b(e+1) > b(e), where
    crossing an N or the read end counts as +inf. Proof of equivalence to
    bwa's scan enumeration: every occurrence of [b(e), e) is an occurrence
    of any [x, e) with x >= b(e); if all occurrences of [x, e) extend by
    the same base then so do all occurrences of [b(e), e) -- hence
    right-maximality at the scan level and at the b level coincide, and
    b's monotonicity makes each SMEM appear for exactly one e.
    """
    out = []
    for e in range(1, length + 1):
        if not valid[e - 1]:
            continue
        be = int(b[e - 1])
        if e - be < min_seed_len:
            continue
        if e < length and valid[e] and int(b[e]) <= be:
            continue  # extensible to the right: not maximal
        out.append((int(x0[e - 1]), int(x1[e - 1]), int(s[e - 1]),
                    be, e))
    return out


def collect_seeds_arrays_device(fmd: DeviceFMIndex, fm,
                                reads: List[np.ndarray], opt
                                ) -> List[np.ndarray]:
    """Full 3-round collect_intv for a batch of reads: per-read (n, 5)
    int64 arrays [x0, x1, s, qb, qe], the native seed.cpp
    fm_collect_seeds_batch output bit for bit."""
    n_reads = len(reads)
    if n_reads == 0:
        return []
    dev = fmd.device
    # the reference's padding (its phase-A budgets 3L / 4L depend on L):
    # L to a multiple of 64, R to a power of two >= 128; padded reads are
    # all-N and padded lens 0
    L = -(-max(max((len(r) for r in reads), default=1), 2) // 64) * 64
    R = _pad_pow2(n_reads)
    rmat = np.full((R, L), 4, np.uint8)
    lens = np.zeros(R, np.int32)
    for i, r in enumerate(reads):
        rmat[i, :len(r)] = r
        lens[i] = len(r)
    rd = torch.from_numpy(rmat).to(dev)
    min_seed = int(opt.min_seed_len)
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    def twophase_finish(pk, cap, start_e, end_e, min_intv, mid, bwd_init,
                        full_steps, read_rows):
        """Straggler split: phase A (already run, small step budget)
        resolves the typical lanes; the unfinished ones rerun from scratch
        at a narrow width with the full budget and are spliced in. Returns
        ((meta, big), flags & 3); anything but 1 sends the caller to the
        exhaustive fallback."""
        meta = pk[0].cpu().numpy()
        big = pk[1].cpu().numpy()
        fl = int(meta[0, -1])
        if (fl & 2) or (fl & 1):
            return (meta, big), fl & 3
        idx = np.nonzero(meta[:, cap + 1] == 0)[0]
        if SEED_TRACE:
            print(f"[seedtrace] stragglers {len(idx)}/{meta.shape[0]}",
                  flush=True)
        Rs = _pad_pow2(len(idx))
        sub = {k: np.zeros(Rs, np.int64) for k in ("se", "ee", "mi", "md")}
        sub["mi"] += 1
        for k, v in (("se", start_e), ("ee", end_e), ("mi", min_intv),
                     ("md", mid)):
            sub[k][:len(idx)] = v[idx]
        ridx = np.zeros(Rs, np.int64)
        ridx[:len(idx)] = idx
        rows = read_rows[put(ridx, np.int64)]
        pk2 = min_starts_twoptr(
            fmd, rows, put(sub["se"], np.int32), put(sub["ee"], np.int32),
            put(sub["mi"], np.int64), L, max_steps=full_steps,
            bwd_init=bwd_init, min_seed=min_seed, cap=cap,
            mid=put(sub["md"], np.int32))
        meta2 = pk2[0].cpu().numpy()
        fl2 = int(meta2[0, -1])
        if (fl2 & 2) or not (fl2 & 1):
            return (meta, big), 0   # rare: punt to the exhaustive fallback
        meta[idx] = meta2[:len(idx)]
        big[idx] = pk2[1].cpu().numpy()[:len(idx)]
        return (meta, big), 1

    _t = time.time()
    # ---- round 1 (phase A at 3L transitions) and round 3 -----------------
    pk1 = min_starts_twoptr(fmd, rd, put(np.zeros(R), np.int32),
                            put(lens, np.int32), put(np.ones(R), np.int64),
                            L, max_steps=3 * L, min_seed=min_seed, cap=CAP1,
                            mid=put(np.full(R, L + 2), np.int32))
    pk3 = None
    if opt.max_mem_intv > 0:
        cap3 = max(2, L // max(min_seed, 1) + 2)
        pk3 = strategy1(fmd, rd, put(lens, np.int32), int(opt.max_mem_intv),
                        L, min_seed, cap3)
    _t = _strace("r1+r3 dispatch", _t)
    (meta1, big1), flags1 = twophase_finish(
        pk1, CAP1, np.zeros(R, np.int64), lens.astype(np.int64),
        np.ones(R, np.int64), np.full(R, L + 2, np.int64), False, 8 * L, rd)
    _t = _strace("r1 pack dl", _t)
    if flags1 != 1:
        # step cap blown or slot overflow: the exhaustive per-(read, e)
        # kernel and host emission from its full planes (the same function)
        bf, x0f, x1f, sf, vf = (v.cpu().numpy().reshape(R, L)
                                for v in min_starts_kernel(
            fmd, rd, put(np.repeat(np.arange(R), L), np.int32),
            put(np.tile(np.arange(1, L + 1), R), np.int32),
            put(np.ones(R * L), np.int64), L))
        vf = vf & (np.arange(1, L + 1)[None] <= lens[:, None])
        ri1, m1 = _emit_full(bf, x0f, x1f, sf, vf, np.zeros(R, np.int64),
                             lens.astype(np.int64),
                             np.full(R, L + 2, np.int64), L, min_seed)
    else:
        ri1, m1 = _slots(meta1, big1, CAP1, R)
    qb1, qe1 = m1[:, 3], m1[:, 4]
    _t = _strace("r1 assembly", _t)

    # ---- round 2: one two-pointer lane per reseed request ----------------
    re_mask = (qe1 - qb1 >= split_len) & (m1[:, 2] <= opt.split_width)
    r2_reads = ri1[re_mask].astype(np.int32)
    r2_mid = ((qb1[re_mask] + qe1[re_mask]) >> 1).astype(np.int32)
    r2_min = (m1[re_mask, 2] + 1).astype(np.int64)
    n_r2 = len(r2_reads)
    if n_r2:
        R2 = _pad_pow2(n_r2)
        r2_read = np.zeros(R2, np.int32)
        r2_start = np.zeros(R2, np.int32)
        r2_end = np.zeros(R2, np.int32)
        r2_m = np.ones(R2, np.int64)
        r2_read[:n_r2] = r2_reads
        r2_start[:n_r2] = r2_mid
        r2_end[:n_r2] = lens[r2_reads]
        r2_m[:n_r2] = r2_min
        rd2 = rd[put(r2_read, np.int64)]
        pk2 = min_starts_twoptr(
            fmd, rd2, put(r2_start, np.int32), put(r2_end, np.int32),
            put(r2_m, np.int64), L, max_steps=4 * L, bwd_init=True,
            min_seed=min_seed, cap=CAP2, mid=put(r2_start, np.int32))
        (meta2, big2), flags2 = twophase_finish(
            pk2, CAP2, r2_start.astype(np.int64), r2_end.astype(np.int64),
            r2_m, r2_start.astype(np.int64), True, 32 * L, rd2)
        if SEED_TRACE:
            print(f"[seedtrace] r2 lanes={n_r2} flags={flags2}", flush=True)
        if flags2 != 1:
            # step cap / slot overflow: the exhaustive kernel over every
            # (request, e > mid) lane, host emission from the full planes
            span = (lens[r2_reads] - r2_mid).clip(min=0).astype(np.int64)
            lane_req = np.repeat(np.arange(n_r2), span)
            first = np.concatenate([[0], np.cumsum(span)[:-1]])
            lane_e = (r2_mid[lane_req].astype(np.int64) + 1
                      + np.arange(len(lane_req)) - np.repeat(first, span))
            bf, x0f, x1f, sf, vf = (v.cpu().numpy() for v in
                                    min_starts_kernel(
                fmd, rd, put(r2_reads[lane_req], np.int32),
                put(lane_e, np.int32), put(r2_min[lane_req], np.int64), L))
            planes = [np.zeros((n_r2, L), np.int64) for _ in range(4)]
            v2h = np.zeros((n_r2, L), bool)
            le = lane_e - 1
            for pl, v in zip(planes, (bf, x0f, x1f, sf)):
                pl[lane_req, le] = v
            v2h[lane_req, le] = vf
            rj2, m2 = _emit_full(*planes, v2h, r2_mid.astype(np.int64),
                                 lens[r2_reads].astype(np.int64),
                                 r2_mid.astype(np.int64), L, min_seed)
        else:
            rj2, m2 = _slots(meta2, big2, CAP2, n_r2)
        ri2 = r2_reads[rj2].astype(np.int64)
    else:
        m2 = np.zeros((0, 5), np.int64)
        ri2 = np.zeros(0, np.int64)
    _t = _strace("r2", _t)

    # ---- round 3: forward-greedy seeds of positive size --------------------
    if pk3 is not None:
        meta3 = pk3[0].cpu().numpy()
        big3 = pk3[1].cpu().numpy().astype(np.int64)
        C3 = meta3.shape[1] - 1
        n3 = meta3[:, C3].astype(np.int64)
        os3 = big3[:, 2 * C3:3 * C3]
        emit3 = (np.arange(C3)[None, :] < n3[:, None]) & (os3 > 0)
        ri3, ki3 = np.nonzero(emit3)       # read-major, k-ascending
        qbqe3 = meta3[:, :C3][ri3, ki3].astype(np.int64)
        m3 = np.stack([big3[:, :C3][ri3, ki3], big3[:, C3:2 * C3][ri3, ki3],
                       os3[ri3, ki3], qbqe3 >> 16, qbqe3 & 0xFFFF], axis=1)
    else:
        m3 = np.zeros((0, 5), np.int64)
        ri3 = np.zeros(0, np.int64)
    _t = _strace("r3 assembly", _t)

    # ---- merge + the final stable (qb, qe) sort per read -------------------
    rid = np.concatenate([ri1.astype(np.int64), ri2, ri3.astype(np.int64)])
    mall = np.concatenate([m1, m2, m3], axis=0)
    seq = np.arange(len(rid), dtype=np.int64)
    order = np.lexsort((seq, mall[:, 4], mall[:, 3], rid))
    rid = rid[order]
    mall = mall[order]
    counts = np.bincount(rid, minlength=R)[:n_reads]
    out = [a.reshape(-1, 5) for a in np.split(mall, np.cumsum(counts)[:-1])]
    _strace("merge+sort", _t)
    return out


def collect_seeds_device(fmd: DeviceFMIndex, fm, reads: List[np.ndarray],
                         opt) -> List[List[Tuple]]:
    """Tuple-list view of collect_seeds_arrays_device (test surface)."""
    return [[tuple(int(v) for v in row) for row in a.tolist()]
            for a in collect_seeds_arrays_device(fmd, fm, reads, opt)]


def collect_seeds_rbegs_device(dfm: DeviceFMIndex, dg, fm,
                               reads: List[np.ndarray], opt):
    """Device twin of native fm_collect_seeds_rbegs_batch: 3-round SMEM
    seeding plus the occurrence schedule's SA dereference (K5).

    Returns (mems_per_read, rbegs_per_read) in the native format: (n, 5)
    int64 [x0, x1, s, qb, qe] and int64 rbegs in enumerate_occurrences
    order (step-sampled above max_occ)."""
    from ..parallel.align_step import sa_lookup_batch_host

    mems = collect_seeds_arrays_device(dfm, fm, reads, opt)
    _t = time.time()
    max_occ = int(opt.max_occ)
    flat = (np.concatenate(mems, axis=0) if mems
            else np.zeros((0, 5), np.int64))
    sv = flat[:, 2]
    step = np.where(sv > max_occ, sv // np.int64(max_occ), np.int64(1))
    cnt = np.where(sv > max_occ, np.int64(max_occ), sv)
    total = int(cnt.sum())
    starts = np.concatenate([[0], np.cumsum(cnt)[:-1]]).astype(np.int64)
    within = np.arange(total, dtype=np.int64) - np.repeat(starts, cnt)
    rows_arr = np.repeat(flat[:, 0], cnt) + within * np.repeat(step, cnt)
    if total:
        _t = _strace("rbeg schedule", _t)
        out = sa_lookup_batch_host(dg, fm, rows_arr)
        _t = _strace("sa walk", _t)
    else:
        out = np.zeros(0, np.int64)
    per_seed = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int64)
    rbegs = []
    seed_off = 0
    for m in mems:
        lo = per_seed[seed_off]
        hi = per_seed[seed_off + len(m)] if len(m) else lo
        rbegs.append(out[lo:hi].astype(np.int64))
        seed_off += len(m)
    return mems, rbegs
