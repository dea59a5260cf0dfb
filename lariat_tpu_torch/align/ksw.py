"""Smith-Waterman DP primitives with BWA-MEM-exact semantics (host reference).

A copy of lariat_tpu/align/ksw.py's host half: numpy row-vectorized
implementations of the three DP routines the alignment engine needs, with
native/ksw.cpp behind them. Its device half, ``local_align_batch``, runs
mate rescue as one two-pass K3 wave (``ops/sw_local.py``).

Reference call sites (what the Go shim drives in the native engine):
 - seed extension inside mem_align1_core  -> ``extend``       (gobwa.go:181-187)
 - global alignment + CIGAR, mem_reg2aln  -> ``global_align`` (gobwa.go:400-415)
 - mate rescue local SW, mem_matesw       -> ``local_align``  (gobwa.go:287-324)

Vectorization notes: the extend/global recurrences open gaps from the
diagonal value M only, so E/F have no intra-row dependency on H and each row
is computable with elementwise ops plus one running-max scan for F. The local
SW opens gaps from the final H; the standard dominance argument (opening a
gap from a gap-sourced cell is never better than extending the original gap)
lets F be computed by the same scan over H without F.

Scoring matrix: 5x5 over codes A,C,G,T,N (match a, mismatch -b, N row/col -1).
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..ops import sw_local

MINUS_INF = -0x40000000

# ---------------------------------------------------------------------------
# Native dispatch: native/ksw.cpp implements the same three routines in C++
# (5-10x faster for the worker processes). The numpy versions below remain
# the executable reference; set LARIAT_NO_NATIVE_KSW=1 to force them.
# ---------------------------------------------------------------------------

_native_lib = None
_native_tried = False
_mat_cache: dict = {}


def _get_native():
    global _native_lib, _native_tried
    if _native_tried:
        return _native_lib
    _native_tried = True
    if os.environ.get("LARIAT_NO_NATIVE_KSW"):
        return None
    try:
        from ..index.suffix import _load_native
        lib = _load_native()
    except Exception:
        lib = None
    if lib is None or not hasattr(lib, "ksw_extend_one"):
        return None
    p = ctypes.c_void_p   # raw addresses (arr.ctypes.data) — cheapest FFI
    c = ctypes.c_int
    lib.ksw_extend_one.restype = None
    lib.ksw_extend_one.argtypes = [p, c, p, c, c, c, c, c, c, c, c, c,
                                   c, c, c, p]
    lib.ksw_global_one.restype = ctypes.c_int32
    lib.ksw_global_one.argtypes = [p, c, p, c, c, c, c, c, c, c, c, c,
                                   p, p, ctypes.c_int32]
    lib.ksw_local_one.restype = None
    lib.ksw_local_one.argtypes = [p, c, p, c, c, c, c, c, c, c, c, c, p]
    if hasattr(lib, "ksw_local_batch"):
        lib.ksw_local_batch.restype = None
        lib.ksw_local_batch.argtypes = [p, p, p, p, ctypes.c_int64,
                                        c, c, c, c, c, c, c, c, p]
    _native_lib = lib
    return _native_lib


def _mat_params(mat: np.ndarray) -> Optional[Tuple[int, int, int]]:
    """(match, mismatch, n_score) if ``mat`` has the regular bwa structure
    (a on the 4x4 diagonal, -b off it, constant N row/col), else None."""
    key = mat.tobytes()
    hit = _mat_cache.get(key)
    if hit is not None:
        return hit if hit != "no" else None
    params: Optional[Tuple[int, int, int]] = None
    if mat.shape == (5, 5):
        a, b, n = int(mat[0, 0]), int(mat[0, 1]), int(mat[4, 0])
        want = np.full((5, 5), n, dtype=np.int64)
        want[:4, :4] = b
        np.fill_diagonal(want[:4, :4], a)
        if np.array_equal(mat.astype(np.int64), want):
            params = (a, b, n)
    _mat_cache[key] = params if params is not None else "no"
    return params


def _as_u8(seq: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(seq, dtype=np.uint8)


def fill_score_matrix(a: int = 1, b: int = 4) -> np.ndarray:
    mat = np.full((5, 5), -1, dtype=np.int64)
    for i in range(4):
        for j in range(4):
            mat[i, j] = a if i == j else -b
    return mat


def _scan_gap(src: np.ndarray, gape: int) -> np.ndarray:
    """F(j) = max_{k < j} (src[k] - (j-1-k)*gape) for j in [0, n); F(0)=-inf.

    Computed as cummax(src[k] + k*gape) shifted right, minus (j-1)*gape.
    """
    n = len(src)
    out = np.full(n, MINUS_INF, dtype=np.int64)
    if n <= 1:
        return out
    k = np.arange(n - 1, dtype=np.int64)
    run = np.maximum.accumulate(src[:-1] + k * gape)
    out[1:] = run - k * gape
    return out


@dataclasses.dataclass
class ExtendResult:
    score: int      # best local-extension score
    qle: int        # query length of the best extension
    tle: int        # target length of the best extension
    gtle: int       # target length of the best to-query-end extension
    gscore: int     # best to-query-end score
    max_off: int    # max band offset reached (drives band doubling)


def extend(query: np.ndarray, target: np.ndarray, mat: np.ndarray,
           o_del: int, e_del: int, o_ins: int, e_ins: int, w: int,
           end_bonus: int, zdrop: int, h0: int) -> ExtendResult:
    """ksw_extend2 semantics: extend right from a seed with initial score h0.

    The caller reverses both sequences for left extension.
    """
    query = np.asarray(query, dtype=np.int64)
    target = np.asarray(target, dtype=np.int64)
    qlen, tlen = len(query), len(target)
    if qlen == 0:
        return ExtendResult(h0, 0, 0, 0, h0, 0)
    lib = _get_native()
    if lib is not None:
        params = _mat_params(mat)
        if params is not None:
            q8, t8 = _as_u8(query), _as_u8(target)
            out = np.empty(6, dtype=np.int32)
            lib.ksw_extend_one(
                q8.ctypes.data, qlen, t8.ctypes.data, tlen,
                o_del, e_del, o_ins, e_ins, w, end_bonus, zdrop, h0,
                params[0], params[1], params[2], out.ctypes.data)
            return ExtendResult(*out.tolist())
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    max_sc = int(mat.max())
    max_ins = max(int((qlen * max_sc + end_bonus - o_ins) / e_ins + 1.0), 1)
    max_del = max(int((qlen * max_sc + end_bonus - o_del) / e_del + 1.0), 1)
    w = min(w, max_ins, max_del)
    # eh_h[j] = H(i-1, j-1) (diagonal); eh_e[j] = E(i, j)
    eh_h = np.zeros(qlen + 2, dtype=np.int64)
    eh_e = np.zeros(qlen + 2, dtype=np.int64)
    eh_h[0] = h0
    eh_h[1] = h0 - oe_ins if h0 > oe_ins else 0
    j = 2
    while j <= qlen and eh_h[j - 1] > e_ins:
        eh_h[j] = eh_h[j - 1] - e_ins
        j += 1
    max_score = h0
    max_i = max_j = -1
    max_ie = -1
    gscore = -1
    max_off = 0
    for i in range(tlen):
        beg = i - w if i > w else 0
        end = min(i + w + 1, qlen)
        if beg >= end:
            # C runs the empty loop body: j==qlen gscore side-effect, m=0 break
            if beg == qlen and gscore < 0:
                max_ie, gscore = i, 0
            break
        h1_init = 0
        if beg == 0:
            h1_init = h0 - (o_del + e_del * (i + 1))
            if h1_init < 0:
                h1_init = 0
        sub = mat[target[i], query[beg:end]]
        M = eh_h[beg:end].copy()
        E = eh_e[beg:end]
        M = np.where(M != 0, M + sub, 0)  # the M==0 quirk disallows 100M3I3D20M
        mfloor_ins = np.maximum(M - oe_ins, 0)
        F = np.maximum(_scan_gap(mfloor_ins, e_ins), 0)
        F[0] = 0
        h = np.maximum.reduce([M, E, F])
        # write-back: eh_h[j] <- H(i, j-1); eh_e[j] <- E(i+1, j)
        eh_h[beg] = h1_init
        eh_h[beg + 1:end + 1] = h
        eh_e[beg:end] = np.maximum(E - e_del, np.maximum(M - oe_del, 0))
        eh_e[end] = 0
        if end == qlen:
            h_last = int(h[-1])
            if gscore < h_last:
                max_ie = i
                gscore = h_last
        m_best = int(h.max())
        if m_best == 0:
            break
        # mj = LAST column achieving the row max (C tie-break)
        mj = beg + (len(h) - 1 - int(np.argmax(h[::-1])))
        if m_best > max_score:
            max_score = m_best
            max_i, max_j = i, mj
            if abs(mj - i) > max_off:
                max_off = abs(mj - i)
        elif zdrop > 0:
            if i - max_i > mj - max_j:
                if max_score - m_best - ((i - max_i) - (mj - max_j)) * e_del > zdrop:
                    break
            else:
                if max_score - m_best - ((mj - max_j) - (i - max_i)) * e_ins > zdrop:
                    break
    return ExtendResult(int(max_score), max_j + 1, max_i + 1,
                        max_ie + 1, int(gscore), int(max_off))


def _push_cigar(cigar: List[Tuple[int, int]], op: int, length: int) -> None:
    if cigar and cigar[-1][0] == op:
        cigar[-1] = (op, cigar[-1][1] + length)
    else:
        cigar.append((op, length))


def global_align(query: np.ndarray, target: np.ndarray, mat: np.ndarray,
                 o_del: int, e_del: int, o_ins: int, e_ins: int, w: int,
                 want_cigar: bool = True
                 ) -> Tuple[int, Optional[List[Tuple[int, int]]]]:
    """ksw_global2 semantics: banded global alignment with traceback.

    Returns (score, cigar); cigar ops 0=M, 1=I (query-consuming), 2=D.
    """
    query = np.asarray(query, dtype=np.int64)
    target = np.asarray(target, dtype=np.int64)
    qlen, tlen = len(query), len(target)
    if qlen == 0 or tlen == 0:
        return MINUS_INF, None
    lib = _get_native()
    if lib is not None:
        params = _mat_params(mat)
        if params is not None:
            q8, t8 = _as_u8(query), _as_u8(target)
            score_out = np.empty(1, dtype=np.int32)
            cap = qlen + tlen + 2
            cig = np.empty(2 * cap, dtype=np.int32)
            n_ops = lib.ksw_global_one(
                q8.ctypes.data, qlen, t8.ctypes.data, tlen,
                o_del, e_del, o_ins, e_ins, w,
                params[0], params[1], params[2],
                score_out.ctypes.data, cig.ctypes.data, cap)
            if n_ops >= 0:
                if not want_cigar:
                    return int(score_out[0]), None
                flat = cig[:2 * n_ops].tolist()
                cigar = list(zip(flat[0::2], flat[1::2]))
                return int(score_out[0]), cigar
    gapoe_del = o_del + e_del
    gapoe_ins = o_ins + e_ins
    n_col = min(qlen, 2 * w + 1)
    z = np.zeros((tlen, n_col), dtype=np.uint8) if want_cigar else None
    eh_h = np.full(qlen + 2, MINUS_INF, dtype=np.int64)
    eh_e = np.full(qlen + 2, MINUS_INF, dtype=np.int64)
    eh_h[0] = 0
    j = 1
    while j <= qlen and j <= w:
        eh_h[j] = -(o_ins + e_ins * j)
        j += 1
    for i in range(tlen):
        beg = i - w if i > w else 0
        end = min(i + w + 1, qlen)
        if beg >= end:
            break
        h1_init = -(o_del + e_del * (i + 1)) if beg == 0 else MINUS_INF
        sub = mat[target[i], query[beg:end]]
        M = eh_h[beg:end] + sub
        E = eh_e[beg:end]
        F = _scan_gap(M - gapoe_ins, e_ins)
        # bwa's per-cell chain starts f at the FINITE MINUS_INF sentinel and
        # decays it by e_ins per column; the decayed sentinel can win the
        # strict f>t comparison at the left band edge and flip direction
        # bits there, so replicate it for bit-exact tracebacks.
        F = np.maximum(F, MINUS_INF
                       - np.arange(end - beg, dtype=np.int64) * e_ins)
        F[0] = MINUS_INF
        h = np.maximum(M, E)
        d = np.where(M >= E, 0, 1).astype(np.uint8)
        d = np.where(h >= F, d, 2)
        h = np.maximum(h, F)
        e_ext = E - e_del
        e_open = M - gapoe_del
        d |= (e_ext > e_open).astype(np.uint8) << 2
        f_ext = F - e_ins
        f_open = M - gapoe_ins
        # F-extend marker is VALUE 2 at bits 4-5 (C: d |= 2<<4): the
        # traceback's F state reads those bits and stays in F only on 2
        d |= (f_ext > f_open).astype(np.uint8) << 5
        if want_cigar:
            z[i, :end - beg] = d
        eh_h[beg] = h1_init
        eh_h[beg + 1:end + 1] = h
        eh_e[beg:end] = np.maximum(e_ext, e_open)
        eh_e[end] = MINUS_INF
    score = int(eh_h[qlen])
    if not want_cigar:
        return score, None
    cigar: List[Tuple[int, int]] = []
    which = 0
    i = tlen - 1
    k = min(i + w + 1, qlen) - 1
    while i >= 0 and k >= 0:
        beg = i - w if i > w else 0
        which = (int(z[i, k - beg]) >> (which << 1)) & 3
        if which == 0:
            _push_cigar(cigar, 0, 1)
            i -= 1
            k -= 1
        elif which == 1:
            _push_cigar(cigar, 2, 1)
            i -= 1
        else:
            _push_cigar(cigar, 1, 1)
            k -= 1
    if i >= 0:
        _push_cigar(cigar, 2, i + 1)
    if k >= 0:
        _push_cigar(cigar, 1, k + 1)
    cigar.reverse()
    return score, cigar


@dataclasses.dataclass
class LocalResult:
    score: int
    qb: int
    qe: int     # inclusive end (kswr_t convention)
    tb: int
    te: int     # inclusive end
    score2: int
    te2: int


def _local_core(query: np.ndarray, target: np.ndarray, mat: np.ndarray,
                o_del: int, e_del: int, o_ins: int, e_ins: int,
                minsc: int, endsc: int
                ) -> Tuple[int, int, int, int, int]:
    """One direction of ksw local SW; returns (score, te, qe, score2, te2)."""
    qlen, tlen = len(query), len(target)
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    H_prev = np.zeros(qlen, dtype=np.int64)   # H(i-1, j)
    E = np.zeros(qlen, dtype=np.int64)        # E(i, j)
    gmax, te = 0, -1
    best_col: Optional[np.ndarray] = None
    col_bests: List[Tuple[int, int]] = []     # merged consecutive-column maxima
    diag = np.zeros(qlen, dtype=np.int64)
    for i in range(tlen):
        sub = mat[target[i], query]
        diag[0] = 0
        diag[1:] = H_prev[:-1]
        M = diag + sub
        H0 = np.maximum.reduce([M, E, np.zeros(qlen, dtype=np.int64)])
        F = np.maximum(_scan_gap(np.maximum(H0 - oe_ins, 0), e_ins), 0)
        H = np.maximum(H0, F)
        E = np.maximum(np.maximum(E - e_del, H - oe_del), 0)
        H_prev = H
        col_max = int(H.max())
        if col_max >= minsc:
            if not col_bests or col_bests[-1][1] + 1 != i:
                col_bests.append((col_max, i))
            elif col_bests[-1][0] < col_max:
                col_bests[-1] = (col_max, i)
        if col_max > gmax:
            gmax = col_max
            te = i
            best_col = H.copy()
            if gmax >= endsc:
                break
    if te < 0 or best_col is None:
        return 0, -1, -1, -1, -1
    qe = int(np.argmax(best_col))
    score2, te2 = -1, -1
    max_match = int(mat.max())
    radius = (gmax + max_match - 1) // max_match
    low, high = te - radius, te + radius
    for cm, ci in col_bests:
        if (ci < low or ci > high) and cm > score2:
            score2, te2 = cm, ci
    return gmax, te, qe, score2, te2


def local_align(query: np.ndarray, target: np.ndarray, mat: np.ndarray,
                o_del: int, e_del: int, o_ins: int, e_ins: int,
                minsc: int) -> LocalResult:
    """ksw_align2 semantics (KSW_XSTART|KSW_XSUBO): local SW + start coords.

    Tie-break of qe within the best column follows position order (bwa's is
    striped-layout order); scores and coordinates agree except on exact-tie
    degeneracies.
    """
    query = np.asarray(query, dtype=np.int64)
    target = np.asarray(target, dtype=np.int64)
    if len(query) == 0 or len(target) == 0:
        return LocalResult(0, -1, -1, -1, -1, -1, -1)
    lib = _get_native()
    if lib is not None:
        params = _mat_params(mat)
        if params is not None:
            q8, t8 = _as_u8(query), _as_u8(target)
            out = np.empty(7, dtype=np.int32)
            lib.ksw_local_one(
                q8.ctypes.data, len(query), t8.ctypes.data, len(target),
                o_del, e_del, o_ins, e_ins, minsc,
                params[0], params[1], params[2], out.ctypes.data)
            return LocalResult(*out.tolist())
    score, te, qe, score2, te2 = _local_core(
        query, target, mat, o_del, e_del, o_ins, e_ins, minsc, 1 << 30)
    if te < 0 or score < minsc:
        return LocalResult(score, -1, -1, -1, -1, score2, te2)
    rq = query[:qe + 1][::-1].copy()
    rt = target[:te + 1][::-1].copy()
    s2, te_r, qe_r, _, _ = _local_core(
        rq, rt, mat, o_del, e_del, o_ins, e_ins, 1 << 30, score)
    qb = qe - qe_r
    tb = te - te_r
    return LocalResult(score, qb, qe, tb, te, score2, te2)


def local_align_batch_native(tasks, mat: np.ndarray, o_del: int, e_del: int,
                             o_ins: int, e_ins: int, minsc: int
                             ) -> Optional[List[LocalResult]]:
    """Host-batched ``local_align``: one FFI call for all (query, target)
    tasks (mate rescue runs ~1 DP per pair; per-call ctypes packing costs
    ~50 us). Bit-identical per task to ``local_align``; None when the
    native library or the regular matrix structure is unavailable."""
    lib = _get_native()
    if lib is None or not hasattr(lib, "ksw_local_batch"):
        return None
    params = _mat_params(np.asarray(mat))
    if params is None:
        return None
    n = len(tasks)
    if n == 0:
        return []
    q_off = np.zeros(n + 1, np.int64)
    t_off = np.zeros(n + 1, np.int64)
    for i, (q, t) in enumerate(tasks):
        q_off[i + 1] = q_off[i] + len(q)
        t_off[i + 1] = t_off[i] + len(t)
    qs = (np.concatenate([_as_u8(q) for q, _ in tasks])
          if q_off[-1] else np.zeros(1, np.uint8))
    ts = (np.concatenate([_as_u8(t) for _, t in tasks])
          if t_off[-1] else np.zeros(1, np.uint8))
    out = np.empty((n, 7), np.int32)
    lib.ksw_local_batch(
        qs.ctypes.data, q_off.ctypes.data, ts.ctypes.data, t_off.ctypes.data,
        ctypes.c_int64(n), o_del, e_del, o_ins, e_ins, minsc,
        params[0], params[1], params[2], out.ctypes.data)
    return [LocalResult(*row) for row in out.tolist()]


def download_blocks(outs, inv, axis: int) -> np.ndarray:
    """The blocks' results of a split wave on the host, one download a
    block, concatenated along ``axis`` in block order and put back in task
    order by ``inv`` (None: one block, already in order)."""
    host = [o.cpu().numpy() for o in outs]
    got = host[0] if len(host) == 1 else np.concatenate(host, axis=axis)
    return got if inv is None else np.take(got, inv, axis=axis)


def pad_tiles(qs, ts) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray]:
    """One wave's code tiles for the (qs[i], ts[i]) tasks: (q, qlen, t,
    tlen), lengths padded to multiples of 64 and the batch to a power of
    two of at least 128, as the reference pads its waves; the rows past the
    tasks are zero."""
    n = len(qs)
    Lq = -(-max(1, max(len(x) for x in qs)) // 64) * 64
    Lt = -(-max(1, max(len(x) for x in ts)) // 64) * 64
    Bp = 128
    while Bp < n:
        Bp <<= 1
    qa = np.zeros((Bp, Lq), np.uint8)
    ta = np.zeros((Bp, Lt), np.uint8)
    qlen = np.zeros(Bp, np.int32)
    tlen = np.zeros(Bp, np.int32)
    for i, (qi, ti) in enumerate(zip(qs, ts)):
        qa[i, :len(qi)] = qi
        ta[i, :len(ti)] = ti
        qlen[i] = len(qi)
        tlen[i] = len(ti)
    return qa, qlen, ta, tlen


def local_align_batch(tasks: List[Tuple[np.ndarray, np.ndarray]],
                      mat: np.ndarray, o_del: int, e_del: int, o_ins: int,
                      e_ins: int, minsc: int, device, split_fn=None,
                      trace: Optional[dict] = None) -> List[LocalResult]:
    """ksw_align2 (XSTART|XSUBO) for many (query, target) tasks on
    ``device``: one two-pass K3 wave (forward local SW, then the reversed
    prefixes for the start coordinates) and one (8, B) download.
    Bit-identical per task to ``local_align``. Lengths pad to multiples of
    64 and the batch to a power of two >= 128, as the reference pads its
    waves.

    ``split_fn(n_rows, real)`` (the reference's ``shard_fn``; the engine's
    ``_split_wave``) deals the padded rows over devices as ([(device,
    rows)], inv): each nonempty block runs the whole two-pass call on its
    device (the second pass reverses prefixes at the first pass's ends),
    every block is dispatched before any is downloaded, and ``inv`` puts
    the rows back in task order. ``trace``, a dict, gets the wave's build,
    dispatch and download seconds and the bytes sent each way."""
    B = len(tasks)
    if B == 0:
        return []
    t0 = time.time()
    params = _mat_params(np.asarray(mat))
    if params is None:
        raise ValueError("the local kernel needs bwa's uniform score matrix")
    results: List[LocalResult] = [None] * B  # type: ignore[list-item]
    fwd_idx = [i for i, (q, t) in enumerate(tasks) if len(q) and len(t)]
    for i, (q, t) in enumerate(tasks):
        if not (len(q) and len(t)):
            results[i] = LocalResult(0, -1, -1, -1, -1, -1, -1)
    if not fwd_idx:
        return results
    n = len(fwd_idx)
    qa, qlen, ta, tlen = pad_tiles([tasks[i][0] for i in fwd_idx],
                                   [tasks[i][1] for i in fwd_idx])
    Bp = len(qlen)
    minscs = np.full(Bp, 1 << 30, np.int32)
    minscs[:n] = minsc
    arrays = (qa, qlen, ta, tlen, minscs)
    blocks, inv = (split_fn(Bp, n) if split_fn is not None
                   else ([(torch.device(device), None)], None))
    t_build = time.time()
    outs = [sw_local.local_two_pass(
        *(torch.from_numpy(a if inv is None else a[idx]).to(dev)
          for a in arrays),
        o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
        match_sc=params[0], mismatch_sc=params[1], n_sc=params[2])
        for dev, idx in blocks if inv is None or len(idx)]
    t_disp = time.time()
    rows = download_blocks(outs, inv, 1)      # (8, Bp) in task order
    if trace is not None:
        trace.update(build=t_build - t0, disp=t_disp - t_build,
                     dl=time.time() - t_disp,
                     up=sum(a.nbytes for a in arrays), dn=rows.nbytes)
    score, te, qe, score2, te2, qe_r, te_r, scored = (
        rows[k].tolist() for k in range(8))
    for k, i in enumerate(fwd_idx):
        if scored[k]:
            results[i] = LocalResult(
                score[k], qe[k] - qe_r[k], qe[k],
                te[k] - te_r[k], te[k], score2[k], te2[k])
        else:
            results[i] = LocalResult(score[k], -1, -1, -1, -1,
                                     score2[k], te2[k])
    return results
