"""Plain PyTorch batched seed extension (bwa's ksw_extend2): the twin of
kernel K1 (``csrc/sw_extend.cu``) and of lariat_tpu/ops/sw_batch.py
``extend_batch``.

The DP is sequential over target rows; within a row every query position
is independent (gap opens come from the diagonal M term), so a row is
elementwise work on (B, Lq) plus one running max along the query for F.
Early exits become a per-task ``alive`` mask; ties take the last argmax in
a row and only a strict improvement across rows. All arithmetic is int32,
so the twin equals the kernel and the JAX package exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG = -0x40000000


class ExtendBatchResult(NamedTuple):
    score: torch.Tensor    # (B,) int32
    qle: torch.Tensor
    tle: torch.Tensor
    gtle: torch.Tensor
    gscore: torch.Tensor
    max_off: torch.Tensor


def _adjust_w(qlen, w, max_sc, end_bonus, o_ins, e_ins, o_del, e_del):
    """ksw_extend2's band cap: divide in float64, truncate toward zero."""
    q = qlen.to(torch.float64)
    max_ins = ((q * max_sc + end_bonus - o_ins) / e_ins + 1.0).to(torch.int32)
    max_ins = torch.clamp(max_ins, min=1)
    max_del = ((q * max_sc + end_bonus - o_del) / e_del + 1.0).to(torch.int32)
    max_del = torch.clamp(max_del, min=1)
    return torch.minimum(torch.minimum(w, max_ins), max_del)


def extend_batch(query: torch.Tensor, qlen: torch.Tensor,
                 target: torch.Tensor, tlen: torch.Tensor,
                 mat: torch.Tensor, w: torch.Tensor, h0: torch.Tensor,
                 o_del: int = 6, e_del: int = 1, o_ins: int = 6,
                 e_ins: int = 1, end_bonus: int = 5, zdrop: int = 100,
                 packed: bool = False, rows_run: bool = False):
    """Batched ksw_extend2 on the tensors' device.

    query (B, Lq) and target (B, Lt) codes 0..4, padded arbitrarily past
    qlen/tlen; qlen, tlen, w, h0 (B,); mat (5, 5) scoring matrix. Returns
    an ExtendBatchResult, or with ``packed`` one (6, B) int32 tensor; with
    ``rows_run`` also the (B,) int32 count of rows each task entered
    before it stopped (its stopping row included): the work a kernel must
    do on these inputs."""
    dev = query.device
    B, Lq = query.shape
    Lt = target.shape[1]
    i32 = torch.int32
    query = query.to(i32)
    target = target.to(i32)
    qlen = qlen.to(i32)
    tlen = tlen.to(i32)
    h0 = h0.to(i32)
    mat = mat.to(dev, i32)
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    max_sc = int(mat.max())
    w = _adjust_w(qlen, w.to(i32), max_sc, end_bonus, o_ins, e_ins, o_del,
                  e_del)

    jidx = torch.arange(Lq + 1, dtype=i32, device=dev)[None, :]
    jr = jidx[:, :Lq]
    # first row: eh_h[0] = h0, eh_h[j] = h0 - oe_ins - (j-1)*e_ins while > 0
    row0 = h0[:, None] - oe_ins - torch.clamp(jidx - 1, min=0) * e_ins
    row0 = torch.where(jidx == 0, h0[:, None], row0)
    row0 = torch.where(row0 > 0, row0, 0)
    row0 = torch.where((jidx == 1) & (h0[:, None] <= oe_ins), 0, row0)
    eh_h = torch.where(jidx <= qlen[:, None], row0, 0).to(i32)
    eh_e = torch.zeros((B, Lq + 1), dtype=i32, device=dev)
    qsub = mat[:, query.reshape(-1)].reshape(5, B, Lq)   # (5, B, Lq)

    alive = (tlen > 0) & (qlen > 0)
    max_score = h0.clone()
    max_i = torch.full((B,), -1, dtype=i32, device=dev)
    max_j = max_i.clone()
    max_ie = max_i.clone()
    gscore = max_i.clone()
    max_off = torch.zeros((B,), dtype=i32, device=dev)
    zcol = torch.zeros((B, 1), dtype=i32, device=dev)
    negcol = torch.full((B, 1), NEG, dtype=i32, device=dev)
    bidx = torch.arange(B, device=dev)
    n_run = torch.zeros((B,), dtype=i32, device=dev)

    for i in range(Lt):
        in_row = alive & (i < tlen)
        n_run += in_row.to(i32)
        beg = torch.clamp(i - w, min=0)
        end = torch.minimum(i + w + 1, qlen)
        band = (jr >= beg[:, None]) & (jr < end[:, None])
        h1_init = torch.where(
            beg == 0, torch.clamp(h0 - (o_del + e_del * (i + 1)), min=0), 0)
        sub = qsub[target[:, i].long(), bidx]                 # (B, Lq)
        M = eh_h[:, :Lq]
        E = eh_e[:, :Lq]
        M = torch.where(M != 0, M + sub, 0)
        M = torch.where(band, M, 0)
        mfloor = torch.clamp(M - oe_ins, min=0)
        # F[j] = max(0, max_{beg<=k<j} mfloor[k] - (j-1-k)*e_ins)
        a = torch.where(band, mfloor + jr * e_ins, NEG)
        run = torch.cummax(a, dim=1).values
        F = torch.cat([negcol, run[:, :-1] - jr[:, :-1] * e_ins], dim=1)
        F = torch.clamp(F, min=0)
        F = torch.where(jr == beg[:, None], 0, F)
        h = torch.maximum(torch.maximum(M, torch.where(band, E, 0)), F)
        h = torch.where(band, h, 0)
        h_last = h.gather(1, torch.clamp(end - 1, min=0)[:, None].long())[:, 0]
        # ksw's post-loop check is j == qlen with j = end (non-empty band)
        # or j = beg (empty band)
        nonempty = beg < end
        at_qend = in_row & torch.where(nonempty, end == qlen, beg == qlen)
        h_last = torch.where(nonempty, h_last, 0)
        better_g = at_qend & (gscore < h_last)
        gscore_n = torch.where(better_g, h_last, gscore)
        max_ie_n = torch.where(better_g, i, max_ie)
        # row max and its LAST argmax
        m_best = h.max(dim=1).values
        mj = (Lq - 1 - h.flip(1).argmax(dim=1)).to(i32)
        improved = in_row & (m_best > max_score)
        max_off_n = torch.where(
            improved, torch.maximum(max_off, (mj - i).abs()), max_off)
        max_score_n = torch.where(improved, m_best, max_score)
        max_i_n = torch.where(improved, i, max_i)
        max_j_n = torch.where(improved, mj, max_j)
        di = i - max_i
        dj = mj - max_j
        zcond = torch.where(di > dj,
                            max_score - m_best - (di - dj) * e_del > zdrop,
                            max_score - m_best - (dj - di) * e_ins > zdrop)
        died = in_row & ((m_best == 0) | (~improved & zcond))
        alive_n = alive & (i + 1 < tlen) & ~died
        # write-backs: eh_h[j] <- H(i, j-1) in (beg, end], eh_h[beg] <-
        # h1_init; eh_e[j] <- E(i+1, j) in [beg, end), eh_e[end] <- 0
        h_shift = torch.cat([zcol, h], dim=1)
        wmask = (jidx > beg[:, None]) & (jidx <= end[:, None])
        eh_h_n = torch.where(wmask, h_shift, eh_h)
        eh_h_n = torch.where(jidx == beg[:, None], h1_init[:, None], eh_h_n)
        e_new = torch.maximum(E - e_del, torch.clamp(M - oe_del, min=0))
        e_pad = torch.cat([e_new, zcol], dim=1)
        emask = (jidx >= beg[:, None]) & (jidx < end[:, None])
        eh_e_n = torch.where(emask, e_pad, eh_e)
        eh_e_n = torch.where(jidx == end[:, None], 0, eh_e_n)
        keep = in_row[:, None]
        eh_h = torch.where(keep, eh_h_n, eh_h)
        eh_e = torch.where(keep, eh_e_n, eh_e)
        alive = torch.where(in_row, alive_n, alive)
        max_score = torch.where(in_row, max_score_n, max_score)
        max_i = torch.where(in_row, max_i_n, max_i)
        max_j = torch.where(in_row, max_j_n, max_j)
        max_ie = torch.where(in_row, max_ie_n, max_ie)
        gscore = torch.where(in_row, gscore_n, gscore)
        max_off = torch.where(in_row, max_off_n, max_off)

    empty = qlen == 0
    res = ExtendBatchResult(
        score=torch.where(empty, h0, max_score),
        qle=torch.where(empty, 0, max_j + 1),
        tle=torch.where(empty, 0, max_i + 1),
        gtle=torch.where(empty, 0, max_ie + 1),
        gscore=torch.where(empty, h0, gscore),
        max_off=torch.where(empty, 0, max_off))
    res = ExtendBatchResult(*(r.to(i32) for r in res))
    out = torch.stack(list(res)) if packed else res
    return (out, n_run) if rows_run else out
