"""T1: the seed-extension ablation -- the wrapper of ``csrc/extend_ablate.cu``
and its plain PyTorch twin, the port of tools/extend_ablate.py
``run_variant`` (the Pallas kernel ``make_kernel``).

Timing only: each variant switches off one of K1's cost centres and, except
the baseline, computes a deliberately wrong result. ``cummax=False`` drops
F's running max (gap opening only), ``trow=False`` scores every row against
target row 0, ``writeback=False`` updates every DP column every row instead
of the masked band. The result is the (8, B) int32 block of the Pallas
entry: rows alive, max_score, max_i, max_j, max_ie, gscore, then two zero
rows. It is not K1's: there is no _adjust_w, no qlen == 0 shortcut, no end
bonus, and the indices are raw (not +1).

The kernel runs K1's body (a warp a task; a line-for-line copy of
``csrc/sw_extend.cu``'s), so its variants time K1's costs; ``steps``, a
(B,) int32 CUDA tensor, gets each task's warp steps, as K1's ``steps``
does. A CUDA tensor launches the kernel; a CPU tensor runs the twin. Any B is taken (the Pallas entry runs
128-lane chunks); Lq stays below 1024, the Pallas kernel's limit (its
argmax packs h * 1024 + j).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .sw_extend import boundary_scratch

NEG = -0x40000000
# make_kernel's fixed scoring (bwa-mem defaults)
SCORING = dict(o_del=6, e_del=1, o_ins=6, e_ins=1, zdrop=100, match_sc=1,
               mismatch_sc=-4, n_sc=-1)

# the widest query: make_kernel's argmax packs h * 1024 + j
MAX_LQ = 1023
# tools/extend_ablate.py's variants: name -> (Lt halved, switches);
# rows_288 is the baseline over 288 of its 576 rows
VARIANTS = {
    "baseline": (False, {}),
    "no_cummax": (False, {"cummax": False}),
    "no_trow": (False, {"trow": False}),
    "no_writeback": (False, {"writeback": False}),
    "minimal": (False, {"cummax": False, "trow": False, "writeback": False}),
    "rows_288": (True, {}),
}


def run_variant_plain(q: torch.Tensor, t: torch.Tensor, params: torch.Tensor,
                      Lt: int, *, cummax: bool = True, trow: bool = True,
                      writeback: bool = True) -> torch.Tensor:
    """Plain twin of T1 on the tensors' device -> (8, B) int32: one row
    loop over ``Lt``, vectorised over (B, Lq); ``torch.cummax`` stands in
    for the Pallas kernel's doubling prefix max."""
    s = SCORING
    o_del, e_del, o_ins, e_ins = s["o_del"], s["e_del"], s["o_ins"], s["e_ins"]
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    dev = q.device
    B, Lq = q.shape
    i32 = torch.int32
    qc = q.to(i32)
    tc_all = t[:, :Lt].to(i32)
    params = params.to(i32)
    qlen, tlen, w, h0 = (params[:, k:k + 1] for k in range(4))
    jid1 = torch.arange(Lq + 1, dtype=i32, device=dev)[None, :]
    jr = jid1[:, :Lq]
    row0 = torch.clamp(h0 - oe_ins - (jid1 - 1) * e_ins, min=0)
    row0 = torch.where(jid1 == 0, h0, row0)
    ehh = torch.where(jid1 <= qlen, row0, 0).to(i32)
    ehe = torch.zeros((B, Lq + 1), dtype=i32, device=dev)
    alive = (tlen > 0) & (qlen > 0)
    max_score = h0.clone()
    minus1 = torch.full((B, 1), -1, dtype=i32, device=dev)
    max_i, max_j, max_ie, gscore = (minus1.clone() for _ in range(4))
    zcol = torch.zeros((B, 1), dtype=i32, device=dev)
    negcol = torch.full((B, 1), NEG, dtype=i32, device=dev)
    for i in range(Lt):
        in_row = alive & (i < tlen)
        beg = torch.clamp(i - w, min=0)
        end = torch.minimum(i + w + 1, qlen)
        band = (jr >= beg) & (jr < end)
        h1_init = torch.where(
            beg == 0, torch.clamp(h0 - (o_del + e_del * (i + 1)), min=0), 0)
        tcode = tc_all[:, i:i + 1] if trow else tc_all[:, 0:1]
        sub = torch.where((qc >= 4) | (tcode >= 4), s["n_sc"],
                          torch.where(qc == tcode, s["match_sc"],
                                      s["mismatch_sc"]))
        M = ehh[:, :Lq]
        E = ehe[:, :Lq]
        M = torch.where(band, torch.where(M != 0, M + sub, 0), 0)
        a = torch.where(band, torch.clamp(M - oe_ins, min=0) + jr * e_ins,
                        NEG)
        run = torch.cummax(a, dim=1).values if cummax else a
        F = torch.cat([negcol, run[:, :-1] - jr[:, :-1] * e_ins], dim=1)
        F = torch.where(jr == beg, 0, torch.clamp(F, min=0))
        h = torch.maximum(torch.maximum(M, torch.where(band, E, 0)), F)
        h = torch.where(band, h, 0)
        lastmask = jr == torch.clamp(end - 1, min=0)
        h_last = torch.where(lastmask, h, 0).max(dim=1, keepdim=True).values
        nonempty = beg < end
        at_qend = in_row & torch.where(nonempty, end == qlen, beg == qlen)
        h_last = torch.where(nonempty, h_last, 0)
        better_g = at_qend & (gscore < h_last)
        gscore = torch.where(better_g, h_last, gscore)
        max_ie = torch.where(better_g, i, max_ie)
        # the Pallas kernel's packed max(h * 1024 + j): the last argmax,
        # and Lq - 1 on an all-zero row
        pmax = (h * 1024 + jr).max(dim=1, keepdim=True).values
        m_best = pmax // 1024
        mj = pmax - m_best * 1024
        improved = in_row & (m_best > max_score)
        di = i - max_i
        dj = mj - max_j
        gap = max_score - m_best
        zcond = torch.where(di > dj, gap - (di - dj) * e_del > s["zdrop"],
                            gap - (dj - di) * e_ins > s["zdrop"])
        died = in_row & ((m_best == 0) | (~improved & zcond))
        alive_n = alive & (i + 1 < tlen) & ~died
        h_shift = torch.cat([zcol, h], dim=1)
        e_new = torch.maximum(E - e_del, torch.clamp(M - oe_del, min=0))
        e_pad = torch.cat([e_new, zcol], dim=1)
        if writeback:
            ehh_n = torch.where((jid1 > beg) & (jid1 <= end), h_shift, ehh)
            ehh_n = torch.where(jid1 == beg, h1_init, ehh_n)
            ehe_n = torch.where((jid1 >= beg) & (jid1 < end), e_pad, ehe)
            ehe_n = torch.where(jid1 == end, 0, ehe_n)
            ehh = torch.where(in_row, ehh_n, ehh)
            ehe = torch.where(in_row, ehe_n, ehe)
        else:
            ehh, ehe = h_shift, e_pad
        alive = torch.where(in_row, alive_n, alive)
        max_score = torch.where(improved, m_best, max_score)
        max_i = torch.where(improved, i, max_i)
        max_j = torch.where(improved, mj, max_j)
    zero = torch.zeros_like(max_score)
    return torch.cat([alive.to(i32), max_score, max_i, max_j, max_ie, gscore,
                      zero, zero], dim=1).t().contiguous().to(i32)


def run_variant(q: torch.Tensor, t: torch.Tensor, params: torch.Tensor,
                Lt: int, *, cummax: bool = True, trow: bool = True,
                writeback: bool = True,
                steps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """T1 over a task batch -> (8, B) int32.

    q (B, Lq) and t (B, >= Lt) integer codes 0..4 (only t's first Lt
    columns are read), 1 <= Lq <= MAX_LQ; params (B, 8) int32 rows qlen,
    tlen, w, h0 (the rest unused), with qlen <= Lq."""
    B, Lq = q.shape
    if not 1 <= Lq <= MAX_LQ:
        raise ValueError(f"Lq={Lq}: T1 takes 1..{MAX_LQ} query columns "
                         f"(make_kernel packs its argmax as h * 1024 + j)")
    if Lt < 1 or t.shape[0] != B or t.shape[1] < Lt:
        raise ValueError(f"t {tuple(t.shape)} does not cover Lt={Lt} for "
                         f"B={B}")
    kw = dict(cummax=cummax, trow=trow, writeback=writeback)
    if not _build.on_cuda(q):
        if steps is not None:
            raise ValueError("steps are counted by the kernel, on a CUDA "
                             "tensor")
        return run_variant_plain(q, t, params, Lt, **kw)
    dev = q.device
    _build.check("q", q, dev, (B, Lq), _build.CODE_DTYPES)
    _build.check("params", params, dev, (B, 8))
    if t.device != dev or t.dtype not in _build.CODE_DTYPES:
        raise ValueError(f"t: {t.dtype} on {t.device}, expected integer "
                         f"codes on {dev}")
    if steps is not None:
        _build.check("steps", steps, dev, (B,))
    q8 = q.to(torch.uint8).contiguous()
    t8 = t[:, :Lt].to(torch.uint8).contiguous()
    out = torch.empty((8, B), dtype=torch.int32, device=dev)
    s = SCORING
    _build.launch("extend_ablate", q8, t8, params, B, Lq, Lt, s["o_del"],
                  s["e_del"], s["o_ins"], s["e_ins"], s["zdrop"],
                  s["match_sc"], s["mismatch_sc"], s["n_sc"], int(cummax),
                  int(trow), int(writeback), boundary_scratch(B, Lq, Lt, dev),
                  out, 0 if steps is None else steps, size=B)
    return out
