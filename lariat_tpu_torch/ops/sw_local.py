"""K3: batched forward local Smith-Waterman for mate rescue -- the wrapper
of ``csrc/sw_local.cu``, its plain PyTorch twin, and the two-pass
ksw_align2 built from it.

Ports lariat_tpu/ops/sw_local_pallas.py: ``local_batch_pallas`` (one
forward pass) and ``local_two_pass_pallas`` (forward pass, reversed
prefixes, start-coordinate pass, one packed (8, B) result).
"""

from __future__ import annotations

import torch

from . import _build

NEG = -0x40000000


def local_batch_plain(query: torch.Tensor, qlen: torch.Tensor,
                      target: torch.Tensor, tlen: torch.Tensor,
                      minsc: torch.Tensor, *, o_del: int = 6,
                      e_del: int = 1, o_ins: int = 6, e_ins: int = 1,
                      match_sc: int = 1, mismatch_sc: int = -4,
                      n_sc: int = -1) -> torch.Tensor:
    """Plain twin of K3 on the tensors' device -> (8, B) int32 rows score,
    te, qe (first argmax of the best column), score2, te2, 0, 0, 0."""
    dev = query.device
    B, Lq = query.shape
    Lt = target.shape[1]
    i32 = torch.int32
    qc = query.to(i32)
    target = target.to(i32)
    qlen = qlen.to(i32)
    tlen = tlen.to(i32)
    minsc = minsc.to(i32)
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    max_sc = max(match_sc, 1)
    jr = torch.arange(Lq, dtype=i32, device=dev)[None, :]
    qvalid = jr < qlen[:, None]
    q_is_n = qc >= 4
    H = torch.zeros((B, Lq), dtype=i32, device=dev)
    E = torch.zeros((B, Lq), dtype=i32, device=dev)
    zcol = torch.zeros((B, 1), dtype=i32, device=dev)
    negcol = torch.full((B, 1), NEG, dtype=i32, device=dev)
    gmax = torch.zeros((B,), dtype=i32, device=dev)
    te = torch.full((B,), -1, dtype=i32, device=dev)
    qe = te.clone()
    cm = torch.zeros((B, Lt), dtype=i32, device=dev)
    for i in range(Lt):
        in_row = i < tlen
        tcode = target[:, i:i + 1]
        sub = torch.where(q_is_n | (tcode >= 4), n_sc,
                          torch.where(qc == tcode, match_sc, mismatch_sc))
        M = torch.cat([zcol, H[:, :-1]], dim=1) + sub
        H0 = torch.clamp(torch.maximum(M, E), min=0)
        # F[j] = max(0, max_{k<j} max(H0[k] - oe_ins, 0) - (j-1-k)*e_ins)
        run = torch.cummax(torch.clamp(H0 - oe_ins, min=0) + jr * e_ins,
                           dim=1).values
        F = torch.cat([negcol, run[:, :-1] - jr[:, :-1] * e_ins], dim=1)
        Hn = torch.where(qvalid, torch.maximum(H0, torch.clamp(F, min=0)), 0)
        En = torch.clamp(torch.maximum(E - e_del, Hn - oe_del), min=0)
        m_best = torch.where(in_row, Hn.max(dim=1).values, 0)
        qe_row = Hn.argmax(dim=1).to(i32)          # first argmax
        cm[:, i] = m_best
        improved = in_row & (m_best > gmax)
        H = torch.where(in_row[:, None], Hn, H)
        E = torch.where(in_row[:, None], En, E)
        gmax = torch.where(improved, m_best, gmax)
        te = torch.where(improved, i, te)
        qe = torch.where(improved, qe_row, qe)
    # second best over merged runs of column maxima (bwa's stored index)
    thr = gmax + (max_sc - 1)

    def outside(ci):
        return (ci - te).abs() * max_sc > thr

    run_max = torch.full((B,), -1, dtype=i32, device=dev)
    run_idx = torch.full((B,), -2, dtype=i32, device=dev)
    best2 = torch.full((B,), -1, dtype=i32, device=dev)
    te2 = best2.clone()
    for i in range(Lt):
        c = cm[:, i]
        valid = (i < tlen) & (c >= minsc)
        is_new = valid & (run_idx + 1 != i)
        use = is_new & (run_idx >= 0) & outside(run_idx) & (run_max > best2)
        best2 = torch.where(use, run_max, best2)
        te2 = torch.where(use, run_idx, te2)
        moved = is_new | (valid & ~is_new & (run_max < c))
        run_max = torch.where(moved, c, run_max)
        run_idx = torch.where(moved, i, run_idx)
    use = (run_idx >= 0) & outside(run_idx) & (run_max > best2)
    best2 = torch.where(use, run_max, best2)
    te2 = torch.where(use, run_idx, te2)
    none = te < 0
    zero = torch.zeros_like(te)
    return torch.stack([torch.where(none, 0, gmax), te,
                        torch.where(none, -1, qe), best2, te2,
                        zero, zero, zero]).to(i32)


def local_batch(query: torch.Tensor, qlen: torch.Tensor,
                target: torch.Tensor, tlen: torch.Tensor,
                minsc: torch.Tensor, *, o_del: int = 6, e_del: int = 1,
                o_ins: int = 6, e_ins: int = 1, match_sc: int = 1,
                mismatch_sc: int = -4, n_sc: int = -1) -> torch.Tensor:
    """K3: one forward local-SW pass -> (8, B) int32 (see the plain twin).
    query (B, Lq) / target (B, Lt) integer codes; qlen, tlen, minsc (B,)
    int32."""
    kw = dict(o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
              match_sc=match_sc, mismatch_sc=mismatch_sc, n_sc=n_sc)
    if not _build.on_cuda(query):
        return local_batch_plain(query, qlen, target, tlen, minsc, **kw)
    dev = query.device
    B, Lq = query.shape
    Lt = target.shape[1]
    _build.check("query", query, dev, (B, Lq), _build.CODE_DTYPES)
    _build.check("target", target, dev, (B, Lt), _build.CODE_DTYPES)
    for name, v in (("qlen", qlen), ("tlen", tlen), ("minsc", minsc)):
        _build.check(name, v, dev, (B,))
    _build.check_byte_scores(match_sc=match_sc, mismatch_sc=mismatch_sc,
                             n_sc=n_sc)
    q8 = query.to(torch.uint8).contiguous()
    t8 = target.to(torch.uint8).contiguous()
    # row boundaries between column tiles, used only past one tile
    bnd = torch.empty((B, Lt, 4) if Lq > _build.TILE_COLS else (1, 4),
                      dtype=torch.int32, device=dev)
    out = torch.empty((8, B), dtype=torch.int32, device=dev)
    _build.launch("sw_local", q8, t8, qlen, tlen, minsc, B, Lq, Lt, o_del,
                  e_del, o_ins, e_ins, match_sc, mismatch_sc, n_sc, bnd, out,
                  size=B)
    return out


def _rev_prefix(x: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """rev[b, j] = x[b, end[b] - j] for j <= end[b], else 0 (end
    inclusive)."""
    L = x.shape[1]
    idx = end.to(torch.int64)[:, None] - torch.arange(
        L, dtype=torch.int64, device=x.device)[None, :]
    take = x.gather(1, torch.clamp(idx, 0, L - 1))
    return torch.where(idx >= 0, take, 0).to(torch.int32)


def local_two_pass(query: torch.Tensor, qlen: torch.Tensor,
                   target: torch.Tensor, tlen: torch.Tensor,
                   minsc: torch.Tensor, **kw) -> torch.Tensor:
    """Full ksw_align2 (mate-rescue DP) on the device: the forward pass, the
    reversed-prefix inputs built there, and the start-coordinate pass ->
    (8, B) int32 rows score, te, qe, score2, te2, qe_r, te_r, scored.

    The second pass runs on every scored task (te >= 0 and score >= minsc);
    unscored tasks run with zero lengths and are masked by ``scored``."""
    query = query.to(torch.int32)
    target = target.to(torch.int32)
    out1 = local_batch(query, qlen, target, tlen, minsc, **kw)
    score, te, qe = out1[0], out1[1], out1[2]
    scored = (te >= 0) & (score >= minsc)
    q2 = _rev_prefix(query, qe)
    t2 = _rev_prefix(target, te)
    qlen2 = torch.where(scored, qe + 1, 0).to(torch.int32)
    tlen2 = torch.where(scored, te + 1, 0).to(torch.int32)
    big = torch.full_like(minsc, 1 << 30)
    out2 = local_batch(q2, qlen2, t2, tlen2, big, **kw)
    out = out1.clone()
    out[5:] = 0
    out[5] = out2[2]          # qe_r
    out[6] = out2[1]          # te_r
    out[7] = scored.to(torch.int32)
    return out
