"""K2 and K2b: batched banded global alignment (ksw_global2) and its
backtrack -- the wrappers of ``csrc/sw_global.cu`` and
``csrc/traceback.cu``, their plain PyTorch twins, and the host helpers that
turn the backtrack's blob into CIGARs.

Ports lariat_tpu/ops/sw_global_pallas.py: ``global_batch_pallas`` (K2)
and ``traceback_ops_fused`` over ``traceback_ops_device`` (K2b, an XLA
walk in the JAX package). ``split_traceback_blob``,
``cigars_from_ops_packed``, ``cigars_from_ops_raw`` and ``cigars_from_ops``
are copied from there (that module imports jax). ``unpack_ops`` turns K2b's
packed ops into the unpacked stream that the reference's
``traceback_ops_device`` returns, which the host finishers take.

z is the (B, Lt, Lq) uint8 direction matrix at absolute query columns:
bits 0-1 pick H's source (0 diagonal, 1 E, 2 F), bit 2 marks E extended,
bit 5 F extended. Only rows below tlen are filled, in band; all else is 0.
The kernel writes every byte of z, task-major.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import _build

NEG = -0x40000000


def global_batch_plain(query: torch.Tensor, qlen: torch.Tensor,
                       target: torch.Tensor, tlen: torch.Tensor,
                       w: torch.Tensor, *, o_del: int = 6, e_del: int = 1,
                       o_ins: int = 6, e_ins: int = 1, match_sc: int = 1,
                       mismatch_sc: int = -4, n_sc: int = -1
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K2 on the tensors' device -> (score (B,) int32,
    z (B, Lt, Lq) uint8). Row by row over the target; within a row the F
    chain is a running max along the query, started at bwa's finite NEG
    sentinel (which decays by e_ins and can win the strict f > t test at
    the left band edge)."""
    dev = query.device
    B, Lq = query.shape
    Lt = target.shape[1]
    i32 = torch.int32
    qc = query.to(i32)
    target = target.to(i32)
    qlen = qlen.to(i32)
    tlen = tlen.to(i32)
    w = w.to(i32)
    gapoe_del = o_del + e_del
    gapoe_ins = o_ins + e_ins
    jid1 = torch.arange(Lq + 1, dtype=i32, device=dev)[None, :]
    jr = jid1[:, :Lq]
    row0 = torch.where((jid1 >= 1)
                       & (jid1 <= torch.minimum(qlen, w)[:, None]),
                       -(o_ins + e_ins * jid1), NEG)
    eh_h = torch.where(jid1 == 0, 0, row0).to(i32)
    eh_e = torch.full((B, Lq + 1), NEG, dtype=i32, device=dev)
    z = torch.zeros((B, Lt, Lq), dtype=torch.uint8, device=dev)
    negcol = torch.full((B, 1), NEG, dtype=i32, device=dev)
    q_is_n = qc >= 4
    for i in range(Lt):
        in_row = (i < tlen)[:, None]
        beg = torch.clamp(i - w, min=0)[:, None]
        end = torch.minimum(i + w + 1, qlen)[:, None]
        band = (jr >= beg) & (jr < end)
        h1_init = torch.where(beg == 0, -(o_del + e_del * (i + 1)), NEG)
        tcode = target[:, i:i + 1]
        sub = torch.where(q_is_n | (tcode >= 4), n_sc,
                          torch.where(qc == tcode, match_sc, mismatch_sc))
        M = eh_h[:, :Lq] + sub
        E = eh_e[:, :Lq]
        run = torch.cummax(
            torch.where(band, (M - gapoe_ins) + jr * e_ins, NEG), dim=1).values
        F = torch.cat([negcol, run[:, :-1] - jr[:, :-1] * e_ins], dim=1)
        F = torch.where(jr == beg, NEG, F)
        F = torch.maximum(F, NEG - (jr - beg) * e_ins)
        d = torch.where(M >= E, 0, 1)
        h = torch.maximum(M, E)
        d = torch.where(h >= F, d, 2)
        h = torch.maximum(h, F)
        e_ext = E - e_del
        e_open = M - gapoe_del
        d = d | (torch.where(e_ext > e_open, 1, 0) << 2)
        f_ext = F - e_ins
        f_open = M - gapoe_ins
        d = d | (torch.where(f_ext > f_open, 2, 0) << 4)
        z[:, i, :] = torch.where(band & in_row, d, 0).to(torch.uint8)
        h_shift = torch.cat([torch.zeros_like(negcol), h], dim=1)
        eh_h_n = torch.where((jid1 > beg) & (jid1 <= end), h_shift, eh_h)
        eh_h_n = torch.where(jid1 == beg, h1_init, eh_h_n)
        e_pad = torch.cat([torch.maximum(e_ext, e_open), negcol], dim=1)
        eh_e_n = torch.where((jid1 >= beg) & (jid1 < end), e_pad, eh_e)
        eh_e_n = torch.where(jid1 == end, NEG, eh_e_n)
        eh_h = torch.where(in_row, eh_h_n, eh_h)
        eh_e = torch.where(in_row, eh_e_n, eh_e)
    # score = eh_h[qlen] (holds H(tlen-1, qlen-1))
    score = eh_h.gather(1, torch.clamp(qlen, 0, Lq)[:, None].long())[:, 0]
    score = torch.where(qlen <= Lq, score, NEG).to(i32)
    return score, z


def global_batch(query: torch.Tensor, qlen: torch.Tensor,
                 target: torch.Tensor, tlen: torch.Tensor, w: torch.Tensor,
                 *, o_del: int = 6, e_del: int = 1, o_ins: int = 6,
                 e_ins: int = 1, match_sc: int = 1, mismatch_sc: int = -4,
                 n_sc: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2: banded global DP for a batch -> (score (B,) int32, z (B, Lt, Lq)
    uint8). query/target integer codes; qlen, tlen, w (B,) int32."""
    kw = dict(o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
              match_sc=match_sc, mismatch_sc=mismatch_sc, n_sc=n_sc)
    if not _build.on_cuda(query):
        return global_batch_plain(query, qlen, target, tlen, w, **kw)
    dev = query.device
    B, Lq = query.shape
    Lt = target.shape[1]
    _build.check("query", query, dev, (B, Lq), _build.CODE_DTYPES)
    _build.check("target", target, dev, (B, Lt), _build.CODE_DTYPES)
    for name, v in (("qlen", qlen), ("tlen", tlen), ("w", w)):
        _build.check(name, v, dev, (B,))
    _build.check_byte_scores(match_sc=match_sc, mismatch_sc=mismatch_sc,
                             n_sc=n_sc)
    q8 = query.to(torch.uint8).contiguous()
    t8 = target.to(torch.uint8).contiguous()
    # row boundaries between column tiles, used only past one tile
    bnd = torch.empty((B, Lt, 2) if Lq > _build.TILE_COLS else (1, 2),
                      dtype=torch.int32, device=dev)
    score = torch.empty((B,), dtype=torch.int32, device=dev)
    z = torch.empty((B, Lt, Lq), dtype=torch.uint8, device=dev)
    _build.launch("sw_global", q8, t8, qlen, tlen, w, B, Lq, Lt, o_del,
                  e_del, o_ins, e_ins, match_sc, mismatch_sc, n_sc, bnd,
                  score, z, size=B)
    return score, z


def _i32_bytes(x: torch.Tensor) -> torch.Tensor:
    """(B,) int32 -> (B, 4) uint8, little-endian."""
    return x.to(torch.int32).contiguous().view(torch.uint8).reshape(-1, 4)


def traceback_ops_fused_plain(z: torch.Tensor, qlen: torch.Tensor,
                              tlen: torch.Tensor, w: torch.Tensor,
                              score: torch.Tensor, S: int) -> torch.Tensor:
    """Plain twin of K2b on the tensors' device -> (B, S//4 + 12) uint8:
    the walk's ops packed four to a byte, then score, i_fin, k_fin."""
    if S % 4:
        raise ValueError("S must be a multiple of 4")
    dev = z.device
    B, Lt, Lq = z.shape
    zflat = z.reshape(B, Lt * Lq).to(torch.int32)
    i = tlen.to(torch.int32) - 1
    k = torch.minimum(i + w.to(torch.int32) + 1, qlen.to(torch.int32)) - 1
    which = torch.zeros_like(i)
    ops = torch.full((B, S), 3, dtype=torch.int32, device=dev)
    for s in range(S):
        active = (i >= 0) & (k >= 0)
        cell = torch.clamp(i, 0, Lt - 1) * Lq + torch.clamp(k, 0, Lq - 1)
        d = zflat.gather(1, cell[:, None].long())[:, 0]
        wn = (d >> (which << 1)) & 3
        op = torch.where(wn == 0, 0, torch.where(wn == 1, 2, 1))
        ops[:, s] = torch.where(active, op, 3)
        i = torch.where(active, i - (wn != 2).to(torch.int32), i)
        k = torch.where(active, k - (wn != 1).to(torch.int32), k)
        which = torch.where(active, wn, which)
    p = ops.reshape(B, S // 4, 4)
    packed = (p[:, :, 0] | (p[:, :, 1] << 2) | (p[:, :, 2] << 4)
              | (p[:, :, 3] << 6)).to(torch.uint8)
    return torch.cat([packed, _i32_bytes(score), _i32_bytes(i),
                      _i32_bytes(k)], dim=1)


def traceback_ops_fused(z: torch.Tensor, qlen: torch.Tensor,
                        tlen: torch.Tensor, w: torch.Tensor,
                        score: torch.Tensor, S: int,
                        windows: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """K2b: backtrack every task of a K2 wave -> (B, S//4 + 12) uint8 blob
    (``split_traceback_blob`` unpacks it). Needs S % 4 == 0 and
    S >= Lt + Lq. On the card z must be contiguous, as ``global_batch``
    returns it.

    ``windows``, a (B,) int32 CUDA tensor, gets the windows of z each
    task's warp staged in shared memory (the kernel's own count; the twin
    has no windows, so a CPU call takes none)."""
    if not _build.on_cuda(z):
        if windows is not None:
            raise ValueError("windows are counted by the kernel, on a CUDA "
                             "tensor")
        return traceback_ops_fused_plain(z, qlen, tlen, w, score, S)
    dev = z.device
    B, Lt, Lq = z.shape
    if S % 4 or S < Lt + Lq:
        raise ValueError(f"S={S}: need S % 4 == 0 and S >= Lt + Lq")
    if z.dtype != torch.uint8 or not z.is_contiguous():
        raise ValueError("z must be a contiguous uint8 (B, Lt, Lq) tensor "
                         "(global_batch's)")
    for name, v in (("qlen", qlen), ("tlen", tlen), ("w", w),
                    ("score", score)):
        _build.check(name, v, dev, (B,))
    if windows is not None:
        _build.check("windows", windows, dev, (B,))
    blob = torch.empty((B, S // 4 + 12), dtype=torch.uint8, device=dev)
    _build.launch("traceback", z, qlen, tlen, w, score, B, Lt, Lq, S, blob,
                  0 if windows is None else windows, size=B)
    return blob


def split_traceback_blob(blob: np.ndarray, S: int):
    """Host-side unpack of the traceback blob."""
    P = S // 4
    packed = blob[:, :P]
    score = np.ascontiguousarray(blob[:, P:P + 4]).view(np.int32).ravel()
    i_fin = np.ascontiguousarray(blob[:, P + 4:P + 8]).view(np.int32).ravel()
    k_fin = np.ascontiguousarray(blob[:, P + 8:P + 12]).view(np.int32).ravel()
    return packed, score, i_fin, k_fin


def cigars_from_ops_raw(ops: np.ndarray, i_fin: np.ndarray,
                        k_fin: np.ndarray):
    """Native RLE finish of a raw (B, S) op stream (255 = end) ->
    ((B, 2*cap) int32 op/len pairs, nops), the layout Reg2AlnSession.feed
    consumes. None when the native helper is unavailable."""
    B, S = ops.shape
    from ..index.suffix import _load_native
    lib = _load_native()
    if lib is None or not hasattr(lib, "ksw_cigar_from_ops_batch"):
        return None
    o = np.ascontiguousarray(ops, dtype=np.uint8)
    iv = np.asarray(i_fin, dtype=np.int32)
    kv = np.asarray(k_fin, dtype=np.int32)
    cap = S + 2
    cig = np.empty((B, 2 * cap), dtype=np.int32)
    nops = np.empty(B, dtype=np.int32)
    i64 = ctypes.c_int64
    lib.ksw_cigar_from_ops_batch(
        ctypes.c_void_p(o.ctypes.data), i64(B), i64(S),
        ctypes.c_void_p(iv.ctypes.data), ctypes.c_void_p(kv.ctypes.data),
        ctypes.c_void_p(cig.ctypes.data), i64(cap),
        ctypes.c_void_p(nops.ctypes.data))
    return cig, nops


def cigars_from_ops_packed(packed: np.ndarray, i_fin: np.ndarray,
                           k_fin: np.ndarray, S: int):
    """Native RLE finish of the bit-packed (B, S//4) op stream. None
    without the native library."""
    B = packed.shape[0]
    from ..index.suffix import _load_native
    lib = _load_native()
    if lib is None or not hasattr(lib, "ksw_cigar_from_ops_packed_batch"):
        return None
    o = np.ascontiguousarray(packed, dtype=np.uint8)
    iv = np.asarray(i_fin, dtype=np.int32)
    kv = np.asarray(k_fin, dtype=np.int32)
    cap = S + 2
    cig = np.empty((B, 2 * cap), dtype=np.int32)
    nops = np.empty(B, dtype=np.int32)
    i64 = ctypes.c_int64
    lib.ksw_cigar_from_ops_packed_batch(
        ctypes.c_void_p(o.ctypes.data), i64(B), i64(S),
        ctypes.c_void_p(iv.ctypes.data), ctypes.c_void_p(kv.ctypes.data),
        ctypes.c_void_p(cig.ctypes.data), i64(cap),
        ctypes.c_void_p(nops.ctypes.data))
    return cig, nops


def unpack_ops(packed: np.ndarray, S: int) -> np.ndarray:
    """K2b's (B, S//4) packed ops (four to a byte, first op in the low
    bits) -> the (B, S) uint8 op stream of an unpacked walk: 0 M, 1 I, 2 D,
    and 255 from the walk's end on (the packed 3)."""
    p = np.asarray(packed, dtype=np.uint8)
    ops = ((p[:, :, None] >> np.array([0, 2, 4, 6], np.uint8)) & 3).reshape(
        p.shape[0], S)
    ops[ops == 3] = 255
    return ops


def cigars_from_ops(ops: np.ndarray, i_fin: np.ndarray, k_fin: np.ndarray
                    ) -> List[List[Tuple[int, int]]]:
    """Host finish of the walk: each task's ops RLE-merged with the
    cursors' tails, reversed into a CIGAR of (op, len) pairs. Through the
    native helper when it is built, else in Python."""
    B, S = ops.shape
    raw = cigars_from_ops_raw(ops, i_fin, k_fin)
    if raw is not None:
        cig, nops = raw
        out = []
        for b in range(B):
            n = int(nops[b])
            flat = cig[b, :2 * n].tolist()
            out.append(list(zip(flat[0::2], flat[1::2])))
        return out
    out = []
    for b in range(B):
        cigar: List[Tuple[int, int]] = []

        def push(op, ln):
            if cigar and cigar[-1][0] == op:
                cigar[-1] = (op, cigar[-1][1] + ln)
            else:
                cigar.append((op, ln))

        for s in range(S):
            v = int(ops[b, s])
            if v == 255:
                break
            push(v, 1)
        if int(i_fin[b]) >= 0:
            push(2, int(i_fin[b]) + 1)
        if int(k_fin[b]) >= 0:
            push(1, int(k_fin[b]) + 1)
        cigar.reverse()
        out.append([tuple(c) for c in cigar])
    return out
