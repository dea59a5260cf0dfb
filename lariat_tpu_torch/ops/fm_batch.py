"""The device FM index and the plain PyTorch twins of its rank queries --
the port of lariat_tpu/ops/fm_batch.py (the parts device seeding runs).

The index lives on the device as one fused table: (n_blocks+1, 12) uint32
rows ``[ckpt 0..3 | 8 bwt words]``, the rank checkpoints before each
128-base block and the block's 2-bit codes (base 0 in the high bits). One
row gather serves both the rank base and the in-block count. torch has no
shifts or compares on uint32, so the table is held as int32 (the same
bits) and every gathered row is widened with ``.long() & 0xFFFFFFFF``.

The twins below (``occ4_fused_batch``, ``bwt_extend_dir_batch``,
``bwt_extend_batch``, ``lf_batch``, ``occ1_batch``, ``backward_ext_batch``)
are the reference's functions on torch tensors; the CUDA kernels of
``smem_device``, ``parallel.align_step`` and the exact match below run the
same arithmetic per thread (``csrc/fm.cuh``, K6).

K7 (``csrc/exact_match.cu``) is the batched backward search:
``backward_search`` (and the reference's ``exact_match_batch`` over it)
launches it on a CUDA tensor and runs ``backward_search_plain`` on a CPU
tensor; ``occ1_rank`` does the same for its single-rank entry.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional, Tuple

import numpy as np
import torch

from ..index.fmindex import OCC_INTERVAL
from . import _build

WORDS_PER_BLOCK = OCC_INTERVAL // 16  # 8
_M32 = 0xFFFFFFFF


def fused_table(fm) -> np.ndarray:
    """(n_blocks+1, 12) uint32 fused occ rows of the host index.

    A copy of lariat_tpu/ops/fm_batch.py ``_fused_table`` (which imports
    jax): the same bytes, and the same ``fused.npy`` cache in the index's
    ``.lariat.d`` dir, so the two packages share the file."""
    d = getattr(fm, "_dir", None)
    path = os.path.join(d, "fused.npy") if d else None
    if path and os.path.exists(path):
        return np.load(path, mmap_mode="r")
    n = len(fm.bwt_codes)
    n_blocks = (n + OCC_INTERVAL - 1) // OCC_INTERVAL
    fused = np.zeros((n_blocks + 1, 12), dtype=np.uint32)
    fused[:, :4] = fm.occ_ckpt
    fused[:n_blocks, 4:] = np.asarray(
        fm.packed_words)[:n_blocks * WORDS_PER_BLOCK].reshape(
            n_blocks, WORDS_PER_BLOCK)
    if path:
        try:
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                np.save(f, fused)
            os.replace(tmp, path)
        except OSError:
            pass
    return fused


@dataclasses.dataclass
class DeviceFMIndex:
    fused: torch.Tensor   # (n_blocks+1, 12) int32: the uint32 rows' bits
    L2: torch.Tensor      # (5,) cumulative code counts, in the index dtype
    primary: int
    seq_len: int

    @classmethod
    def from_numpy(cls, fused: np.ndarray, L2: np.ndarray, primary: int,
                   seq_len: int, device) -> "DeviceFMIndex":
        """From host arrays: the fused uint32 table and L2, whose dtype
        (int32 or int64) becomes the index dtype."""
        fused = np.ascontiguousarray(fused, dtype=np.uint32).view(np.int32)
        L2 = np.asarray(L2)
        if L2.dtype not in (np.int32, np.int64) or L2.shape != (5,):
            raise ValueError(f"L2 must be (5,) int32 or int64, got "
                             f"{L2.dtype} {L2.shape}")
        return cls(fused=torch.from_numpy(fused.copy()).to(device),
                   L2=torch.from_numpy(L2.copy()).to(device),
                   primary=int(primary), seq_len=int(seq_len))

    @classmethod
    def from_host(cls, fm, device) -> "DeviceFMIndex":
        # int32 rows while the doubled text fits, else int64
        dt = np.int32 if fm.seq_len + 2 < 2**31 else np.int64
        return cls.from_numpy(fused_table(fm), fm.L2.astype(dt), fm.primary,
                              fm.seq_len, device)

    @property
    def idx_dtype(self) -> torch.dtype:
        return self.L2.dtype

    @property
    def device(self) -> torch.device:
        return self.fused.device


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int64 values in [0, 2**32) (SWAR; torch has no
    popcount)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def _rows(fmd: DeviceFMIndex, blk: torch.Tensor) -> torch.Tensor:
    """Fused rows ``blk`` as int64 in [0, 2**32): (..., 12)."""
    return fmd.fused[blk].long() & _M32


def _keep_mask(rem: torch.Tensor) -> torch.Tensor:
    """(..., 8) masks of the first ``rem`` bases of a block, per word: the
    top 2*nvalid bits, nvalid = clamp(rem - 16*word, 0, 16)."""
    word_base = torch.arange(WORDS_PER_BLOCK, device=rem.device) * 16
    nvalid = torch.clamp(rem[..., None] - word_base, 0, 16)
    shift = 32 - 2 * nvalid
    return torch.where(nvalid > 0, ((_M32 >> shift) << shift) & _M32, 0)


def _match(words: torch.Tensor, c) -> torch.Tensor:
    """Per 2-bit field of ``words``: its low bit set iff the field == c."""
    y = words ^ (c * 0x55555555)
    return ~(y | (y >> 1)) & 0x55555555


def occ4_fused_batch(fmd: DeviceFMIndex, k: torch.Tensor) -> torch.Tensor:
    """Counts of each code in BWT rows [0..k] (sentinel-adjusted): (..., 4)
    in the index dtype. k in [-1, seq_len]: k < 0 gives 0, k == seq_len
    the totals."""
    k = k.long()
    kk = torch.where(k >= fmd.primary, k - 1, k)
    kk = torch.clamp(kk, 0, fmd.seq_len - 1)
    blk = (kk + 1) // OCC_INTERVAL
    rem = (kk + 1) % OCC_INTERVAL
    row = _rows(fmd, blk)
    words = row[..., 4:]
    keep = _keep_mask(rem)
    inblock = torch.stack(
        [_popcount32(_match(words, c) & keep).sum(-1) for c in range(4)],
        dim=-1)
    out = row[..., :4] + inblock
    L2 = fmd.L2.long()
    out = torch.where((k == fmd.seq_len)[..., None], L2[1:5] - L2[0:4], out)
    out = torch.where((k < 0)[..., None], 0, out)
    return out.to(fmd.idx_dtype)


def rank_rows(fmd: DeviceFMIndex, qpos: torch.Tensor, s: torch.Tensor,
              need: Optional[torch.Tensor] = None,
              touched: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused rows one bidirectional extension reads (where ``need``): its
    occ4 ranks at qpos - 1 and qpos - 1 + s, where a rank at k < 0 or k ==
    seq_len reads none and two ranks in one block read that row once ->
    (...) int64 in 0..2. ``touched``, a bool per fused row, gets the rows
    read set: the distinct rows, each read once, are the index bytes that
    bound a seeding kernel."""
    def at(k):
        kk = torch.where(k >= fmd.primary, k - 1, k)
        kk = torch.clamp(kk, 0, fmd.seq_len - 1)
        return (k >= 0) & (k != fmd.seq_len), (kk + 1) // OCC_INTERVAL

    qpos, s = qpos.long(), s.long()
    la, ba = at(qpos - 1)
    lb, bb = at(qpos - 1 + s)
    if need is not None:
        la, lb = la & need, lb & need
    if touched is not None:
        touched[ba[la]] = True
        touched[bb[lb]] = True
    return la.long() + (lb & ~(la & (ba == bb))).long()


def lf_row(fmd: DeviceFMIndex, k: torch.Tensor) -> torch.Tensor:
    """The fused row ``lf_batch`` reads for row k (k != primary)."""
    k = k.long()
    return torch.where(k > fmd.primary, k - 1, k) // OCC_INTERVAL


def _extend_all(fmd: DeviceFMIndex, qpos: torch.Tensor, other_base:
                torch.Tensor, s: torch.Tensor):
    """(starts, others, sizes), each (..., 4) int64: the query-side start,
    the other side's start and the size after extending by each code."""
    tk = occ4_fused_batch(fmd, qpos - 1).long()
    tl = occ4_fused_batch(fmd, qpos - 1 + s).long()
    sizes = tl - tk
    starts = fmd.L2[:4].long() + 1 + tk
    crosses = ((qpos <= fmd.primary)
               & (qpos + s - 1 >= fmd.primary)).long()
    # other-side start of code c: other_base + crosses + sizes of codes > c
    o3 = other_base + crosses
    o2 = o3 + sizes[..., 3]
    o1 = o2 + sizes[..., 2]
    o0 = o1 + sizes[..., 1]
    return starts, torch.stack([o0, o1, o2, o3], dim=-1), sizes


def bwt_extend_dir_batch(fmd: DeviceFMIndex, x0: torch.Tensor,
                         x1: torch.Tensor, s: torch.Tensor, c: torch.Tensor,
                         is_back: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-lane bidirectional extension by read code c (0..3): prepend
    where ``is_back``, else append (by the complement internally). Returns
    the extended (x0, x1, s) in the index dtype."""
    x0, x1, s = x0.long(), x1.long(), s.long()
    qpos = torch.where(is_back, x0, x1)
    other_base = torch.where(is_back, x1, x0)
    ce = torch.where(is_back, c.long(), 3 - c.long())[..., None]
    starts, others, sizes = _extend_all(fmd, qpos, other_base, s)
    st = starts.gather(-1, ce)[..., 0]
    ot = others.gather(-1, ce)[..., 0]
    ns = sizes.gather(-1, ce)[..., 0]
    dt = fmd.idx_dtype
    return (torch.where(is_back, st, ot).to(dt),
            torch.where(is_back, ot, st).to(dt), ns.to(dt))


def bwt_extend_batch(fmd: DeviceFMIndex, x0: torch.Tensor, x1: torch.Tensor,
                     s: torch.Tensor, is_back: bool
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Extension by all four codes: (ok0, ok1, oks), each (..., 4) in the
    index dtype, indexed by the rank-query code like the host
    ``seeding.bwt_extend``."""
    x0, x1, s = x0.long(), x1.long(), s.long()
    starts, others, sizes = _extend_all(
        fmd, x0 if is_back else x1, x1 if is_back else x0, s)
    dt = fmd.idx_dtype
    if is_back:
        return starts.to(dt), others.to(dt), sizes.to(dt)
    return others.to(dt), starts.to(dt), sizes.to(dt)


def lf_batch(fmd: DeviceFMIndex, k: torch.Tensor) -> torch.Tensor:
    """LF mapping of rows k (k != primary; callers mask that row to 0), in
    the index dtype."""
    k = k.long()
    kx = torch.where(k > fmd.primary, k - 1, k)
    blk = kx // OCC_INTERVAL
    pos = kx % OCC_INTERVAL
    row = _rows(fmd, blk)
    words = row[..., 4:]
    word = words.gather(-1, (pos // 16)[..., None])[..., 0]
    c = (word >> ((15 - pos % 16) * 2)) & 3
    base = row[..., :4].gather(-1, c[..., None])[..., 0]
    inblock = _popcount32(_match(words, c[..., None])
                          & _keep_mask(pos + 1)).sum(-1)
    return (fmd.L2.long()[c] + base + inblock).to(fmd.idx_dtype)


def occ1_batch(fmd: DeviceFMIndex, k: torch.Tensor,
               c: torch.Tensor) -> torch.Tensor:
    """Count of code c (0..3) in BWT rows [0..k] (sentinel-adjusted), per
    lane, in the index dtype: k in [-1, seq_len], k < 0 gives 0, k ==
    seq_len the total of c."""
    k, c = k.long(), c.long()
    kk = torch.where(k >= fmd.primary, k - 1, k)
    kk = torch.clamp(kk, 0, fmd.seq_len - 1)
    row = _rows(fmd, (kk + 1) // OCC_INTERVAL)
    base = row[..., :4].gather(-1, c[..., None])[..., 0]
    inblock = _popcount32(_match(row[..., 4:], c[..., None])
                          & _keep_mask((kk + 1) % OCC_INTERVAL)).sum(-1)
    L2 = fmd.L2.long()
    out = torch.where(k == fmd.seq_len, L2[c + 1] - L2[c], base + inblock)
    return torch.where(k < 0, 0, out).to(fmd.idx_dtype)


def backward_ext_batch(fmd: DeviceFMIndex, k: torch.Tensor, l: torch.Tensor,
                       c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One backward-search step of the inclusive intervals [k, l] by code c
    (0..3): (L2[c] + occ1(k - 1, c) + 1, L2[c] + occ1(l, c)), in the index
    dtype."""
    k, l, c = k.long(), l.long(), c.long()
    l2c = fmd.L2.long()[c]
    dt = fmd.idx_dtype
    return ((l2c + occ1_batch(fmd, k - 1, c).long() + 1).to(dt),
            (l2c + occ1_batch(fmd, l, c).long()).to(dt))


def occ1_rank(fmd: DeviceFMIndex, k: torch.Tensor,
              c: torch.Tensor) -> torch.Tensor:
    """``occ1_batch`` of (n,) rows k (index dtype) and codes c (int32): K7's
    single-rank entry on a CUDA tensor, the twin on a CPU tensor."""
    if not _build.on_cuda(k):
        return occ1_batch(fmd, k, c)
    dev, n, dt = k.device, int(k.shape[0]), fmd.idx_dtype
    _build.check("k", k, dev, (n,), (dt,))
    _build.check("c", c, dev, (n,))
    out = torch.empty(n, dtype=dt, device=dev)
    _build.launch("exact_match", k, c, fmd.fused, fmd.L2, fmd.primary,
                  fmd.seq_len, int(dt == torch.int64), n, out, size=n,
                  entry="lariat_occ1")
    return out


def backward_search_plain(fmd: DeviceFMIndex, reads: torch.Tensor,
                          lens: torch.Tensor,
                          start: Optional[torch.Tensor] = None,
                          max_iters: Optional[int] = None,
                          skip_n: bool = False,
                          touched: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K7, every lane in lock step as in the reference;
    ``touched`` (a bool per fused row) gets the rows its ranks read set.
    With ``start``, the base at p is N unless start <= p < lens: the
    reference align step's seed mask, applied where the base is read."""
    B, L = reads.shape
    lens = lens.long()
    span = lens if start is None else lens - start.long()
    n_iters = L if max_iters is None else min(L, max_iters)
    k = torch.zeros(B, dtype=torch.int64, device=reads.device)
    l = torch.full((B,), fmd.seq_len, dtype=torch.int64, device=reads.device)
    for t in range(min(n_iters, int(span.max()) if B else 0)):
        idx = torch.clamp(lens - 1 - t, 0, L - 1)
        c = reads.gather(1, idx[:, None])[:, 0].long()
        if start is not None:
            c = torch.where((idx >= start.long()) & (idx < lens), c, 4)
        in_span = t < span
        active = in_span & (k <= l) & (c < 4)
        if touched is not None:
            rank_rows(fmd, k, l - k + 1, active, touched)
        nk, nl = (v.long() for v in backward_ext_batch(fmd, k, l,
                                                       c.clamp(0, 3)))
        k = torch.where(active, nk, k)
        if not skip_n:
            nl = torch.where(in_span & (c >= 4), k - 1, nl)
            active = active | (in_span & (c >= 4))
        l = torch.where(active, nl, l)
    return k.to(fmd.idx_dtype), l.to(fmd.idx_dtype)


def backward_search(fmd: DeviceFMIndex, reads: torch.Tensor,
                    lens: torch.Tensor, start: Optional[torch.Tensor] = None,
                    max_iters: Optional[int] = None, skip_n: bool = False,
                    steps: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7: the backward search of reads[start:lens) (start None: the whole
    read), at most ``max_iters`` steps -> (k, l) inclusive intervals in the
    index dtype, empty when k > l. reads (B, L) codes 0..4, lens and start
    (B,); with ``start`` the bases outside [start, lens) read as N (the
    seed mask), so the caller passes the reads unmasked. An N empties the
    interval, or with ``skip_n`` is skipped. ``steps``, a (B,) int32 CUDA
    tensor, gets each read's rank steps (the kernel's own count)."""
    if not _build.on_cuda(reads):
        if steps is not None:
            raise ValueError("steps are counted by the kernel, on a CUDA "
                             "tensor")
        return backward_search_plain(fmd, reads, lens, start, max_iters,
                                     skip_n)
    dev = reads.device
    B, L = reads.shape
    _build.check("reads", reads, dev, (B, L), _build.CODE_DTYPES)
    lens = lens.to(dev, torch.int32).contiguous()
    if start is not None:
        start = start.to(dev, torch.int32).contiguous()
    if steps is not None:
        _build.check("steps", steps, dev, (B,))
    dt = fmd.idx_dtype
    out = torch.empty((2, B), dtype=dt, device=dev)
    _build.launch("exact_match", reads.to(torch.uint8).contiguous(),
                  0 if start is None else start, lens, fmd.fused, fmd.L2,
                  fmd.primary, fmd.seq_len, int(dt == torch.int64), B, L,
                  L if max_iters is None else min(L, max_iters),
                  int(skip_n), out, 0 if steps is None else steps, size=B)
    return out[0], out[1]


def exact_match_batch(fmd: DeviceFMIndex, reads: torch.Tensor,
                      lens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-read exact match (K7, an N empties the interval): reads (B, L)
    codes 0..4, lens (B,) -> (k, l), empty when k > l."""
    return backward_search(fmd, reads, lens)
