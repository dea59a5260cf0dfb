"""K1: batched banded seed extension (ksw_extend2) -- the wrapper of
``csrc/sw_extend.cu`` and the port of lariat_tpu/ops/sw_extend_pallas.py
``extend_batch_pallas`` (v1 and v2 compute the same function).

The kernel has three entries, counted as one kernel (``sw_extend``):
``extend_batch`` takes (B, Lq) / (B, Lt) code tiles, ``extend_desc``
takes a wave's descriptor matrix and lets the kernel gather its own inputs,
and ``extend_step`` takes the align step's reads and hits and lets the
kernel orient the reads and stage the windows. A CUDA tensor launches the
kernel; a CPU tensor runs the plain twin ``sw_batch.extend_batch`` (after
``resident.build_qt`` for the descriptor entry, and the window fetch and
the orientation for the step entry). The result is the (8, B) int32 block
of the Pallas entry with ``packed=True``: rows score, qle, tle, gtle,
gscore, max_off, then two zero rows.

Each entry takes ``steps``, a (B,) int32 CUDA tensor that the kernel
fills with each task's warp steps (its column tiles' summed): the kernel's
own count of what its schedule ran. The twin has no schedule, so a CPU call
takes no ``steps``.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build, sw_batch


def score_matrix(match_sc: int, mismatch_sc: int, n_sc: int,
                 device=None) -> torch.Tensor:
    """bwa's uniform (5, 5) matrix: match / mismatch on A,C,G,T, n_sc on N."""
    mat = torch.full((5, 5), n_sc, dtype=torch.int32, device=device)
    mat[:4, :4] = mismatch_sc
    mat[:4, :4].fill_diagonal_(match_sc)
    return mat


def boundary_scratch(B: int, Lq: int, Lt: int,
                     device: torch.device) -> torch.Tensor:
    """The row boundaries between K1's column tiles: (B, Lt, 4) int32 past
    one tile of query columns, else one unused element."""
    shape = (B, Lt, 4) if Lq > _build.EXTEND_TILE_COLS else (1, 4)
    return torch.empty(shape, dtype=torch.int32, device=device)


def _plain(query, qlen, target, tlen, w, h0, steps, *, o_del, e_del, o_ins,
           e_ins, end_bonus, zdrop, match_sc, mismatch_sc, n_sc):
    if steps is not None:
        raise ValueError("steps are counted by the kernel, on a CUDA tensor")
    rows = sw_batch.extend_batch(
        query, qlen, target, tlen, score_matrix(match_sc, mismatch_sc, n_sc),
        w, h0, o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
        end_bonus=end_bonus, zdrop=zdrop, packed=True)
    return torch.cat([rows, torch.zeros((2, qlen.shape[0]),
                                        dtype=torch.int32,
                                        device=rows.device)])


def _launch(B, Lq, Lt, dev, scores, steps, entry, *head) -> torch.Tensor:
    """Check the scores and ``steps``, then launch ``entry`` of K1 with
    ``head`` (the entry's arguments before the scoring) -> (8, B)."""
    _build.check_byte_scores(match_sc=scores["match_sc"],
                             mismatch_sc=scores["mismatch_sc"],
                             n_sc=scores["n_sc"])
    if steps is not None:
        _build.check("steps", steps, dev, (B,))
    out = torch.empty((8, B), dtype=torch.int32, device=dev)
    _build.launch("sw_extend", *head, *(scores[k] for k in (
        "o_del", "e_del", "o_ins", "e_ins", "end_bonus", "zdrop", "match_sc",
        "mismatch_sc", "n_sc")), boundary_scratch(B, Lq, Lt, dev), out,
        0 if steps is None else steps, size=B, entry=entry)
    return out


def extend_batch(query: torch.Tensor, qlen: torch.Tensor,
                 target: torch.Tensor, tlen: torch.Tensor, w: torch.Tensor,
                 h0: torch.Tensor, *, o_del: int = 6, e_del: int = 1,
                 o_ins: int = 6, e_ins: int = 1, end_bonus: int = 5,
                 zdrop: int = 100, match_sc: int = 1, mismatch_sc: int = -4,
                 n_sc: int = -1,
                 steps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ksw_extend2 over a task batch -> (8, B) int32.

    query (B, Lq) and target (B, Lt) integer codes 0..4, task-major; qlen,
    tlen, w, h0 (B,) int32 with qlen <= Lq and tlen <= Lt."""
    sc = dict(o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
              end_bonus=end_bonus, zdrop=zdrop, match_sc=match_sc,
              mismatch_sc=mismatch_sc, n_sc=n_sc)
    B, Lq = query.shape
    Lt = target.shape[1]
    if not _build.on_cuda(query):
        return _plain(query, qlen, target, tlen, w, h0, steps, **sc)
    dev = query.device
    _build.check("query", query, dev, (B, Lq), _build.CODE_DTYPES)
    _build.check("target", target, dev, (B, Lt), _build.CODE_DTYPES)
    for name, v in (("qlen", qlen), ("tlen", tlen), ("w", w), ("h0", h0)):
        _build.check(name, v, dev, (B,))
    q8 = query.to(torch.uint8).contiguous()
    t8 = target.to(torch.uint8).contiguous()
    return _launch(B, Lq, Lt, dev, sc, steps, None, q8, t8, qlen, tlen, w,
                   h0, B, Lq, Lt)


def extend_desc(reads: torch.Tensor, pac_words: torch.Tensor, l_pac: int,
                desc: torch.Tensor, Lq: int, Lt: int, *, o_del: int = 6,
                e_del: int = 1, o_ins: int = 6, e_ins: int = 1,
                end_bonus: int = 5, zdrop: int = 100, match_sc: int = 1,
                mismatch_sc: int = -4, n_sc: int = -1,
                steps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ksw_extend2 over a wave of descriptors -> (8, B) int32, the result of
    ``extend_batch`` on ``resident.build_qt``'s tiles.

    On a CUDA tensor this is one launch of the descriptor entry, which
    gathers its own query columns and target codes as ``build_qt`` does.
    reads (N, L) uint8, pac_words int32, desc (B, 9) int32 or int64
    (``resident.pack_desc``); Lq and Lt cap the tasks' qlen and tlen."""
    from . import resident  # resident imports this module
    sc = dict(o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
              end_bonus=end_bonus, zdrop=zdrop, match_sc=match_sc,
              mismatch_sc=mismatch_sc, n_sc=n_sc)
    if not _build.on_cuda(desc):
        q, t = resident.build_qt(reads, pac_words, l_pac, desc, Lq, Lt)
        qlen, tlen, w, h0 = (desc[:, k].to(torch.int32).contiguous()
                             for k in (resident.D_QL, resident.D_TL,
                                       resident.D_W, resident.D_H0))
        return _plain(q, qlen, t, tlen, w, h0, steps, **sc)
    dev = desc.device
    B = desc.shape[0]
    _build.check("desc", desc, dev, (B, 9), (torch.int32, torch.int64))
    if reads.dim() != 2:
        raise ValueError(f"reads: shape {tuple(reads.shape)}, expected "
                         f"(N, L)")
    _build.check("reads", reads, dev, tuple(reads.shape), (torch.uint8,))
    _build.check("pac_words", pac_words, dev, tuple(pac_words.shape))
    N, L = reads.shape
    return _launch(B, Lq, Lt, dev, sc, steps, "lariat_sw_extend_desc", desc,
                   int(desc.dtype == torch.int64), reads, N, L, pac_words,
                   int(l_pac), B, Lq, Lt)


def orient_reads(reads: torch.Tensor, lens: torch.Tensor,
                 is_rev: torch.Tensor) -> torch.Tensor:
    """(B, L) uint8 reads oriented to the forward strand: the reverse
    complement of reads[b, :lens[b]] (N stays N, 4 past lens) where
    is_rev[b], else the read as it is."""
    B, L = reads.shape
    idx = torch.arange(L, device=reads.device)[None, :]
    ln = lens.long()[:, None]
    rc = reads.gather(1, torch.clamp(ln - 1 - idx, 0, L - 1)).long()
    revcomp = torch.where(idx < ln, torch.where(rc < 4, 3 - rc, 4), 4)
    return torch.where(is_rev[:, None], revcomp,
                       reads.long()).to(torch.uint8)


def extend_step_plain(reads: torch.Tensor, lens: torch.Tensor,
                      fwd_start: torch.Tensor, is_rev: torch.Tensor,
                      pac_words: torch.Tensor, l_pac: int, window: int, *,
                      h0: int = 19, o_del: int = 6, e_del: int = 1,
                      o_ins: int = 6, e_ins: int = 1, end_bonus: int = 5,
                      zdrop: int = 100, match_sc: int = 1,
                      mismatch_sc: int = -4, n_sc: int = -1
                      ) -> torch.Tensor:
    """Plain twin of K1's step entry: the window fetch (K8's twin), the
    orientation and ``sw_batch.extend_batch``, as the reference align step
    runs them."""
    from . import resident  # resident imports this module
    B, L = reads.shape
    target = resident.fetch_forward_batch(pac_words, l_pac, fwd_start,
                                          L + window)
    query = orient_reads(reads, lens, is_rev)

    def full(v):
        return torch.full((B,), v, dtype=torch.int32, device=reads.device)

    return _plain(query, lens.to(torch.int32), target, full(L + window),
                  full(window), full(h0), None, match_sc=match_sc,
                  mismatch_sc=mismatch_sc, n_sc=n_sc, o_del=o_del,
                  e_del=e_del, o_ins=o_ins, e_ins=e_ins,
                  end_bonus=end_bonus, zdrop=zdrop)


def extend_step(reads: torch.Tensor, lens: torch.Tensor,
                fwd_start: torch.Tensor, is_rev: torch.Tensor,
                pac_words: torch.Tensor, l_pac: int, window: int, *,
                h0: int = 19, o_del: int = 6, e_del: int = 1, o_ins: int = 6,
                e_ins: int = 1, end_bonus: int = 5, zdrop: int = 100,
                match_sc: int = 1, mismatch_sc: int = -4, n_sc: int = -1,
                steps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ksw_extend2 of each whole read, oriented to its hit's strand, against
    the forward-strand window [fwd_start, fwd_start + L + window) (4 outside
    [0, l_pac)), band ``window``, h0 -> (8, B) int32: the align step's
    extension.

    reads (B, L) uint8 codes 0..4, lens (B,) int32 (qlen min(lens, L)),
    fwd_start (B,) int64, is_rev (B,) bool, pac_words int32 words of the
    forward strand. On a CUDA tensor one launch of the step entry, which
    reads its query columns in place and stages each window from the pac;
    on a CPU tensor ``extend_step_plain``."""
    sc = dict(o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins,
              end_bonus=end_bonus, zdrop=zdrop, match_sc=match_sc,
              mismatch_sc=mismatch_sc, n_sc=n_sc)
    if not _build.on_cuda(reads):
        if steps is not None:
            raise ValueError("steps are counted by the kernel, on a CUDA "
                             "tensor")
        return extend_step_plain(reads, lens, fwd_start, is_rev, pac_words,
                                 l_pac, window, h0=h0, **sc)
    dev = reads.device
    B, L = reads.shape
    _build.check("reads", reads, dev, (B, L), (torch.uint8,))
    _build.check("lens", lens, dev, (B,))
    _build.check("fwd_start", fwd_start, dev, (B,), (torch.int64,))
    _build.check("is_rev", is_rev, dev, (B,), (torch.bool,))
    _build.check("pac_words", pac_words, dev, tuple(pac_words.shape))
    if pac_words.dim() != 1 or l_pac > 16 * pac_words.shape[0]:
        raise ValueError(f"pac_words: {tuple(pac_words.shape)} words cannot "
                         f"hold l_pac {l_pac}")
    Lt = L + window
    return _launch(B, L, Lt, dev, sc, steps, "lariat_sw_extend_step", reads,
                   lens, fwd_start, is_rev, pac_words, int(l_pac), B, L, Lt,
                   int(window), int(h0))
