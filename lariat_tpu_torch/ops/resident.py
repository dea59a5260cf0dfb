"""Device-resident wave feeds: build DP inputs on the device from task
descriptors -- the port of lariat_tpu/ops/resident.py.

A group's encoded reads and the 2-bit pac genome stay on the device; each
wave uploads one (B, 9) descriptor matrix and the q/t tiles are gathered
there:

  query  = reads[rid, qstart + j*qdir]        (slice, optionally reversed)
  target = fmd_code(tstart + i*tdir)          (doubled-text fetch)

Out-of-range positions give code 4 (N); the DP kernels mask by qlen/tlen,
so pad content never matters. The gathers are plain torch ops (XLA ops in
the JAX package, not Pallas). The extend wave on the card does not run
them: kernel K1's descriptor entry makes the same loads itself. K2's waves
(the engine's reg2aln driver) still gather with ``build_qt``.
"""

from __future__ import annotations

import os
import tempfile
from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import sw_extend

# packed task-descriptor layout, shared with the C++ sessions'
# a1s_fill_desc / r2s_fill_desc: [rid, qstart, qdir, qlen, tstart, tdir,
# tlen, h0, w]
D_RID, D_QS, D_QD, D_QL, D_TS, D_TD, D_TL, D_H0, D_W = range(9)


class ResidentReads(NamedTuple):
    codes: torch.Tensor    # (N, L) uint8, 4-padded
    n: int
    L: int


def put_reads(qs: Sequence[np.ndarray], device) -> ResidentReads:
    """Upload a group's encoded reads once (uint8, 4-padded to a 64
    multiple)."""
    N = len(qs)
    L = max((len(q) for q in qs), default=1)
    L = max(-(-L // 64) * 64, 64)
    m = np.full((max(N, 1), L), 4, np.uint8)
    for i, q in enumerate(qs):
        m[i, :len(q)] = q
    return ResidentReads(codes=torch.from_numpy(m).to(device), n=N, L=L)


def pack_desc(rid, qstart, qdir, qlen, tstart, tdir, tlen, h0, w,
              l_pac: int) -> np.ndarray:
    """Stack descriptors into one (B, 9) matrix: int32 while the doubled
    genome coordinate fits, else int64."""
    dt = np.int32 if 2 * l_pac < 2**31 - 2 else np.int64
    return np.stack([np.asarray(a).astype(dt) for a in
                     (rid, qstart, qdir, qlen, tstart, tdir, tlen, h0, w)],
                    axis=1)


def gather_reads(reads: torch.Tensor, rid: torch.Tensor,
                 qstart: torch.Tensor, qdir: torch.Tensor,
                 Lq: int) -> torch.Tensor:
    """(B, Lq) int32 codes of reads[rid, qstart + j*qdir]; out of range
    -> 4."""
    N, L = reads.shape
    j = torch.arange(Lq, dtype=torch.int64, device=reads.device)[None, :]
    pos = qstart.to(torch.int64)[:, None] + j * qdir.to(torch.int64)[:, None]
    inb = (pos >= 0) & (pos < L)
    flat = rid.to(torch.int64)[:, None] * L + torch.clamp(pos, 0, L - 1)
    out = reads.reshape(-1)[flat].to(torch.int32)
    return torch.where(inb, out, 4)


def fetch_fmd_batch(pac_words: torch.Tensor, l_pac: int,
                    tstart: torch.Tensor, tdir: torch.Tensor,
                    Lt: int) -> torch.Tensor:
    """(B, Lt) int32 codes of the doubled (FMD) text at tstart + i*tdir.

    ``pac_words`` holds 16 bases per 32-bit word (base 0 in the high bits)
    as int32: each shift is masked, so the sign bit never leaks. Positions
    >= l_pac mirror through 2*l_pac - 1 - p to the complement strand;
    positions outside [0, 2*l_pac) give 4."""
    i = torch.arange(Lt, dtype=torch.int64, device=pac_words.device)[None, :]
    p = tstart.to(torch.int64)[:, None] + i * tdir.to(torch.int64)[:, None]
    inb = (p >= 0) & (p < 2 * l_pac)
    is_rev = p >= l_pac
    fwd = torch.where(is_rev, 2 * l_pac - 1 - p, p)
    fwd = torch.clamp(fwd, 0, l_pac - 1)
    words = pac_words[fwd >> 4]
    sh = ((15 - (fwd & 15)) * 2).to(torch.int32)
    c = (words >> sh) & 3
    c = torch.where(is_rev, 3 - c, c)
    return torch.where(inb, c, 4).to(torch.int32)


def fetch_forward_batch(pac_words: torch.Tensor, l_pac: int,
                        start: torch.Tensor, length: int) -> torch.Tensor:
    """(B, length) int32 codes of the forward strand at start[b] + i, 4
    outside [0, l_pac) (no mirror); start (B,) may be negative: the plain
    twin of K8 (``csrc/fetch_window.cu``) and of the align step's window."""
    i = torch.arange(length, dtype=torch.int64, device=start.device)
    pos = start.long()[:, None] + i[None, :]
    valid = (pos >= 0) & (pos < l_pac)
    p = torch.clamp(pos, 0, l_pac - 1)
    code = (pac_words[p >> 4] >> ((15 - (p & 15)) * 2).to(torch.int32)) & 3
    return torch.where(valid, code, 4).to(torch.int32)


def pac_words_host(fm) -> np.ndarray:
    """(ceil(l_pac/16),) uint32 forward pac, 16 bases/word (byte 0 in the
    high bits). Copied from lariat_tpu/ops/fm_batch.py (which imports jax),
    disk cache ``pac_words.npy`` in the index dir included."""
    d = getattr(fm, "_dir", None)
    path = os.path.join(d, "pac_words.npy") if d else None
    if path and os.path.exists(path):
        return np.load(path, mmap_mode="r")
    pac = np.asarray(fm.pac)
    padb = (-len(pac)) % 4
    if padb:
        pac = np.concatenate([pac, np.zeros(padb, np.uint8)])
    words = (pac.reshape(-1, 4).astype(np.uint32)
             << np.array([24, 16, 8, 0], np.uint32)).sum(
                 axis=1, dtype=np.uint32)
    if path:
        try:
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                np.save(f, words)
            os.replace(tmp, path)
        except OSError:
            pass
    return words


def pac_words_from_fm(fm, device) -> torch.Tensor:
    """The 2-bit genome as an int32 tensor on ``device`` (the uint32 words
    reinterpreted; torch's CPU build lacks >>, take and > on uint32)."""
    words = np.ascontiguousarray(pac_words_host(fm)).view(np.int32)
    return torch.from_numpy(words.copy()).to(device)


def build_qt(reads: torch.Tensor, pac_words: torch.Tensor, l_pac: int,
             desc: torch.Tensor, Lq: int, Lt: int):
    """A wave's (q, t) int32 tiles from the packed descriptor matrix."""
    q = gather_reads(reads, desc[:, D_RID], desc[:, D_QS], desc[:, D_QD],
                     Lq)
    t = fetch_fmd_batch(pac_words, l_pac, desc[:, D_TS], desc[:, D_TD], Lt)
    return q, t


def extend_wave_resident(reads: torch.Tensor, pac_words: torch.Tensor,
                         l_pac: int, desc: torch.Tensor, Lq: int, Lt: int,
                         opt_key: tuple) -> torch.Tensor:
    """One extend wave fed from resident data -> (8, B) int32 on the
    descriptors' device (K1's rows): ``sw_extend.extend_desc``, one launch
    on the card, ``build_qt`` and the plain twin on the CPU. opt_key =
    (o_del, e_del, o_ins, e_ins, end_bonus, zdrop, match_sc, mismatch_sc);
    N scores -1 (bwa)."""
    (o_del, e_del, o_ins, e_ins, end_bonus, zdrop, match_sc,
     mismatch_sc) = opt_key
    return sw_extend.extend_desc(
        reads, pac_words, l_pac, desc, Lq, Lt, o_del=o_del, e_del=e_del,
        o_ins=o_ins, e_ins=e_ins, end_bonus=end_bonus, zdrop=zdrop,
        match_sc=match_sc, mismatch_sc=mismatch_sc, n_sc=-1)
