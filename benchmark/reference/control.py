"""The control: the reference put in the program's place, with one of the
configuration's guarantees broken.

A plain aligner on the reference's own pieces: exact 31-base seeds looked
up in the genome (both strands), each hit scored ungapped with BWA-MEM's
scores, the best hit taken (MAPQ 60 when it is the only best, else 0), a
pair's records written as the program writes them (both reads, mate
fields, an ``AC`` entry a mismatch) to a barcode-sorted BAM and one
position bucket. The broken guarantee is sensitivity: it seeds each read
once, from its first 31 bases, where BWA-MEM seeds every exact match of 19
bases or more, so a read with a substitution there finds nothing, or
somewhere worse. The judge has to find it not correct.
"""

from __future__ import annotations

import os

import numpy as np

from . import bamwrite
from .judge import MATCH, MISMATCH

K = 31
MAX_HITS = 64


def _kmers(codes: np.ndarray) -> np.ndarray:
    """(len - K + 1,) 2-bit packed K-mers of ``codes`` (int64)."""
    n = len(codes) - K + 1
    out = np.zeros(n, np.int64)
    for j in range(K):
        out <<= 2
        out |= codes[j:j + n].astype(np.int64)
    return out


def _hits(codes, keys):
    """{key: [genome offsets]} of the K-mers ``keys`` (capped a key)."""
    ks = np.unique(keys)
    hits = {}
    step = 1 << 26
    for s in range(0, len(codes) - K + 1, step):
        g = _kmers(np.asarray(codes[s:s + step + K - 1]))
        j = np.searchsorted(ks, g)
        j[j == len(ks)] = 0
        for p in np.flatnonzero(ks[j] == g).tolist():
            lst = hits.setdefault(int(g[p]), [])
            if len(lst) < MAX_HITS:
                lst.append(s + p)
    return hits


def align(reads, codes, contigs):
    """(N, 2, 4) of (contig index, pos, reversed, mapq) per read; contig -1
    where the seed found nothing."""
    L = reads.r1.shape[1]
    offs = np.array([c[1] for c in contigs], np.int64)
    ends = offs + np.array([c[2] for c in contigs], np.int64)
    fw = np.concatenate([reads.r1, reads.r2])          # (2N, L), as read
    rc = (3 - fw)[:, ::-1]
    weights = (4 ** np.arange(K - 1, -1, -1)).astype(np.int64)
    # forward: the read's first bases at the hit; reverse: the seed is the
    # reverse complement of the read's first bases, so the read's reverse
    # complement ends where the hit ends
    keys = [(fw[:, :K].astype(np.int64) * weights).sum(1),
            (rc[:, L - K:].astype(np.int64) * weights).sum(1)]
    hits = _hits(codes, np.concatenate(keys))
    rid, start, strand = [], [], []
    for st in (0, 1):
        for i, key in enumerate(keys[st].tolist()):
            for h in hits.get(key, ()):
                rid.append(i)
                start.append(h if st == 0 else h + K - L)
                strand.append(st)
    rid, start, strand = (np.array(v, np.int64) for v in (rid, start, strand))
    ci = np.searchsorted(ends, start, side="right")
    ok = (ci < len(offs)) & (start >= offs[np.minimum(ci, len(offs) - 1)]) \
        & (start + L <= ends[np.minimum(ci, len(offs) - 1)])
    rid, start, strand, ci = rid[ok], start[ok], strand[ok], ci[ok]
    score = np.empty(len(rid), np.int64)
    cols = np.arange(L, dtype=np.int64)[None, :]
    for a in range(0, len(rid), 1 << 17):
        b = slice(a, a + (1 << 17))
        q = np.where(strand[b, None] == 0, fw[rid[b]], rc[rid[b]])
        d = (q != codes[start[b, None] + cols]).sum(1)
        score[b] = (L - d) * MATCH - d * MISMATCH
    out = np.zeros((2 * reads.n, 4), np.int64)
    out[:, 0] = -1
    if len(rid):
        order = np.lexsort((-score, rid))
        rid, start, strand, ci, score = (v[order] for v in
                                         (rid, start, strand, ci, score))
        first = np.flatnonzero(np.diff(rid, prepend=-1))
        best = np.repeat(score[first], np.diff(np.append(first, len(rid))))
        ties = np.bincount(rid[score == best], minlength=2 * reads.n)
        r = rid[first]
        out[r, 0], out[r, 1] = ci[first], start[first] - offs[ci[first]]
        out[r, 2], out[r, 3] = strand[first], np.where(ties[r] == 1, 60, 0)
    return np.stack([out[:reads.n], out[reads.n:]], 1)


def write(out_dir: str, reads, codes, contigs, placed) -> None:
    """The control's records, pair by pair in input order, to
    ``bc_sorted_bam.bam`` and one position bucket."""
    os.makedirs(out_dir, exist_ok=True)
    N, L = reads.n, reads.r1.shape[1]
    offs = np.array([c[1] for c in contigs], np.int64)
    refs = [(c[0], c[2]) for c in contigs]
    pl = placed.reshape(2 * N, 4)          # read 1 and read 2 of pair 0, ...
    mate_pl = placed[:, ::-1].reshape(2 * N, 4)
    read = np.stack([reads.r1, reads.r2], 1).reshape(2 * N, L)
    mapped = pl[:, 0] >= 0
    rev = mapped & (pl[:, 2] == 1)
    seq = np.where(rev[:, None], (3 - read)[:, ::-1], read)
    start = np.where(mapped, offs[np.maximum(pl[:, 0], 0)] + pl[:, 1], 0)
    diff = seq != codes[start[:, None] + np.arange(L)[None, :]]
    seq4 = bamwrite.pack_seq(seq)
    flag = 0x1 | np.tile([0x40, 0x80], N)
    flag |= np.where(mapped, 0, 0x4) | np.where(rev, 0x10, 0)
    flag |= np.where(mate_pl[:, 0] < 0, 0x8, 0)
    flag |= np.where((mate_pl[:, 0] >= 0) & (mate_pl[:, 2] == 1), 0x20, 0)
    ac = [""] * (2 * N)
    for k in np.flatnonzero(mapped & diff.any(1)).tolist():
        ac[k] = "".join(f"{int(start[k]) + j},{j},1;"
                        for j in np.flatnonzero(diff[k]).tolist())
    recs = []
    for k, (ci, pos, _, mapq), (oc, op, _, _), f in zip(
            range(2 * N), pl.tolist(), mate_pl.tolist(), flag.tolist()):
        if ci < 0:
            pos, mapq = -1, 0
        recs.append(bamwrite.record(
            reads.qnames[k // 2], f, ci, pos, mapq,
            [(0, L)] if ci >= 0 else [], seq4[k], L, oc, op, 0,
            bamwrite.tag_z("AC", ac[k]) if ci >= 0 else b""))
    bamwrite.write([os.path.join(out_dir, "bc_sorted_bam.bam"),
                    os.path.join(out_dir, "000000-control_pos_bucketed.bam")],
                   refs, recs)
