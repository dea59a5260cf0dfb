"""The comparison that decides ``correct``: the program's BAM records
against the reads the benchmark made and the genome it made them from.

Plain NumPy; it imports nothing of the program and takes nothing the
program made but the BAMs it judges and the counts its summary printed.
For each run it reads every record of every barcode-sorted BAM the window
wrote and counts:

- ``pairs_lost``: input pairs without exactly one primary record for each
  read, plus primary records that name no input pair (delivery);
- ``processed_off``: the pairs delivered against the pairs the program's
  summaries say they processed;
- ``records_inconsistent``: primary records whose SEQ is not their read
  (reverse-complemented when reversed), whose flags name no read of a
  pair, whose CIGAR does not span SEQ or runs past its contig, whose mate
  fields disagree with the mate's own record, and, on a sample drawn from
  the seed, whose ``AC`` mismatch list is not as long as the mismatches
  the reference counts at ``POS``; and records missing from the
  position-bucketed BAMs (every record is written to both);
- ``below_origin_pct``: the share of reads whose primary record is
  unmapped or scores, by the reference's rescoring of its CIGAR at its
  ``POS`` (BWA-MEM's scores: match 1, mismatch 4, gap open 6, extend 1,
  soft clips 0), below the read's alignment at its simulated origin (its
  truth CIGAR: its substitutions and its indels);
- ``wrong_q30_pct``: the share of reads whose primary record claims MAPQ
  30 or more at a wrong locus: another contig, or ``POS`` 600 bases or
  more from the truth (the rule of the reference's ``-simulated`` check).

The first three are exact (limit 0). The last two have limits set from
the program's readings and the control's (see PERF.md). Two more readings
are kept beside them, uncompared: ``wrong_pct``, the reads placed at a
wrong locus at any MAPQ (what ``wrong_q30_pct`` reads when every MAPQ is
reported as 60), and ``off_origin_equal_pct``, the reads placed at a
wrong locus that scores as well as their origin or better (an equal copy,
where only the barcode's molecules tell the right one).
"""

from __future__ import annotations

import glob
import os

import numpy as np

from . import bam

MATCH, MISMATCH, GAP_OPEN, GAP_EXT = 1, 4, 6, 1
MAPQ_HIGH, LOCUS_SLACK = 30, 600
# the numbers held to a limit; the others are readings kept beside them
COMPARED = ("pairs_lost", "processed_off", "records_inconsistent",
            "below_origin_pct", "wrong_q30_pct")


def genome_strand(read: np.ndarray, rev) -> np.ndarray:
    """Reads as written, turned to the genome strand where ``rev``."""
    rev = np.asarray(rev, bool)
    return np.where(rev[..., None], (3 - read)[..., ::-1], read)


def origin_scores(reads, codes, contigs) -> np.ndarray:
    """(N, 2) score of each read at its simulated origin: ungapped, or by
    its truth CIGAR where the generator gave it indels."""
    offs = np.array([c[1] for c in contigs], np.int64)[reads.contig]
    L = reads.r1.shape[1]
    cols = np.arange(L, dtype=np.int64)[None, :]
    score = np.empty((reads.n, 2), np.int64)
    for m, (r, pos) in enumerate(((reads.r1, reads.pos1),
                                  (reads.r2, reads.pos2))):
        g = codes[(offs + pos)[:, None] + cols]
        mm = (genome_strand(r, reads.rev[:, m]) != g).sum(1)
        score[:, m] = (L - mm) * MATCH - mm * MISMATCH
    for key, cig in reads.gapped.items():
        i, m = divmod(key, 2)
        r, pos = (reads.r1, reads.pos1) if m == 0 else (reads.r2, reads.pos2)
        score[i, m] = rescore(cig, genome_strand(r[i], reads.rev[i, m]),
                              codes, int(offs[i] + pos[i]))[0]
    return score


def rescore(cigar, seq, codes, start) -> tuple:
    """(score, mismatches, query bases, reference bases) of one CIGAR of
    the read ``seq`` (codes, genome strand) at genome offset ``start``."""
    score = mm = qi = ri = 0
    for op, ln in cigar:
        if op in (0, 7, 8):
            d = int((seq[qi:qi + ln] != codes[start + ri:start + ri + ln])
                    .sum()) if start + ri + ln <= len(codes) else ln
            mm += d
            score += (ln - d) * MATCH - d * MISMATCH
            qi += ln
            ri += ln
        elif op == 1:
            score -= GAP_OPEN + ln * GAP_EXT
            qi += ln
        elif op == 2:
            score -= GAP_OPEN + ln * GAP_EXT
            ri += ln
        elif op == 4:
            qi += ln
        elif op == 3:
            ri += ln
    return score, mm, qi, ri


class Judge:
    """Holds one run's reads and genome; ``judge(dirs)`` counts."""

    def __init__(self, reads, codes, contigs, seed: int,
                 ac_sample: int = 2000):
        self.reads, self.codes, self.contigs = reads, codes, contigs
        self.seed, self.ac_sample = seed, ac_sample
        self.ctg_idx = {c[0]: k for k, c in enumerate(contigs)}
        self.name_idx = {q: i for i, q in enumerate(reads.qnames)}
        self.origin = origin_scores(reads, codes, contigs)
        self.truth_pos = np.stack([reads.pos1, reads.pos2], 1)

    def judge(self, out_dirs, processed: int) -> dict:
        reads, codes = self.reads, self.codes
        N, L = reads.n, reads.r1.shape[1]
        cnt = np.zeros((N, 2), np.int64)
        score = np.full((N, 2), np.iinfo(np.int64).min)
        # where the primary record puts each read: wrong locus, its MAPQ
        self.wrong = np.zeros((N, 2), bool)
        self.mapq = np.zeros((N, 2), np.int64)
        extra = bad = 0
        ctg_of = {c[0]: (c[1], c[2]) for c in self.contigs}
        rng = np.random.default_rng([abs(int(self.seed)), 7])
        for d in out_dirs:
            rec = bam.read(os.path.join(d, "bc_sorted_bam.bam"))
            bucketed = sum(bam.count(p) for p in
                           glob.glob(os.path.join(d, "*_pos_bucketed.bam")))
            bad += abs(bucketed - rec.n)
            if not rec.n:
                continue
            names = rec.names()
            idx = np.array([self.name_idx.get(nm, -1) for nm in names])
            prim = (rec.flag & 0x900) == 0
            mate = np.where(rec.flag & 0x80, 1, 0)
            which = ((rec.flag & 0xC0) == 0x40) | ((rec.flag & 0xC0) == 0x80)
            extra += int((prim & (idx < 0)).sum())
            bad += int((prim & (idx >= 0) & ~which).sum())
            sel = np.flatnonzero(prim & (idx >= 0) & which)
            np.add.at(cnt, (idx[sel], mate[sel]), 1)
            bad += self._records(rec, sel, idx, mate, score, ctg_of, rng)
        ok = (cnt == 1).all(1)
        lost = int((~ok).sum()) + extra
        below = (score < self.origin) | ~ok[:, None]
        wrong = self.wrong & ok[:, None]
        pct = 100.0 / (2 * N)
        return {"pairs_lost": lost,
                "processed_off": abs(int(ok.sum()) - int(processed)),
                "records_inconsistent": int(bad),
                "below_origin_pct": pct * float(below.sum()),
                "wrong_q30_pct": pct * float(
                    (wrong & (self.mapq >= MAPQ_HIGH)).sum()),
                "wrong_pct": pct * float(wrong.sum()),
                "off_origin_equal_pct": pct * float(
                    (wrong & (score >= self.origin)).sum())}

    def _records(self, rec, sel, idx, mate, score, ctg_of, rng) -> int:
        """Checks the primary records ``sel`` of one BAM; fills ``score``
        for the mapped ones; returns how many are inconsistent."""
        reads, codes, L = self.reads, self.codes, self.reads.r1.shape[1]
        bad = 0
        full = sel[rec.l_seq[sel] == L]
        bad += len(sel) - len(full)
        seq = rec.seq_codes(full, L)
        i, m = idx[full], mate[full]
        want = np.where(m[:, None] == 0, reads.r1[i], reads.r2[i])
        rev = (rec.flag[full] & 0x10) != 0
        want[rev] = (3 - want[rev])[:, ::-1]
        bad += int((seq != want).any(1).sum())

        mapped = full[(rec.flag[full] & 0x4) == 0]
        ref_off = np.array([ctg_of.get(n, (-1, 0))[0] for n, _ in rec.refs]
                           + [-1], np.int64)
        ref_len = np.array([ctg_of.get(n, (-1, 0))[1] for n, _ in rec.refs]
                           + [0], np.int64)
        w0 = rec.first_cigar()
        simple = (rec.n_cigar == 1) & ((w0 & 15) == 0) & ((w0 >> 4) == L)
        span = np.full(len(mapped), L, np.int64)
        for k in np.flatnonzero(~simple[mapped]).tolist():
            span[k] = sum(ln for op, ln in rec.cigar(int(mapped[k]))
                          if op in (0, 2, 3, 7, 8))
        rid = rec.ref_id[mapped]
        rid = np.where((rid >= 0) & (rid < len(rec.refs)), rid, -1)
        pos = rec.pos[mapped]
        valid = (ref_off[rid] >= 0) & (pos >= 0) & (pos + span <= ref_len[rid])
        starts = np.where(valid, ref_off[rid] + pos, 0)
        bad += int((~valid).sum())
        mm = np.zeros(len(mapped), np.int64)
        sc = np.full(len(mapped), np.iinfo(np.int64).min)
        vs = valid & simple[mapped]
        if vs.any():
            g = codes[starts[vs][:, None] + np.arange(L)[None, :]]
            d = (g != rec.seq_codes(mapped[vs], L)).sum(1)
            mm[vs] = d
            sc[vs] = (L - d) * MATCH - d * MISMATCH
        for k in np.flatnonzero(valid & ~simple[mapped]).tolist():
            r = int(mapped[k])
            s, d, qlen, _ = rescore(rec.cigar(r),
                                    seq[np.searchsorted(full, r)], codes,
                                    int(starts[k]))
            if qlen != L:
                bad += 1
                continue
            mm[k], sc[k] = d, s
        score[idx[mapped], mate[mapped]] = np.maximum(
            score[idx[mapped], mate[mapped]], sc)
        ci = np.array([self.ctg_idx.get(n, -1) for n, _ in rec.refs] + [-1],
                      np.int64)[rid]
        im, mt = idx[mapped], mate[mapped]
        self.wrong[im, mt] = (ci != reads.contig[im]) | (
            np.abs(pos - self.truth_pos[im, mt]) >= LOCUS_SLACK)
        self.mapq[im, mt] = rec.mapq[mapped]

        # mate fields against the mate's own primary record
        row = np.full(2 * reads.n, -1, np.int64)
        row[2 * idx[sel] + mate[sel]] = sel
        paired = sel[(rec.flag[sel] & 0x1) != 0]
        o = row[2 * idx[paired] + 1 - mate[paired]]
        paired, o = paired[o >= 0], o[o >= 0]
        f, of = rec.flag[paired], rec.flag[o]
        unset = (f & 0x8) == 0
        bad += int(((of & 0x4 != 0) & unset).sum())
        live = unset & ((of & 0x4) == 0)
        bad += int((live & ((rec.next_ref_id[paired] != rec.ref_id[o])
                            | (rec.next_pos[paired] != rec.pos[o])
                            | ((f & 0x20 != 0) != (of & 0x10 != 0)))).sum())

        # AC: one entry a mismatch, on a sample drawn from the seed
        pick = np.flatnonzero(valid)
        if len(pick) > self.ac_sample:
            pick = rng.choice(pick, self.ac_sample, replace=False)
        for k in pick.tolist():
            ac = rec.aux(int(mapped[k])).get("AC", "")
            if ac.count(";") != int(mm[k]):
                bad += 1
        return bad
