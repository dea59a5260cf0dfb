"""Seed extension into scored alignment regions (mem_chain2aln semantics)
plus region dedup/patching (mem_sort_dedup_patch).

Produces the ``mem_alnreg_t``-equivalent candidate regions the RFA inference
consumes (reference ``gobwa/gobwa.go:181-187``, ``inference/lariat.go:1706``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..config import AlignerConfig
from ..index.fmindex import FMIndex
from . import ksw
from .chaining import Chain

MAX_BAND_TRY = 2
PATCH_MAX_R_BW = 0.15
PATCH_MIN_SC_RATIO = 0.90


@dataclasses.dataclass(slots=True)
class AlnReg:
    """Candidate alignment region (mem_alnreg_t equivalent)."""
    rb: int = 0          # [rb, re): reference interval on the doubled text
    re: int = 0
    qb: int = 0          # [qb, qe): query interval
    qe: int = 0
    rid: int = -1
    score: int = -1
    truesc: int = -1
    sub: int = 0
    csub: int = 0
    seedcov: int = 0
    w: int = 0
    seedlen0: int = 0
    n_comp: int = 1
    frac_rep: float = 0.0
    rescued: bool = False

    def __reduce__(self):
        # positional-tuple pickling: these ship through the worker-pool
        # pipe once per primed candidate, and the default dataclass
        # reduce (per-field dict) is ~3x bigger and slower
        return (AlnReg, (self.rb, self.re, self.qb, self.qe, self.rid,
                         self.score, self.truesc, self.sub, self.csub,
                         self.seedcov, self.w, self.seedlen0, self.n_comp,
                         self.frac_rep, self.rescued))


def cal_max_gap(opt: AlignerConfig, qlen: int) -> int:
    l_del = int((qlen * opt.match_score - opt.gap_open_del) / opt.gap_extend_del + 1.0)
    l_ins = int((qlen * opt.match_score - opt.gap_open_ins) / opt.gap_extend_ins + 1.0)
    return min(max(max(l_del, l_ins), 1), opt.band_width * 2)


def chain2aln(fm: FMIndex, q: np.ndarray, opt: AlignerConfig, c: Chain,
              regs: List[AlnReg], mat: np.ndarray) -> None:
    """Extend the seeds of one chain into alignment regions (mem_chain2aln)."""
    if not c.seeds:
        return
    l_query = len(q)
    l_pac = fm.l_pac
    # max possible reference span of this chain
    rmax0, rmax1 = fm.seq_len, 0
    for t in c.seeds:
        b = t.rbeg - (t.qbeg + cal_max_gap(opt, t.qbeg))
        e = (t.rbeg + t.len
             + (l_query - t.qbeg - t.len)
             + cal_max_gap(opt, l_query - t.qbeg - t.len))
        rmax0 = min(rmax0, b)
        rmax1 = max(rmax1, e)
    rmax0 = max(rmax0, 0)
    rmax1 = min(rmax1, fm.seq_len)
    if rmax0 < l_pac < rmax1:  # crossing the strand boundary: pick one side
        if c.seeds[0].rbeg < l_pac:
            rmax1 = l_pac
        else:
            rmax0 = l_pac
    rseq = fm.fetch_fmd(rmax0, rmax1)

    # process seeds best-score first (ties: higher index first, matching the
    # stable uint64 sort on (score<<32|index))
    srt = sorted(range(len(c.seeds)),
                 key=lambda i: (c.seeds[i].score, i), reverse=True)
    skipped = set()
    for si, seed_idx in enumerate(srt):
        s = c.seeds[seed_idx]
        # check whether this seed is contained in an existing region
        hit_existing = None
        for p in regs:
            if (s.rbeg < p.rb or s.rbeg + s.len > p.re
                    or s.qbeg < p.qb or s.qbeg + s.len > p.qe):
                continue
            if s.len - p.seedlen0 > 0.1 * l_query:
                continue
            qd = s.qbeg - p.qb
            rd = s.rbeg - p.rb
            max_gap = cal_max_gap(opt, min(qd, rd))
            w = min(max_gap, p.w)
            if qd - rd < w and rd - qd < w:
                hit_existing = p
                break
            qd = p.qe - (s.qbeg + s.len)
            rd = p.re - (s.rbeg + s.len)
            max_gap = cal_max_gap(opt, min(qd, rd))
            w = min(max_gap, p.w)
            if qd - rd < w and rd - qd < w:
                hit_existing = p
                break
        if hit_existing is not None:
            # confirm no overlapping seed suggests a different alignment
            # (scan seeds processed before this one, i.e. higher-score ones)
            found_conflict = False
            for sj in range(si):
                j_idx = srt[sj]
                if j_idx in skipped:
                    continue
                t = c.seeds[j_idx]
                if t.len < s.len * 0.95:
                    continue
                if (s.qbeg <= t.qbeg and s.qbeg + s.len - t.qbeg >= s.len // 4
                        and t.qbeg - s.qbeg != t.rbeg - s.rbeg):
                    found_conflict = True
                    break
                if (t.qbeg <= s.qbeg and t.qbeg + t.len - s.qbeg >= s.len // 4
                        and s.qbeg - t.qbeg != s.rbeg - t.rbeg):
                    found_conflict = True
                    break
            if not found_conflict:
                skipped.add(seed_idx)
                continue

        a = AlnReg(w=opt.band_width, rid=c.rid, frac_rep=c.frac_rep)
        aw = [opt.band_width, opt.band_width]
        if s.qbeg:  # left extension on reversed prefixes
            qs = q[:s.qbeg][::-1].astype(np.int64)
            tmp = s.rbeg - rmax0
            rs = rseq[:tmp][::-1].astype(np.int64)
            res = None
            prev_score = -1
            for i in range(MAX_BAND_TRY):
                aw[0] = opt.band_width << i
                res = ksw.extend(qs, rs, mat, opt.gap_open_del,
                                 opt.gap_extend_del, opt.gap_open_ins,
                                 opt.gap_extend_ins, aw[0], opt.pen_clip5,
                                 opt.zdrop, s.len * opt.match_score)
                if res.score == prev_score or res.max_off < (aw[0] >> 1) + (aw[0] >> 2):
                    break
                prev_score = res.score
            a.score = res.score
            if res.gscore <= 0 or res.gscore <= a.score - opt.pen_clip5:
                a.qb = s.qbeg - res.qle
                a.rb = s.rbeg - res.tle
                a.truesc = a.score
            else:
                a.qb = 0
                a.rb = s.rbeg - res.gtle
                a.truesc = res.gscore
        else:
            a.score = a.truesc = s.len * opt.match_score
            a.qb = 0
            a.rb = s.rbeg

        if s.qbeg + s.len != l_query:  # right extension
            sc0 = a.score
            qe = s.qbeg + s.len
            re_off = s.rbeg + s.len - rmax0
            qseg = q[qe:].astype(np.int64)
            tseg = rseq[re_off:].astype(np.int64)
            res = None
            prev_score = -1
            for i in range(MAX_BAND_TRY):
                aw[1] = opt.band_width << i
                res = ksw.extend(qseg, tseg, mat, opt.gap_open_del,
                                 opt.gap_extend_del, opt.gap_open_ins,
                                 opt.gap_extend_ins, aw[1], opt.pen_clip3,
                                 opt.zdrop, sc0)
                if res.score == prev_score or res.max_off < (aw[1] >> 1) + (aw[1] >> 2):
                    break
                prev_score = res.score
            a.score = res.score
            if res.gscore <= 0 or res.gscore <= a.score - opt.pen_clip3:
                a.qe = qe + res.qle
                a.re = rmax0 + re_off + res.tle
                a.truesc += a.score - sc0
            else:
                a.qe = l_query
                a.re = rmax0 + re_off + res.gtle
                a.truesc += res.gscore - sc0
        else:
            a.qe = l_query
            a.re = s.rbeg + s.len

        a.seedcov = 0
        for t in c.seeds:
            if (t.qbeg >= a.qb and t.qbeg + t.len <= a.qe
                    and t.rbeg >= a.rb and t.rbeg + t.len <= a.re):
                a.seedcov += t.len
        a.w = max(aw[0], aw[1])
        a.seedlen0 = s.len
        regs.append(a)


def patch_reg(fm: FMIndex, q: np.ndarray, opt: AlignerConfig,
              a: AlnReg, b: AlnReg, mat: np.ndarray) -> Optional[tuple]:
    """mem_patch_reg: try to merge colinear regions a (left) and b (right).

    Returns (w, score) when mergeable, else None.
    """
    if a.rb < fm.l_pac <= b.rb:
        return None
    if a.qb >= b.qb or a.qe >= b.qe or a.re >= b.re:
        return None  # not colinear
    w = abs((a.re - b.rb) - (a.qe - b.qb))
    r = abs((a.re - b.rb) / (b.re - a.rb) - (a.qe - b.qb) / (b.qe - a.qb))
    if a.re < b.rb or a.qe < b.qb:  # no overlap on ref or query
        if w > opt.band_width * 2 or r >= PATCH_MAX_R_BW:
            return None
    elif w > opt.band_width * 4 or r >= PATCH_MAX_R_BW * 2:
        return None
    w += max(a.w, b.w)
    w = min(w, opt.band_width * 4)
    rseq = fm.fetch_fmd(a.rb, b.re)
    score, _ = ksw.global_align(
        q[a.qb:b.qe].astype(np.int64), rseq.astype(np.int64), mat,
        opt.gap_open_del, opt.gap_extend_del, opt.gap_open_ins,
        opt.gap_extend_ins, w, want_cigar=False)
    q_s = int((b.qe - a.qb) / ((b.re - a.rb) + (b.qe - a.qb))
              * (a.score + b.score) + 0.499)
    r_s = int((b.re - a.rb) / ((b.re - a.rb) + (b.qe - a.qb))
              * (a.score + b.score) + 0.499)
    if score / max(q_s, r_s) < PATCH_MIN_SC_RATIO:
        return None
    return w, score


def sort_dedup_patch(fm: FMIndex, q: np.ndarray, opt: AlignerConfig,
                     regs: List[AlnReg], mat: np.ndarray) -> List[AlnReg]:
    """mem_sort_dedup_patch: drop redundant regions, merge colinear ones."""
    n = len(regs)
    if n <= 1:
        return regs
    regs.sort(key=lambda p: p.re)  # sort by END position
    for p in regs:
        p.n_comp = 1
    for i in range(1, len(regs)):
        p = regs[i]
        if (p.rid != regs[i - 1].rid
                or p.rb >= regs[i - 1].re + opt.max_chain_gap):
            continue
        j = i - 1
        while (j >= 0 and p.rid == regs[j].rid
               and p.rb < regs[j].re + opt.max_chain_gap):
            qreg = regs[j]
            if qreg.qe == qreg.qb:
                j -= 1
                continue  # already excluded
            or_ = qreg.re - p.rb
            oq = (qreg.qe - p.qb) if qreg.qb < p.qb else (p.qe - qreg.qb)
            mr = min(qreg.re - qreg.rb, p.re - p.rb)
            mq = min(qreg.qe - qreg.qb, p.qe - p.qb)
            if or_ > opt.mask_level_redun * mr and oq > opt.mask_level_redun * mq:
                if p.score < qreg.score:
                    p.qe = p.qb  # exclude p
                    break
                else:
                    qreg.qe = qreg.qb  # exclude q
            elif qreg.rb < p.rb:
                merged = patch_reg(fm, q, opt, qreg, p, mat)
                if merged is not None:
                    w, score = merged
                    p.n_comp += qreg.n_comp + 1
                    p.seedcov = max(p.seedcov, qreg.seedcov)
                    p.sub = max(p.sub, qreg.sub)
                    p.csub = max(p.csub, qreg.csub)
                    p.qb = qreg.qb
                    p.rb = qreg.rb
                    p.truesc = p.score = score
                    p.w = w
                    qreg.qb = qreg.qe  # exclude q
            j -= 1
    regs = [p for p in regs if p.qe > p.qb]
    # sort by score desc, then rb, then qb (mem_ars order)
    regs.sort(key=lambda p: (-p.score, p.rb, p.qb))
    for i in range(1, len(regs)):
        if (regs[i].score == regs[i - 1].score and regs[i].rb == regs[i - 1].rb
                and regs[i].qb == regs[i - 1].qb):
            regs[i].qe = regs[i].qb  # identical hit
    return [p for p in regs if p.qe > p.qb]
