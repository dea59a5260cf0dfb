"""SMEM seeding over the FMD index (host reference implementation).

Reproduces the native engine's three-round seeding strategy consumed through
mem_align1_core (reference ``go/src/gobwa/gobwa.go:181-187``; API surface
``gobwa/bwa_bridge.h:35-36``):

 1. supermaximal exact matches (bidirectional extension, smem1);
 2. re-seeding of long low-occurrence SMEMs from their midpoint;
 3. LAST-like forward-greedy seeds stopping at occurrence < max_mem_intv.

An interval is a bwtintv: (k, l, s) = SA range start for P, range start for
revcomp(P), and size; plus (qb, qe) query span.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..config import AlignerConfig
from ..index.fmindex import FMIndex


@dataclasses.dataclass
class Intv:
    x0: int   # SA interval start for P
    x1: int   # SA interval start for revcomp(P)
    s: int    # interval size
    qb: int   # query begin (inclusive)
    qe: int   # query end (exclusive)


def set_intv(fm: FMIndex, c: int) -> Tuple[int, int, int]:
    """Initial bi-interval of a single base (bwt_set_intv)."""
    return (int(fm.L2[c]) + 1, int(fm.L2[3 - c]) + 1,
            int(fm.L2[c + 1] - fm.L2[c]))


def bwt_extend(fm: FMIndex, ik: Tuple[int, int, int], is_back: bool
               ) -> List[Tuple[int, int, int]]:
    """Bidirectional extension: intervals for all four appended bases.

    Forward extension (is_back=False) extends P on the right by base b by
    extending revcomp(P) on the left with complement(b); the rank queries run
    on the x1 coordinate. Returns ok[0..3] indexed by the *rank-query* base
    (i.e. ok[3-b] is the interval for appending b on the right when forward).
    """
    x0, x1, s = ik
    qpos = x0 if is_back else x1
    # bwt_2occ4(bwt, ik->x[!is_back] - 1, ik->x[!is_back] - 1 + ik->x[2], ...)
    tk = fm.occ4(qpos - 1)
    tl = fm.occ4(qpos - 1 + s)
    ok = []
    sizes = [int(tl[i] - tk[i]) for i in range(4)]
    starts = [int(fm.L2[i]) + 1 + int(tk[i]) for i in range(4)]
    # other-side coordinates: sentinel-containing interval goes to ok[3]
    crosses = 1 if (qpos <= fm.primary and qpos + s - 1 >= fm.primary) else 0
    other = [0, 0, 0, 0]
    other_base = (x1 if is_back else x0)
    other[3] = other_base + crosses
    other[2] = other[3] + sizes[3]
    other[1] = other[2] + sizes[2]
    other[0] = other[1] + sizes[1]
    for i in range(4):
        if is_back:
            ok.append((starts[i], other[i], sizes[i]))
        else:
            ok.append((other[i], starts[i], sizes[i]))
    return ok


def smem1a(fm: FMIndex, q: np.ndarray, x: int, min_intv: int,
           max_intv: int) -> Tuple[int, List[Intv]]:
    """bwt_smem1a: all SMEMs covering position x. Returns (next_x, mems)."""
    length = len(q)
    if q[x] > 3:
        return x + 1, []
    if min_intv < 1:
        min_intv = 1
    mems: List[Intv] = []
    x0, x1, s = set_intv(fm, int(q[x]))
    ik = Intv(x0, x1, s, 0, x + 1)
    curr: List[Intv] = []
    i = x + 1
    while i < length:
        if max_intv and ik.s < max_intv:
            curr.append(ik)
            break
        if q[i] < 4:
            c = 3 - int(q[i])
            ok = bwt_extend(fm, (ik.x0, ik.x1, ik.s), is_back=False)
            if ok[c][2] != ik.s:
                curr.append(ik)
                if ok[c][2] < min_intv:
                    break
            ik = Intv(ok[c][0], ok[c][1], ok[c][2], 0, i + 1)
        else:
            curr.append(ik)
            break
        i += 1
    if i == length:
        curr.append(ik)
    curr.reverse()  # smaller intervals (longer matches) first
    ret = curr[0].qe  # end of the longest exact match from x
    prev = curr

    i = x - 1
    while i >= -1:
        c = -1 if i < 0 or q[i] > 3 else int(q[i])
        curr = []
        for p in prev:
            if c >= 0 and p.s >= max_intv:
                ok = bwt_extend(fm, (p.x0, p.x1, p.s), is_back=True)
            else:
                ok = None
            if c < 0 or p.s < max_intv or (ok is not None and ok[c][2] < min_intv):
                if not curr:
                    if not mems or i + 1 < mems[-1].qb:
                        mems.append(Intv(p.x0, p.x1, p.s, i + 1, p.qe))
            elif not curr or (ok is not None and ok[c][2] != curr[-1].s):
                curr.append(Intv(ok[c][0], ok[c][1], ok[c][2], 0, p.qe))
        if not curr:
            break
        prev = curr
        i -= 1
    mems.reverse()  # sorted by MEM start
    return ret, mems


def seed_strategy1(fm: FMIndex, q: np.ndarray, x: int, min_len: int,
                   max_intv: int) -> Tuple[int, List[Intv]]:
    """bwt_seed_strategy1: LAST-like forward-greedy third-round seeding."""
    length = len(q)
    if q[x] > 3:
        return x + 1, []
    x0, x1, s = set_intv(fm, int(q[x]))
    ik = (x0, x1, s)
    i = x + 1
    while i < length:
        if q[i] < 4:
            c = 3 - int(q[i])
            ok = bwt_extend(fm, ik, is_back=False)
            if ok[c][2] < max_intv and i - x >= min_len:
                # bwa keeps third-round seeds only when non-empty (x[2] > 0)
                if ok[c][2] > 0:
                    m = Intv(ok[c][0], ok[c][1], ok[c][2], x, i + 1)
                    return i + 1, [m]
                return i + 1, []
            ik = ok[c]
        else:
            return i + 1, []
        i += 1
    return length, []


def collect_intv(fm: FMIndex, q: np.ndarray, opt: AlignerConfig) -> List[Intv]:
    """mem_collect_intv: three seeding passes + sort by (qb, qe)."""
    length = len(q)
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    mems: List[Intv] = []
    # pass 1: SMEMs
    x = 0
    while x < length:
        if q[x] < 4:
            x, found = smem1a(fm, q, x, 1, 0)
            for p in found:
                if p.qe - p.qb >= opt.min_seed_len:
                    mems.append(p)
        else:
            x += 1
    # pass 2: re-seed long low-occ SMEMs from the midpoint
    old_n = len(mems)
    for k in range(old_n):
        p = mems[k]
        if p.qe - p.qb < split_len or p.s > opt.split_width:
            continue
        _, found = smem1a(fm, q, (p.qb + p.qe) >> 1, p.s + 1, 0)
        for m in found:
            if m.qe - m.qb >= opt.min_seed_len:
                mems.append(m)
    # pass 3: LAST-like seeding
    if opt.max_mem_intv > 0:
        x = 0
        while x < length:
            if q[x] < 4:
                x, found = seed_strategy1(fm, q, x, opt.min_seed_len,
                                          opt.max_mem_intv)
                mems.extend(found)
            else:
                x += 1
    # sort by packed (qb<<32|qe) like ks_introsort(mem_intv)
    mems.sort(key=lambda m: (m.qb, m.qe))
    return mems
