"""Seed chaining and chain filtering (mem_chain / mem_chain_flt semantics).

Converts SMEM intervals into positioned seeds (SA dereference, capped at
max_occ occurrences per interval), greedily merges colinear seeds into chains
keyed by diagonal/position, computes chain weights, and applies the
drop-ratio/mask-level filtering that decides which chains get extended.

Reference behavior consumed through mem_align1_core
(``go/src/gobwa/gobwa.go:181-187``; chain layout ``gobwa/bwa_bridge.h:19-33``).
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import List, Tuple

import numpy as np

from ..config import AlignerConfig
from ..index.fmindex import FMIndex
from .seeding import Intv, collect_intv


@dataclasses.dataclass
class Seed:
    rbeg: int
    qbeg: int
    len: int
    score: int


@dataclasses.dataclass
class Chain:
    pos: int
    rid: int
    seeds: List[Seed]
    w: int = 0
    kept: int = 0
    first: int = -1
    frac_rep: float = 0.0


def _intv2rid(fm: FMIndex, rb: int, re: int) -> int:
    """bns_intv2rid: contig id if [rb, re) stays within one contig/strand."""
    if re <= fm.l_pac:
        b, e = rb, re
    elif rb >= fm.l_pac:
        b, e = fm.seq_len - re, fm.seq_len - rb
    else:
        return -1  # bridges the forward-reverse boundary
    if len(fm.contigs) == 1:
        return 0
    rid_b = fm.pos_to_contig(b)
    rid_e = fm.pos_to_contig(e - 1) if e > b else rid_b
    return rid_b if rid_b == rid_e else -1


def _test_and_merge(opt: AlignerConfig, l_pac: int, c: Chain, p: Seed,
                    seed_rid: int) -> bool:
    """Try to add seed p to chain c; True when merged or contained."""
    last = c.seeds[-1]
    qend = last.qbeg + last.len
    rend = last.rbeg + last.len
    if seed_rid != c.rid:
        return False
    if (p.qbeg >= c.seeds[0].qbeg and p.qbeg + p.len <= qend
            and p.rbeg >= c.seeds[0].rbeg and p.rbeg + p.len <= rend):
        return True  # contained seed; do nothing
    if ((last.rbeg < l_pac or c.seeds[0].rbeg < l_pac) and p.rbeg >= l_pac):
        return False  # don't chain seeds on different strands
    x = p.qbeg - last.qbeg  # non-negative thanks to sort order
    y = p.rbeg - last.rbeg
    if (y >= 0 and x - y <= opt.band_width and y - x <= opt.band_width
            and x - last.len < opt.max_chain_gap
            and y - last.len < opt.max_chain_gap):
        c.seeds.append(p)
        return True
    return False


def enumerate_occurrences(mems: List[Intv], opt: AlignerConfig
                          ) -> List[Tuple[int, int]]:
    """The (interval index, SA row) occurrence schedule of mem_chain's
    dereference loop (step-sampled above max_occ)."""
    occs: List[Tuple[int, int]] = []
    for mi, p in enumerate(mems):
        step = p.s // opt.max_occ if p.s > opt.max_occ else 1
        k = 0
        count = 0
        while k < p.s and count < opt.max_occ:
            occs.append((mi, p.x0 + k))
            k += step
            count += 1
    return occs


def chain_seeds(fm: FMIndex, q: np.ndarray, opt: AlignerConfig,
                mems: List[Intv] = None,
                rbegs: List[int] = None) -> List[Chain]:
    """mem_chain: SMEMs -> positioned seeds -> chains (+ frac_rep).

    ``rbegs``, when given, are precomputed SA dereferences matching
    ``enumerate_occurrences(mems, opt)`` order (batched native lookup).
    """
    if mems is None:
        from ..index import native_ops
        nat = native_ops.collect_seeds_batch(fm, [np.asarray(q, np.uint8)],
                                             opt)
        if nat is not None:
            mems = [Intv(int(r[0]), int(r[1]), int(r[2]), int(r[3]),
                         int(r[4])) for r in nat[0]]
        else:
            mems = collect_intv(fm, q, opt)
    # frac_rep: fraction of the read covered by high-occurrence intervals
    l_rep = 0
    b = e = 0
    for p in mems:
        if p.s <= opt.max_occ:
            continue
        if p.qb > e:
            l_rep += e - b
            b, e = p.qb, p.qe
        else:
            e = max(e, p.qe)
    l_rep += e - b
    frac_rep = l_rep / len(q) if len(q) else 0.0

    occs = enumerate_occurrences(mems, opt)
    if rbegs is None:
        from ..index import native_ops
        rows = np.array([row for _, row in occs], dtype=np.int64)
        if len(rows):
            nb = native_ops.sa_lookup_batch(fm, rows)
            rbegs = (list(nb) if nb is not None
                     else [fm.sa_lookup(int(r)) for r in rows])
        else:
            rbegs = []
    chains: List[Chain] = []
    chain_pos: List[int] = []  # sorted keys mirroring the kbtree
    for (mi, _row), rbeg in zip(occs, rbegs):
        p = mems[mi]
        slen = p.qe - p.qb
        rbeg = int(rbeg)
        seed = Seed(rbeg=rbeg, qbeg=p.qb, len=slen, score=slen)
        rid = _intv2rid(fm, rbeg, rbeg + slen)
        if rid >= 0:
            # find chain with the largest pos <= rbeg (kb_intervalp lower)
            idx = bisect.bisect_right(chain_pos, rbeg) - 1
            merged = False
            if idx >= 0:
                merged = _test_and_merge(opt, fm.l_pac, chains[idx], seed, rid)
            if not merged:
                nc = Chain(pos=rbeg, rid=rid, seeds=[seed],
                           frac_rep=frac_rep)
                ins = bisect.bisect_right(chain_pos, rbeg)
                chain_pos.insert(ins, rbeg)
                chains.insert(ins, nc)
    for c in chains:
        c.frac_rep = frac_rep
    return chains


def chain_weight(c: Chain) -> int:
    """mem_chain_weight: min of query-coverage and reference-coverage."""
    w = 0
    end = 0
    for s in c.seeds:
        if s.qbeg >= end:
            w += s.len
        elif s.qbeg + s.len > end:
            w += s.qbeg + s.len - end
        end = max(end, s.qbeg + s.len)
    tmp = w
    w = 0
    end = 0
    for s in c.seeds:
        if s.rbeg >= end:
            w += s.len
        elif s.rbeg + s.len > end:
            w += s.rbeg + s.len - end
        end = max(end, s.rbeg + s.len)
    return min(min(w, tmp), (1 << 30) - 1)


def _chn_beg(c: Chain) -> int:
    return c.seeds[0].qbeg


def _chn_end(c: Chain) -> int:
    return c.seeds[-1].qbeg + c.seeds[-1].len


def filter_chains(opt: AlignerConfig, chains: List[Chain]) -> List[Chain]:
    """mem_chain_flt: weight sort + pairwise mask-level/drop-ratio filtering."""
    if not chains:
        return []
    pool = []
    for c in chains:
        c.first = -1
        c.kept = 0
        c.w = chain_weight(c)
        if c.w >= opt.min_chain_weight:
            pool.append(c)
    if not pool:
        return []
    # sort by weight descending (ties keep the position order, close enough
    # to introsort behavior for identical-weight chains)
    pool.sort(key=lambda c: -c.w)
    a = pool
    a[0].kept = 3
    kept_idx = [0]
    for i in range(1, len(a)):
        large_ovlp = False
        broke = False
        for j in kept_idx:
            b_max = max(_chn_beg(a[j]), _chn_beg(a[i]))
            e_min = min(_chn_end(a[j]), _chn_end(a[i]))
            if e_min > b_max:  # overlap on the query
                li = _chn_end(a[i]) - _chn_beg(a[i])
                lj = _chn_end(a[j]) - _chn_beg(a[j])
                min_l = min(li, lj)
                if (e_min - b_max >= min_l * opt.mask_level
                        and min_l < opt.max_chain_gap):
                    large_ovlp = True
                    if a[j].first < 0:
                        a[j].first = i
                    if (a[i].w < a[j].w * opt.drop_ratio
                            and a[j].w - a[i].w >= opt.min_seed_len * 2):
                        broke = True
                        break
        if not broke:
            kept_idx.append(i)
            a[i].kept = 2 if large_ovlp else 3
    for j in kept_idx:
        if a[j].first >= 0:
            a[a[j].first].kept = 1
    # cap the number of kept==1/2 chains at max_chain_extend
    k = 0
    cut = len(a)
    for i in range(len(a)):
        if a[i].kept == 0 or a[i].kept == 3:
            continue
        k += 1
        if k >= opt.max_chain_extend:
            cut = i  # the breaking chain is zeroed too (kept < 3)
            break
    for i in range(cut, len(a)):
        if a[i].kept < 3:
            a[i].kept = 0
    return [c for c in a if c.kept != 0]
