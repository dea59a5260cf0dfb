"""Per-read alignment engine: candidate region generation + final alignment.

Host reference implementation of the native engine surface the Go shim
consumes (``gobwa/gobwa.go``):

 - ``align1``      = mem_align1_core: seed -> chain -> filter -> extend ->
                     dedup/patch (gobwa.go:181-187)
 - ``mate_sw``     = mem_matesw driver incl. the per-anchor loop and rescue
                     windows (gobwa.go:226-337)
 - ``reg2aln``     = mem_reg2aln: banded global realign -> CIGAR/NM/pos
                     (gobwa.go:400-415)
 - ``interpret_align`` = InterpretAlign coordinate unprojection
                     (gobwa.go:339-371)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np

from ..config import AlignerConfig, PairModel
from ..index.fmindex import FMIndex, NT4_TABLE
from . import ksw
from .chaining import chain_seeds, filter_chains
from .extension import AlnReg, chain2aln, sort_dedup_patch

# internal cigar op encoding (bwa MIDSH)
OP_M, OP_I, OP_D, OP_S, OP_H = 0, 1, 2, 3, 4


# one bytes.translate call beats the numpy table gather ~2.5x at read length
_NT4_TRANS = bytes.maketrans(bytes(range(256)), NT4_TABLE.tobytes())

# dict.get miss sentinel (rescue replay: None is a real cached value)
_MISS = object()


@functools.lru_cache(maxsize=65536)
def encode_read(seq: bytes) -> np.ndarray:
    """ASCII -> nt4 codes (A0 C1 G2 T3, other 4).

    Memoized (reads are encoded several times along the pipeline; the cache
    must cover the reader's 30,000-record barcode cap x2 mates or it
    thrashes); the returned array is read-only so accidental mutation of the
    shared cache entry fails loudly.
    """
    arr = np.frombuffer(seq.translate(_NT4_TRANS), dtype=np.uint8)
    arr.setflags(write=False)
    return arr


@dataclasses.dataclass(slots=True)
class SingleReadAlignment:
    """mem_aln_t equivalent (bwa_bridge.h:6-16 field meanings)."""
    pos: int = -1              # contig-local forward 5' position
    rid: int = -1
    chrom: str = ""
    reversed_: bool = False
    edit_distance: int = 0     # NM
    cigar: Tuple[Tuple[int, int], ...] = ()
    score: int = 0
    sub: int = 0
    read_s: int = 0
    read_e: int = 0

    def __reduce__(self):
        # compact positional pickling (shipped per primed candidate)
        return (SingleReadAlignment,
                (self.pos, self.rid, self.chrom, self.reversed_,
                 self.edit_distance, self.cigar, self.score, self.sub,
                 self.read_s, self.read_e))


@dataclasses.dataclass(slots=True)
class EasyAlignment:
    """InterpretAlign output (gobwa.go:88-98)."""
    offset: int
    alignment_end: int
    contig: str
    reversed_: bool
    region: AlnReg
    score: int
    secondary: bool
    read_s: int
    read_e: int


def cigar_nm(cigar: List[Tuple[int, int]], q: np.ndarray,
             rseq: np.ndarray) -> int:
    """NM of a global CIGAR over the oriented query and reference codes:
    mismatches + gap bases (a D at either CIGAR edge not counted)."""
    n_mm = n_gap = 0
    x = y = 0
    for k, (op, ln) in enumerate(cigar):
        if op == OP_M:
            n_mm += int(np.count_nonzero(q[x:x + ln] != rseq[y:y + ln]))
            x += ln
            y += ln
        elif op == OP_D:
            if 0 < k < len(cigar) - 1:
                n_gap += ln
            y += ln
        elif op == OP_I:
            x += ln
            n_gap += ln
    return n_mm + n_gap


class AlignmentEngine:
    """TPU-native replacement for the C alignment engine + Go shim."""

    def __init__(self, fm: FMIndex, opt: Optional[AlignerConfig] = None,
                 pair: Optional[PairModel] = None):
        self.fm = fm
        self.opt = opt or AlignerConfig()
        self.pair = pair or PairModel()
        self.mat = ksw.fill_score_matrix(self.opt.match_score,
                                         self.opt.mismatch_penalty)

    # ------------------------------------------------------------------ align1

    def align1(self, q: np.ndarray, mems=None, rbegs=None) -> List[AlnReg]:
        """mem_align1_core: all candidate regions for one read."""
        if len(q) == 0:
            return []
        if mems is not None and rbegs is not None:
            # full C++ path (chain/filter/extend/dedup in one FFI call)
            from . import native_engine
            nat = native_engine.align1_batch(self.fm, self.opt, [q],
                                             [mems], [rbegs])
            if nat is not None:
                return nat[0]
        chains = chain_seeds(self.fm, q, self.opt, mems, rbegs)
        chains = filter_chains(self.opt, chains)
        # mem_flt_chained_seeds is a no-op for short reads: min_l =
        # 5.5*log(l) > 0.05*l holds for every read length below ~2 kb.
        regs: List[AlnReg] = []
        for c in chains:
            chain2aln(self.fm, q, self.opt, c, regs, self.mat)
        regs = sort_dedup_patch(self.fm, q, self.opt, regs, self.mat)
        return regs

    # ---------------------------------------------------------------- mate sw

    def _infer_dir(self, b1: int, b2: int) -> Tuple[int, int]:
        """mem_infer_dir: orientation r (0 FF,1 FR,2 RF,3 RR) and distance."""
        l_pac = self.fm.l_pac
        r1 = b1 >= l_pac
        r2 = b2 >= l_pac
        p2 = b2 if r1 == r2 else (l_pac << 1) - 1 - b2
        dist = abs(p2 - b1)
        return (0 if r1 == r2 else 1) ^ (0 if p2 > b1 else 3), dist

    def _fetch_clamped(self, beg: int, mid: int, end: int
                       ) -> Tuple[np.ndarray, int, int, int]:
        """bns_fetch_seq: clamp [beg, end) to mid's contig (strand-projected)."""
        l_pac = self.fm.l_pac
        is_rev = mid >= l_pac
        fpos = (l_pac << 1) - 1 - mid if is_rev else mid
        rid = self.fm.pos_to_contig(fpos)
        c = self.fm.contigs[rid]
        far_beg, far_end = c.offset, c.offset + c.length
        if is_rev:
            far_beg, far_end = ((l_pac << 1) - (c.offset + c.length),
                                (l_pac << 1) - c.offset)
        beg = max(beg, far_beg)
        end = min(end, far_end)
        return self.fm.fetch_fmd(beg, end), beg, end, rid

    def _rescue_skip(self, anchor: AlnReg, mate_regs: List[AlnReg]) -> bool:
        """True if the mate already has a properly-oriented hit in range.

        Consulted at replay time: earlier rescues in the same pair append to
        ``mate_regs`` and change later skip decisions."""
        pes = self.pair
        # only the FR orientation (r=1) is configured (gobwa.go:230-237);
        # inlined _infer_dir: r==1 iff opposite strands and p2 > b1, where
        # dist is then p2 - b1 (hot loop: ~30 regs per rescue decision)
        l_pac = self.fm.l_pac
        b1 = anchor.rb
        r1 = b1 >= l_pac
        flip = (l_pac << 1) - 1
        lo, hi = pes.low, pes.high
        for m in mate_regs:
            b2 = m.rb
            if (b2 >= l_pac) == r1:
                continue
            p2 = flip - b2
            if p2 > b1 and lo <= p2 - b1 <= hi:
                return True
        return False

    def _rescue_window(self, anchor: AlnReg, mate_seq: np.ndarray):
        """(rev_query, ref_window, rb) for one rescue DP, or None.

        Depends only on the anchor — independent of other rescue decisions,
        so windows can be built speculatively and the DPs batched."""
        opt, pes = self.opt, self.pair
        l_pac = self.fm.l_pac
        l_ms = len(mate_seq)
        # r=1: is_rev=True, is_larger=True
        rev = np.where(mate_seq < 4, 3 - mate_seq, 4).astype(np.uint8)[::-1]
        rb = anchor.rb + pes.low - l_ms
        re = anchor.rb + pes.high
        rb = max(rb, 0)
        re = min(re, l_pac << 1)
        if rb >= re:
            return None
        ref, rb, re, rid = self._fetch_clamped(rb, (rb + re) >> 1, re)
        if rid != anchor.rid or re - rb < opt.min_seed_len:
            return None
        return rev, ref, rb

    def _rescue_apply(self, anchor: AlnReg, mate_regs: List[AlnReg],
                      aln: "ksw.LocalResult", rb: int, l_ms: int) -> None:
        opt = self.opt
        l_pac = self.fm.l_pac
        if aln.score >= opt.min_seed_len and aln.qb >= 0:
            b = AlnReg(rid=anchor.rid, rescued=True)
            b.qb = l_ms - (aln.qe + 1)
            b.qe = l_ms - aln.qb
            b.rb = (l_pac << 1) - (rb + aln.te + 1)
            b.re = (l_pac << 1) - (rb + aln.tb)
            b.score = aln.score
            b.truesc = aln.score
            b.csub = aln.score2
            b.seedcov = min(b.re - b.rb, b.qe - b.qb) >> 1
            b.w = opt.band_width
            b.seedlen0 = min(b.re - b.rb, b.qe - b.qb)
            mate_regs.append(b)

    def mate_rescue(self, anchor: AlnReg, mate_seq: np.ndarray,
                    mate_regs: List[AlnReg]) -> int:
        """mem_matesw for one anchor region; appends rescued regions."""
        opt = self.opt
        l_ms = len(mate_seq)
        if l_ms == 0:
            return 0
        if self._rescue_skip(anchor, mate_regs):
            return 0
        win = self._rescue_window(anchor, mate_seq)
        if win is None:
            return 0
        rev, ref, rb = win
        aln = ksw.local_align(
            rev.astype(np.int64), ref.astype(np.int64), self.mat,
            opt.gap_open_del, opt.gap_extend_del, opt.gap_open_ins,
            opt.gap_extend_ins, opt.min_seed_len * opt.match_score)
        self._rescue_apply(anchor, mate_regs, aln, rb, l_ms)
        return 1

    def rescue_pairs_batch(self, pairs, score_delta: int,
                           local_align_fn=None) -> None:
        """Mate rescue for many pairs with the local-SW DPs batched.

        ``pairs``: list of (q1, q2, regs1, regs2); regs lists are mutated in
        place exactly as per-pair ``finish_pair`` rescue would (the anchor
        sets and DP windows are decision-independent, so the DPs run
        speculatively in two waves — rescue-read1 then rescue-read2 — and the
        sequential skip/append control flow replays against cached results).
        Bit-identical to the sequential path (tests/test_batch_engine.py).
        """
        opt = self.opt
        if local_align_fn is None:
            def local_align_fn(tasks):
                nat = ksw.local_align_batch_native(
                    tasks, self.mat, opt.gap_open_del, opt.gap_extend_del,
                    opt.gap_open_ins, opt.gap_extend_ins,
                    opt.min_seed_len * opt.match_score)
                if nat is not None:
                    return nat
                return [ksw.local_align(
                    rev.astype(np.int64), ref.astype(np.int64), self.mat,
                    opt.gap_open_del, opt.gap_extend_del, opt.gap_open_ins,
                    opt.gap_extend_ins,
                    opt.min_seed_len * opt.match_score)
                    for rev, ref in tasks]

        bests = [(max((r.score for r in regs1), default=0),
                  max((r.score for r in regs2), default=0))
                 for _, _, regs1, regs2 in pairs]

        # Both phases' DP windows are built up front and batched into ONE
        # local_align_fn call (one device dispatch). Phase-0 anchors (regs2)
        # are never mutated, so its plan is exact. Phase-1 anchors are the
        # regs1 contents at phase-1 replay time — the original entries (whose
        # windows we speculate here; _rescue_window depends only on the
        # anchor, so they are identical) plus any regions phase 0 rescued
        # into regs1. Those late anchors almost always hit the _rescue_skip
        # fast-out (their rescuer is a properly-oriented mate hit); the rare
        # survivor runs one host-native DP inline, bit-identical to the
        # device kernel (tests/test_sw_local.py).
        #
        # Pristine-skip pruning (exact): _rescue_skip(m, regs) is True iff
        # ANY properly-oriented mate hit is in range, and replay only ever
        # APPENDS to the reg lists — so skip-true against the pristine list
        # implies skip-true at replay time and the window is provably dead.
        # ~2/3 of planned DPs die here at hg38 scale; the replay loops below
        # still consult _rescue_skip, so a (None, None) marker is handled by
        # the existing window-was-None path without ever reaching it.
        tasks = []
        plans0 = []        # exact: list of (m, ti, rb) per pair
        plans1 = []        # speculative: {id(m): (ti, rb)} per pair
        for (q1, q2, regs1, regs2), (b1, b2) in zip(pairs, bests):
            plan = []
            num = 0
            for m in regs2:
                if num >= opt.max_matesw or len(q1) == 0:
                    break
                if m.score >= b2 - score_delta:
                    num += 1
                    if self._rescue_skip(m, regs1):
                        plan.append((m, None, None))
                        continue
                    win = self._rescue_window(m, q1)
                    if win is None:
                        plan.append((m, None, None))
                    else:
                        rev, ref, rb = win
                        plan.append((m, len(tasks), rb))
                        tasks.append((rev, ref))
            plans0.append(plan)
            spec = {}
            num = 0
            for m in regs1:
                if num >= opt.max_matesw or len(q2) == 0:
                    break
                if m.score >= b1 - score_delta:
                    num += 1
                    if self._rescue_skip(m, regs2):
                        spec[id(m)] = (None, None)
                        continue
                    win = self._rescue_window(m, q2)
                    if win is None:
                        spec[id(m)] = (None, None)
                    else:
                        rev, ref, rb = win
                        spec[id(m)] = (len(tasks), rb)
                        tasks.append((rev, ref))
            plans1.append(spec)
        alns = local_align_fn(tasks)

        # phase 0 replay: rescue read1 from regs2 anchors (appends to regs1)
        # (ti-None entries — pristine-skipped or window-less — short-circuit
        # before the skip probe; both paths continue, so order is immaterial)
        for (q1, q2, regs1, regs2), plan in zip(pairs, plans0):
            l_ms = len(q1)
            for m, ti, rb in plan:
                if ti is None:
                    continue
                if self._rescue_skip(m, regs1):
                    continue
                self._rescue_apply(m, regs1, alns[ti], rb, l_ms)

        # phase 1 replay: rescue read2 from the CURRENT regs1 anchors
        # (original entries served from the speculative plan; anchors that
        # phase 0 appended fall through to skip-check + inline host DP)
        for (q1, q2, regs1, regs2), spec, (b1, b2) in zip(pairs, plans1,
                                                          bests):
            l_ms = len(q2)
            num = 0
            for m in list(regs1):
                if num >= opt.max_matesw or l_ms == 0:
                    break
                if m.score < b1 - score_delta:
                    continue
                num += 1
                cached = spec.get(id(m), _MISS)
                if cached is not _MISS:
                    ti, rb = cached
                    if ti is None:
                        continue
                    if self._rescue_skip(m, regs2):
                        continue
                    self._rescue_apply(m, regs2, alns[ti], rb, l_ms)
                    continue
                # late anchor (rescued during phase 0): window building is
                # pure, so order vs the skip check is immaterial
                if self._rescue_skip(m, regs2):
                    continue
                win = self._rescue_window(m, q2)
                if win is None:
                    continue
                rev, ref, rb = win
                aln = ksw.local_align(
                    rev.astype(np.int64), ref.astype(np.int64), self.mat,
                    opt.gap_open_del, opt.gap_extend_del, opt.gap_open_ins,
                    opt.gap_extend_ins, opt.min_seed_len * opt.match_score)
                self._rescue_apply(m, regs2, aln, rb, l_ms)

    def align_pair(self, seq1: bytes, seq2: bytes, score_delta: int,
                   mems: Optional[Tuple[list, list]] = None,
                   regs: Optional[Tuple[list, list]] = None
                   ) -> Tuple[List[EasyAlignment], List[EasyAlignment]]:
        """GoBwaMemMateSW (gobwa.go:226-337): align both reads + mate rescue.

        ``mems`` optionally supplies precomputed SMEM lists for both mates
        (see ``collect_mems_many`` — callers batch the native seeding call
        across a whole barcode to amortize FFI overhead). ``regs`` supplies
        fully precomputed candidate regions (native mem_align1_batch),
        skipping align1 entirely.
        """
        q1 = encode_read(seq1)
        q2 = encode_read(seq2)
        if regs is not None:
            return self.finish_pair(q1, q2, regs[0], regs[1], score_delta)
        rbegs1 = rbegs2 = None
        if mems is not None:
            mems1, mems2 = mems
            if isinstance(mems1, tuple):
                mems1, rbegs1 = mems1
            if isinstance(mems2, tuple):
                mems2, rbegs2 = mems2
        else:
            # one native seeding call for both mates halves the FFI overhead
            mems1 = mems2 = None
            both = [q for q in (q1, q2) if len(q)]
            if both:
                nat = self.collect_mems_many(both)
                if nat is not None:
                    it = iter(nat)
                    if len(q1):
                        mems1 = next(it)
                    if len(q2):
                        mems2 = next(it)
        regs1 = self.align1(q1, mems1, rbegs1) if len(q1) else []
        regs2 = self.align1(q2, mems2, rbegs2) if len(q2) else []
        return self.finish_pair(q1, q2, regs1, regs2, score_delta)

    def collect_mems_many(self, qs: List[np.ndarray], with_rbegs: bool = False,
                          raw: bool = False) -> Optional[list]:
        """Native batched SMEM collection -> per-read Intv lists (or None).

        With ``with_rbegs``, also dereferences every seed occurrence's SA
        position in ONE batched native call and returns per-read
        ``(mems, rbegs)`` pairs (rbegs in ``enumerate_occurrences`` order).
        With ``raw``, mems stay (n, 5) int64 arrays instead of Intv lists
        (the native align1 path consumes them directly).
        """
        from ..index import native_ops
        from .seeding import Intv
        if with_rbegs and raw:
            fused = native_ops.collect_seeds_rbegs_batch(self.fm, qs,
                                                         self.opt)
            if fused is not None:
                mems, rbegs = fused
                return [(m, b.tolist()) for m, b in zip(mems, rbegs)]
        nat = native_ops.collect_seeds_batch(self.fm, qs, self.opt)
        if nat is None:
            return None
        if raw:
            mems_lists: list = nat
        else:
            mems_lists = [[Intv(*row) for row in arr.tolist()] for arr in nat]
        if not with_rbegs:
            return mems_lists
        # occurrence schedule inlined from chaining.enumerate_occurrences
        # (identical order; avoids requiring Intv objects)
        all_rows: list = []
        spans = []
        max_occ = self.opt.max_occ
        for arr in nat:
            o0 = len(all_rows)
            for x0, _x1, s, _qb, _qe in arr.tolist():
                step = s // max_occ if s > max_occ else 1
                k = 0
                count = 0
                while k < s and count < max_occ:
                    all_rows.append(x0 + k)
                    k += step
                    count += 1
            spans.append((o0, len(all_rows) - o0))
        if all_rows:
            rows = np.array(all_rows, dtype=np.int64)
            nb = native_ops.sa_lookup_batch(self.fm, rows)
            if nb is None:
                nb = np.array([self.fm.sa_lookup(int(r)) for r in rows],
                              dtype=np.int64)
            flat = nb.tolist()
        else:
            flat = []
        return [(mems, flat[o:o + c])
                for mems, (o, c) in zip(mems_lists, spans)]

    def finish_pair(self, q1, q2, regs1, regs2, score_delta: int,
                    skip_rescue: bool = False
                    ) -> Tuple[List[EasyAlignment], List[EasyAlignment]]:
        """Mate rescue + interpretation half of GoBwaMemMateSW.

        ``skip_rescue``: the regs lists are already post-rescue (a device
        priming pass ran ``rescue_pairs_batch``); only interpret.
        """
        if skip_rescue:
            return ([self.interpret_align(r) for r in regs1],
                    [self.interpret_align(r) for r in regs2])
        opt = self.opt
        best1 = max((r.score for r in regs1), default=0)
        best2 = max((r.score for r in regs2), default=0)
        # rescue read1 from read2's good hits (snapshot of regs2 pre-rescue)
        num = 0
        for m in list(regs2):
            if num >= opt.max_matesw or len(q1) == 0:
                break
            if m.score >= best2 - score_delta:
                num += 1
                self.mate_rescue(m, q1, regs1)
        # rescue read2 from the UPDATED read1 list (gobwa.go:302-324)
        num = 0
        for m in list(regs1):
            if num >= opt.max_matesw or len(q2) == 0:
                break
            if m.score >= best1 - score_delta:
                num += 1
                self.mate_rescue(m, q2, regs2)
        return ([self.interpret_align(r) for r in regs1],
                [self.interpret_align(r) for r in regs2])

    # ------------------------------------------------------------- interpret

    def interpret_many(self, regs: List[AlnReg]) -> List[EasyAlignment]:
        """Vectorized interpret_align over many regions (identical output;
        the coordinate unprojection is pure elementwise math)."""
        n = len(regs)
        if n < 8:
            return [self.interpret_align(r) for r in regs]
        fm = self.fm
        rb = np.fromiter((r.rb for r in regs), np.int64, n)
        re_ = np.fromiter((r.re for r in regs), np.int64, n)
        rid = np.fromiter((r.rid for r in regs), np.int64, n)
        offs = getattr(fm, "_contig_offs", None)
        if offs is None:
            offs = np.array([c.offset for c in fm.contigs], dtype=np.int64)
            fm._contig_offs = offs
        offv = offs[rid]
        rev = rb >= fm.l_pac
        offset = (np.where(rev, fm.seq_len - 1 - rb, rb) - offv).tolist()
        aend = (np.where(re_ < fm.l_pac, re_, fm.seq_len - 1 - re_)
                - offv).tolist()
        rev_l = rev.tolist()
        contigs = fm.contigs
        rid_l = rid.tolist()
        return [EasyAlignment(offset=offset[i], alignment_end=aend[i],
                              contig=contigs[rid_l[i]].name,
                              reversed_=rev_l[i], region=r, score=r.score,
                              secondary=False, read_s=r.qb, read_e=r.qe)
                for i, r in enumerate(regs)]

    def interpret_align(self, reg: AlnReg) -> EasyAlignment:
        """InterpretAlign (gobwa.go:339-371): unproject doubled coordinates."""
        fm = self.fm
        c = fm.contigs[reg.rid]
        if reg.rb < fm.l_pac:
            offset = reg.rb - c.offset
            rev = False
        else:
            offset = fm.seq_len - 1 - reg.rb - c.offset
            rev = True
        if reg.re < fm.l_pac:
            aend = reg.re - c.offset
        else:
            aend = fm.seq_len - 1 - reg.re - c.offset
        return EasyAlignment(offset=int(offset), alignment_end=int(aend),
                             contig=c.name, reversed_=rev, region=reg,
                             score=reg.score, secondary=False,
                             read_s=reg.qb, read_e=reg.qe)

    # --------------------------------------------------------------- reg2aln

    @staticmethod
    def _infer_bw(l1: int, l2: int, score: int, a: int, q: int, r: int) -> int:
        if l1 == l2 and l1 * a - score < (q + r - a) << 1:
            return 0
        w = int((min(l1, l2) * a - score - q) / r + 2.0)
        return max(w, abs(l1 - l2))

    def _gen_cigar(self, query: np.ndarray, rb: int, re: int, w: int
                   ) -> Tuple[Optional[List[Tuple[int, int]]], int, int]:
        """bwa_gen_cigar2: global align [rb,re) vs query; (cigar, score, NM)."""
        opt, fm = self.opt, self.fm
        l_query = len(query)
        if l_query <= 0 or rb >= re or (rb < fm.l_pac < re):
            return None, 0, -1
        rseq = fm.fetch_fmd(rb, re).astype(np.int64)
        q = query.astype(np.int64)
        if rb >= fm.l_pac:  # reverse both to leftmost-place indels
            q = q[::-1].copy()
            rseq = rseq[::-1].copy()
        if l_query == re - rb and w == 0:
            cigar = [(OP_M, l_query)]
            score = int(self.mat[rseq, q].sum())
        else:
            score, raw = ksw.global_align(
                q, rseq, self.mat, opt.gap_open_del, opt.gap_extend_del,
                opt.gap_open_ins, opt.gap_extend_ins, w)
            cigar = raw if raw else None
        if cigar is None:
            return None, score, -1
        return cigar, score, cigar_nm(cigar, q, rseq)

    def reg2aln_batch(self, tasks) -> List["SingleReadAlignment"]:
        """mem_reg2aln for many (seq, reg) tasks; native C++ when built.

        (BatchAlignmentEngine overrides this with the device-wave version.)
        """
        from . import native_engine
        out = native_engine.reg2aln_batch(self.fm, self.opt, tasks)
        if out is not None:
            return out
        return [self.reg2aln(seq, reg) for seq, reg in tasks]

    def reg2aln(self, seq: bytes, reg: Optional[AlnReg]) -> SingleReadAlignment:
        """mem_reg2aln: final banded global alignment -> CIGAR/NM/position."""
        opt = self.opt
        if reg is None or reg.rb < 0 or reg.re < 0:
            return SingleReadAlignment()
        query = encode_read(seq)
        l_query = len(query)
        qb, qe, rb, re = reg.qb, reg.qe, reg.rb, reg.re
        w2 = max(
            self._infer_bw(qe - qb, re - rb, reg.truesc, opt.match_score,
                           opt.gap_open_del, opt.gap_extend_del),
            self._infer_bw(qe - qb, re - rb, reg.truesc, opt.match_score,
                           opt.gap_open_ins, opt.gap_extend_ins))
        if w2 > opt.band_width:
            w2 = min(w2, reg.w)
        i = 0
        last_sc = -(1 << 30)
        cigar = None
        NM = -1
        while True:
            w2 = min(w2, opt.band_width << 2)
            cigar, score, NM = self._gen_cigar(query[qb:qe], rb, re, w2)
            if score == last_sc or w2 == opt.band_width << 2:
                break
            last_sc = score
            w2 <<= 1
            i += 1
            if not (i < 3 and score < reg.truesc - opt.match_score):
                break
        return self._place(reg, l_query, cigar, NM)

    def _place(self, reg: AlnReg, l_query: int,
               cigar: Optional[List[Tuple[int, int]]], NM: int
               ) -> SingleReadAlignment:
        """mem_reg2aln's tail after the band ladder: the forward-strand
        position, leading/trailing deletions squeezed, soft clips added."""
        fm = self.fm
        qb, qe, rb, re = reg.qb, reg.qe, reg.rb, reg.re
        # position: forward-strand 5' coordinate
        dpos = rb if rb < fm.l_pac else re - 1
        is_rev = dpos >= fm.l_pac
        pos = (fm.seq_len - 1 - dpos) if is_rev else dpos
        cigar = list(cigar) if cigar else []
        if cigar:  # squeeze leading/trailing deletions
            if cigar[0][0] == OP_D:
                pos += cigar[0][1]
                cigar.pop(0)
            elif cigar[-1][0] == OP_D:
                cigar.pop()
        if qb != 0 or qe != l_query:  # add soft clips (SAM orientation)
            clip5 = l_query - qe if is_rev else qb
            clip3 = qb if is_rev else l_query - qe
            if clip5 > 0:
                cigar.insert(0, (OP_S, clip5))
            if clip3 > 0:
                cigar.append((OP_S, clip3))
        rid = fm.pos_to_contig(pos)
        return SingleReadAlignment(
            pos=int(pos - fm.contigs[rid].offset), rid=rid,
            chrom=fm.contigs[rid].name, reversed_=bool(is_rev),
            edit_distance=int(NM), cigar=tuple(cigar), score=reg.score,
            sub=max(reg.sub, reg.csub), read_s=reg.qb, read_e=reg.qe)
