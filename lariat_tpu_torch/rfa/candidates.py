"""Candidate generation: chains -> scored Alignment lists -> initial picks.

Equivalents of the reference's GetChains (lariat.go:1706-1788), GetAlignments
(lariat.go:1552-1704) and tagBestAlignments (lariat.go:1466-1549), driven by
the TPU-native alignment engine instead of the C library.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional, Tuple

import numpy as np

from ..align.engine import AlignmentEngine, EasyAlignment, OP_M, OP_I, OP_D, OP_S
from ..io.fastq import FastQRecord
from ..utils.gorand import FastF64, GoRand
from .scoring import is_pair, pair_total_matrix, score_alignment
from .types import Alignment, MapQData


@dataclasses.dataclass(slots=True)
class ChainedHit:
    """ChainedHit (lariat.go:50-66): one candidate region for one read."""
    contig: str = ""
    pos: int = -1
    aend: int = 0
    read_id: int = 0
    mate_id: int = 0
    hit_id: int = 0
    secondary: bool = False
    read1: bool = True
    score: int = 0
    ea: Optional[EasyAlignment] = None   # None = placeholder for unmapped
    fastq: Optional[FastQRecord] = None
    # final-SW result precomputed by a device priming pass (one per region,
    # same order as the regs); None = compute in get_alignments
    sra: Optional[object] = None


def get_chains(engine: AlignmentEngine, reads: List[FastQRecord],
               score_delta: int,
               primed_regions=None) -> Tuple[List[List[ChainedHit]], str]:
    """GetChains: per pair candidate generation incl. mate rescue.

    When the engine supports batching, the per-read candidate generation for
    the whole barcode runs as one device batch; mate rescue and result
    interpretation replay per pair (identical output).
    """
    pair_results = None
    pair_sras = None
    cache = getattr(engine, "_pair_cache", None)
    if primed_regions is not None:
        from ..align.engine import encode_read
        # (regs1, regs2) = pre-rescue; (regs1, regs2, True) = the priming
        # pass already ran device-batched mate rescue; a 5-tuple adds
        # per-region final-SW results (reg2aln primed on device too).
        # Fully-primed pairs skip finish_pair: one barcode-wide
        # interpret_many replaces the per-pair interpret loops.
        all_rescued = all(len(p) > 2 and p[2] for p in primed_regions)
        if all_rescued and hasattr(engine, "interpret_many"):
            flat_regs = []
            counts = []
            for primed in primed_regions:
                flat_regs.extend(primed[0])
                flat_regs.extend(primed[1])
                counts.append((len(primed[0]), len(primed[1])))
            eas = engine.interpret_many(flat_regs)
            pair_results = []
            off = 0
            for k, (n1, n2) in enumerate(counts):
                pair_results.append((eas[off:off + n1],
                                     eas[off + n1:off + n1 + n2]))
                off += n1 + n2
                primed = primed_regions[k]
                if len(primed) > 4:
                    if pair_sras is None:
                        pair_sras = [None] * len(reads)
                    pair_sras[k] = (primed[3], primed[4])
        else:
            pair_results = []
            for rec, primed in zip(reads, primed_regions):
                regs1, regs2 = primed[0], primed[1]
                rescued = len(primed) > 2 and primed[2]
                if len(primed) > 4:
                    if pair_sras is None:
                        pair_sras = [None] * len(reads)
                    pair_sras[len(pair_results)] = (primed[3], primed[4])
                pair_results.append(engine.finish_pair(
                    encode_read(rec.read1), encode_read(rec.read2),
                    regs1, regs2, score_delta, skip_rescue=rescued))
    elif cache is not None and reads and id(reads[0]) in cache:
        pair_results = [cache.pop(id(rec)) for rec in reads]
    elif hasattr(engine, "align_batch") and reads:
        from ..align.engine import encode_read
        seqs = []
        for rec in reads:
            seqs.append(rec.read1)
            seqs.append(rec.read2)
        all_regs = engine.align_batch(seqs)
        pair_results = []
        for i, rec in enumerate(reads):
            q1 = encode_read(rec.read1)
            q2 = encode_read(rec.read2)
            pair_results.append(engine.finish_pair(
                q1, q2, all_regs[2 * i] if len(q1) else [],
                all_regs[2 * i + 1] if len(q2) else [], score_delta))
    # non-batched engines: one native seeding call for the whole barcode
    barcode_mems = None
    barcode_regs = None
    if (pair_results is None and reads
            and hasattr(engine, "collect_mems_many")):
        from ..align.engine import encode_read
        qs, where = [], []
        for i, rec in enumerate(reads):
            for k, seq in enumerate((rec.read1, rec.read2)):
                q = encode_read(seq)
                if len(q):
                    qs.append(q)
                    where.append(2 * i + k)
        mems_all = (engine.collect_mems_many(qs, with_rbegs=True, raw=True)
                    if qs else [])
        if mems_all is not None:
            # full C++ candidate generation for the whole barcode in one call
            nat_regs = None
            if qs:
                from ..align import native_engine
                nat_regs = native_engine.align1_batch(
                    engine.fm, engine.opt, qs,
                    [m for m, _ in mems_all], [b for _, b in mems_all])
            if nat_regs is not None:
                flat_r = [[] for _ in range(2 * len(reads))]
                for slot, rg in zip(where, nat_regs):
                    flat_r[slot] = rg
                barcode_regs = [(flat_r[2 * i], flat_r[2 * i + 1])
                                for i in range(len(reads))]
                if hasattr(engine, "rescue_pairs_batch"):
                    # batch the whole barcode's mate-rescue DPs into one
                    # native call (bit-identical replay, engine.py:224),
                    # then finish each pair with rescue already applied
                    enc = [(encode_read(rec.read1), encode_read(rec.read2))
                           for rec in reads]
                    engine.rescue_pairs_batch(
                        [(q1, q2, r1, r2) for (q1, q2), (r1, r2)
                         in zip(enc, barcode_regs)], score_delta)
                    pair_results = [
                        engine.finish_pair(q1, q2, r1, r2, score_delta,
                                           skip_rescue=True)
                        for (q1, q2), (r1, r2) in zip(enc, barcode_regs)]
            else:
                from ..align.seeding import Intv
                flat = [None] * (2 * len(reads))
                for slot, (m, b) in zip(where, mems_all):
                    if isinstance(m, np.ndarray):
                        m = [Intv(*row) for row in m.tolist()]
                    flat[slot] = (m, b)
                barcode_mems = [(flat[2 * i], flat[2 * i + 1])
                                for i in range(len(reads))]
    out: List[List[ChainedHit]] = []
    hit_num = 0
    barcode = ""
    for i, rec in enumerate(reads):
        if pair_results is not None:
            ea1, ea2 = pair_results[i]
        else:
            ea1, ea2 = engine.align_pair(
                rec.read1, rec.read2, score_delta,
                mems=None if barcode_mems is None else barcode_mems[i],
                regs=None if barcode_regs is None else barcode_regs[i])
        barcode = rec.barcode10x.decode()
        sras1, sras2 = (pair_sras[i] if pair_sras is not None
                        and pair_sras[i] is not None else (None, None))
        lst1: List[ChainedHit] = []
        for j, ea in enumerate(ea1):
            lst1.append(ChainedHit(
                contig=ea.contig, pos=ea.offset, aend=ea.alignment_end,
                read_id=i * 2, mate_id=i * 2 + 1, hit_id=hit_num, read1=True,
                secondary=ea.secondary, score=ea.score, ea=ea, fastq=rec,
                sra=sras1[j] if sras1 is not None else None))
            hit_num += 1
        if not lst1:
            lst1.append(ChainedHit(read_id=i * 2, mate_id=i * 2 + 1, pos=-1,
                                   read1=True, ea=None, fastq=rec))
            hit_num += 1
        out.append(lst1)
        lst2: List[ChainedHit] = []
        for j, ea in enumerate(ea2):
            lst2.append(ChainedHit(
                contig=ea.contig, pos=ea.offset, aend=ea.alignment_end,
                read_id=i * 2 + 1, mate_id=i * 2, hit_id=hit_num, read1=False,
                secondary=ea.secondary, score=ea.score, ea=ea, fastq=rec,
                sra=sras2[j] if sras2 is not None else None))
            hit_num += 1
        if not lst2:
            lst2.append(ChainedHit(read_id=i * 2 + 1, mate_id=i * 2, pos=-1,
                                   hit_id=hit_num, read1=False, ea=None,
                                   fastq=rec))
            hit_num += 1
        out.append(lst2)
    return out, barcode


def get_alignments(engine: AlignmentEngine, barcode_chains: List[List[ChainedHit]],
                   delta: int, improper_pair_penalty: float
                   ) -> Tuple[List[List[Alignment]], List[List[Alignment]]]:
    """GetAlignments: final SW per candidate + mismatch-locus CIGAR walk.

    Returns (filtered within delta of per-read best, full lists), both indexed
    by read_id.
    """
    n = len(barcode_chains)
    filtered: List[List[Alignment]] = [[] for _ in range(n)]
    full: List[List[Alignment]] = [[] for _ in range(n)]
    contig_ids: dict = {}
    # batched final SW when available: one device wave for every candidate
    sra_cache = None
    if hasattr(engine, "reg2aln_batch"):
        tasks = []
        keys = []
        sra_cache = {}
        for chain_list in barcode_chains:
            for ch in chain_list:
                if ch.ea is None:
                    continue
                if ch.sra is not None:   # primed on device
                    sra_cache[id(ch)] = ch.sra
                else:
                    tasks.append((ch.fastq.read1 if ch.read1
                                  else ch.fastq.read2, ch.ea.region))
                    keys.append(id(ch))
        if tasks:
            sra_cache.update(zip(keys, engine.reg2aln_batch(tasks)))
    # batched native CIGAR walks (mismatch loci + op counts) per barcode;
    # preferred variant fetches reference windows inside C++ from the codes
    # cache (no per-candidate get_seq)
    walk_cache = None
    if sra_cache is not None:
        from ..align import native_engine
        contigs = engine.fm.contigs
        walk_rows = []
        walk_keys = []
        for chain_list in barcode_chains:
            for ch in chain_list:
                if ch.ea is None or ch.pos == -1:
                    continue
                sra = sra_cache[id(ch)]
                if sra is None:
                    continue
                ref_start, ref_end = ch.pos, ch.aend
                if sra.reversed_:
                    ref_start, ref_end = ch.aend + 1, ch.pos + 1
                read_seq = ch.fastq.read1 if ch.read1 else ch.fastq.read2
                walk_rows.append((sra, read_seq, ref_start, ref_end))
                walk_keys.append(id(ch))
        walked = native_engine.mismatch_walk_fetch_batch(
            engine.fm,
            [(sra.cigar, read_seq, contigs[sra.rid].offset, rs, re_,
              sra.reversed_)
             for sra, read_seq, rs, re_ in walk_rows]) if walk_rows else []
        if walked is None:
            walk_tasks = [
                (sra.cigar,
                 engine.fm.get_seq(sra.chrom, rs, re_, sra.reversed_),
                 read_seq, rs, re_, sra.reversed_)
                for sra, read_seq, rs, re_ in walk_rows]
            walked = (native_engine.mismatch_walk_batch(walk_tasks)
                      if walk_tasks else [])
        if walked is not None:
            walk_cache = dict(zip(walk_keys, walked))
    for chain_list in barcode_chains:
        best_score = 0
        for ch in chain_list:
            if ch.score > best_score:
                best_score = ch.score
        for ch in chain_list:
            read_seq = ch.fastq.read1 if ch.read1 else ch.fastq.read2
            if ch.ea is not None:
                if sra_cache is not None:
                    sra = sra_cache[id(ch)]
                else:
                    sra = engine.reg2aln(read_seq, ch.ea.region)
            else:
                sra = None
            matches = 0
            indels = 0
            indel_length = 0
            soft_clipping = 0
            soft_clipping_length = 0
            mismatch_locs: List[int] = []
            mismatch_read_locs: List[int] = []
            reversed_ = sra.reversed_ if sra else False
            cigar = sra.cigar if sra else ()
            if (sra is not None and ch.pos != -1 and walk_cache is not None
                    and id(ch) in walk_cache):
                (matches, indels, indel_length, soft_clipping,
                 soft_clipping_length, mismatch_locs,
                 mismatch_read_locs) = walk_cache[id(ch)]
            elif sra is not None and ch.pos != -1:
                ref_start, ref_end = ch.pos, ch.aend
                if reversed_:
                    ref_start, ref_end = ch.aend + 1, ch.pos + 1
                ref_seq = engine.fm.get_seq(sra.chrom, ref_start, ref_end,
                                            reversed_)
                ref_off = 0
                read_off = 0
                ops = list(cigar)
                if reversed_:
                    ops = ops[::-1]
                import numpy as np
                ref_arr = np.frombuffer(ref_seq, dtype=np.uint8)
                read_arr = np.frombuffer(read_seq, dtype=np.uint8)
                for op, ln in ops:
                    if op == OP_M:
                        matches += ln
                        # vectorized mismatch scan with the reference's
                        # boundary semantics: positions past the fetched ref
                        # are skipped; past the read is an invariant breach
                        n_ref = min(ln, max(len(ref_arr) - ref_off, 0))
                        if read_off + n_ref > len(read_arr):
                            raise RuntimeError(
                                "cigar longer than read: %r" % (cigar,))
                        if n_ref > 0:
                            diff = np.nonzero(
                                ref_arr[ref_off:ref_off + n_ref]
                                != read_arr[read_off:read_off + n_ref])[0]
                            for m in diff:
                                m = int(m)
                                if reversed_:
                                    mismatch_locs.append(
                                        ref_end - (ref_off + m))
                                else:
                                    mismatch_locs.append(
                                        ref_off + ref_start + m)
                                mismatch_read_locs.append(read_off + m)
                        ref_off += ln
                        read_off += ln
                    elif op == OP_I:
                        indels += 1
                        indel_length += ln
                        read_off += ln
                    elif op == OP_D:
                        indels += 1
                        indel_length += ln
                        ref_off += ln
                    elif op == OP_S:
                        soft_clipping += 1
                        soft_clipping_length += ln
                        read_off += ln
            mismatches = (sra.edit_distance if sra else 0) - indel_length
            matches -= mismatches
            if mismatches < 0:
                mismatches = 0
            pos, aend = ch.pos, ch.aend
            if pos != -1 and reversed_:
                pos = ch.aend + 1
                aend = ch.pos + 1
            contig = sra.chrom if sra else ""
            cid = contig_ids.get(contig)
            if cid is None:
                cid = len(contig_ids)
                contig_ids[contig] = cid
            aln = Alignment(
                id=ch.hit_id, aend=aend, fastq=ch.fastq, matches=matches,
                mismatches=mismatches, mismatch_locs=mismatch_locs,
                mismatch_read_locs=mismatch_read_locs, indels=indels,
                soft_clipped=soft_clipping,
                soft_clipped_length=soft_clipping_length, read1=ch.read1,
                mapq_data=MapQData(), contig=contig, contig_id=cid,
                pos=pos, molecule_id=-1, score=ch.score,
                cigar=cigar, read_id=ch.read_id, mate_id=ch.mate_id,
                reversed_=reversed_)
            aln.log_alignment_probability = score_alignment(
                aln, None, 0.0, improper_pair_penalty) - improper_pair_penalty
            aln.updated_log_alignment_probability = (
                aln.log_alignment_probability + 2.0 * len(mismatch_locs))
            if ch.ea is not None:
                aln.readmap_s = ch.ea.read_s
                aln.readmap_e = ch.ea.read_e
            full[ch.read_id].append(aln)
            if aln.score >= best_score - delta:
                filtered[ch.read_id].append(aln)
    return filtered, full


def tag_best_alignments(alignments: List[List[Alignment]],
                        improper_pair_penalty: float,
                        stats=None) -> List[List[Alignment]]:
    """tagBestAlignments: md5-seeded noisy initial pick + position buckets.

    Returns per-contig position-sorted alignment lists.

    When ``stats`` (RFAStats) is given, counts tie-sensitive picks: reads
    whose top-2 noiseless pair totals differ by < 0.5 — the only reads
    where a different tie-break RNG stream (the Go rngCooked divergence,
    docs/PARITY.md) could change the initial pick. The rate is the tracked
    SAM-parity bound (VERDICT r4 item 7).
    """
    positions: List[List[Alignment]] = []
    contigs = {}
    touched = [False] * len(alignments)
    seeds = []
    for arr in alignments:
        seed = 1
        if arr:
            digest = hashlib.md5(arr[0].read_name.encode()).digest()
            seed_u = int.from_bytes(digest[0:8], "little")
            seed = seed_u - (1 << 64) if seed_u >= (1 << 63) else seed_u
        seeds.append(seed)
    # few draws per read: precompute a short exact prefix per seed (FastF64
    # falls back to the full generator for the rare read that outdraws it);
    # size the prefix to the vectorized pick's draw count (capped at the
    # fast path's validity bound)
    if seeds:
        k = 16
        for arr in alignments:
            if arr:
                n_m = len(alignments[arr[0].mate_id])
                k = max(k, len(arr) * n_m if n_m else len(arr))
        rows = GoRand.batch_first_floats(seeds, min(k, 273))
        randoms = [FastF64(s, rows[i]) for i, s in enumerate(seeds)]
    else:
        randoms = []
    for read_id, arr in enumerate(alignments):
        was_touched = touched[read_id]
        best_score = -float("inf")
        best_alignment: Optional[Alignment] = None
        best_mate: Optional[Alignment] = None
        random = randoms[read_id]
        mates = alignments[arr[0].mate_id] if arr else []
        n_a, n_m = len(arr), len(mates)
        n_need = n_a * n_m if n_m else n_a
        same_mate = all(a.mate_id == arr[0].mate_id for a in arr)
        if n_need >= 32 and same_mate:
            # vectorized pick, bit-identical to the scalar loop below: the
            # draw stream is consumed in the same order, additions replay
            # the scalar order, and argmax keeps the first maximum exactly
            # like the strict-> running compare
            dr = random.float64_n(n_need) / 2.0
            if n_m:
                tot = pair_total_matrix(arr, mates, improper_pair_penalty,
                                        0.0)
                base = tot.ravel()
                flat = (tot + dr.reshape(n_a, n_m)).ravel()
            else:
                base = np.array([float(a.score) for a in arr])
                flat = base + dr
            ki = int(np.argmax(flat))
            best_score = float(flat[ki])
            best_alignment = arr[ki // n_m] if n_m else arr[ki]
            best_mate = mates[ki % n_m] if n_m else None
            if stats is not None and not was_touched and base.size > 1:
                top2 = np.partition(base, base.size - 2)[-2:]
                stats.picks += 1
                stats.tie_picks += int(top2[1] - top2[0] < 0.5)
            for aln in arr:
                if read_id != aln.read_id:
                    raise RuntimeError("read id mismatch")
                idx = contigs.get(aln.contig)
                if idx is not None:
                    positions[idx].append(aln)
                else:
                    contigs[aln.contig] = len(positions)
                    positions.append([aln])
        else:
            nl1 = nl2 = -float("inf")   # top-2 noiseless totals (tie rate)
            for aln in arr:
                if read_id != aln.read_id:
                    raise RuntimeError("read id mismatch")
                mates = alignments[aln.mate_id]
                for mate in mates:
                    base = score_alignment(aln, mate, 0.0,
                                           improper_pair_penalty)
                    total = base + random.float64() / 2.0
                    if base > nl1:
                        nl1, nl2 = base, nl1
                    elif base > nl2:
                        nl2 = base
                    if total > best_score:
                        best_score = total
                        best_alignment = aln
                        best_mate = mate
                if not mates:
                    base = float(aln.score)
                    sc = base + random.float64() / 2.0
                    if base > nl1:
                        nl1, nl2 = base, nl1
                    elif base > nl2:
                        nl2 = base
                    if sc > best_score:
                        best_score = sc
                        best_alignment = aln
                idx = contigs.get(aln.contig)
                if idx is not None:
                    positions[idx].append(aln)
                else:
                    contigs[aln.contig] = len(positions)
                    positions.append([aln])
            if stats is not None and not was_touched and arr:
                stats.picks += 1
                stats.tie_picks += int(nl1 - nl2 < 0.5)
        if not was_touched and best_alignment is not None:
            best_alignment.active = True
            best_alignment.bwa_pick = True
            if best_mate is not None:
                if is_pair(best_alignment, best_mate):
                    best_alignment.is_proper = True
                    best_mate.is_proper = True
                best_mate.active = True
                best_mate.bwa_pick = True
                touched[best_mate.read_id] = True
    for plist in positions:
        plist.sort(key=lambda a: a.pos)
    return positions
