"""Lariat-compatible BAM emission: dual outputs, flags, TLEN, aux tags.

Equivalent of the reference's BAM writer (``inference/bamwriter.go``):
 - one barcode-sorted BAM plus position-bucketed BAMs (<=40 Mbp chunks per
   contig, small contigs packed, names ``NNNNNN-contig_OFFSET_pos_bucketed.bam``
   and ``ZZZ_unmapped_pos_bucketed.bam``) for downstream ``samtools cat``
   (bamwriter.go:133-191);
 - record building: flag bits, unmapped demotion, TLEN, reverse-complement,
   hard-clipped split-read secondaries, the full aux tag set
   (bamwriter.go:286-568).
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Tuple

from ..rfa.scoring import is_pair
from ..rfa.types import Alignment
from .bam import (BAMRecord, BAMWriter, aux_int, aux_string,
                  build_header_text)

# internal (bwa MIDSH) -> SAM op codes (bamwriter.go:251-257)
CIGAR_TABLE = [0, 1, 2, 4, 5]
CIGAR_CHAR = "MIDS"
COMPLEMENT = bytes.maketrans(b"ACGTacgtNn", b"TGCATGCANN")


def reverse_comp(seq: bytes) -> bytes:
    return seq.translate(COMPLEMENT)[::-1]


_QUAL_TABLE = bytes(max(b - 33, 0) for b in range(256))


def fix_qual(q: bytes) -> bytes:
    return q.translate(_QUAL_TABLE)


def hard_clip(seq: bytes, qual: bytes, cigar: List[Tuple[int, int]]
              ) -> Tuple[bytes, bytes, List[Tuple[int, int]]]:
    """Soft->hard clip conversion for secondaries (bamwriter.go:663-688).
    Operates on SAM-coded cigars (4=S, 5=H)."""
    start, end = 0, len(seq)
    nc = list(cigar)
    if len(nc) >= 1 and nc[0][0] == 4:
        start = nc[0][1]
        nc[0] = (5, nc[0][1])
    if len(nc) >= 2 and nc[-1][0] == 4:
        end -= nc[-1][1]
        nc[-1] = (5, nc[-1][1])
    return seq[start:end], qual[start:end], nc


class LariatBAMs:
    """BarcodeSortedBam + PositionBucketedBams + unmapped bucket."""

    def __init__(self, contigs: List[Tuple[str, int]], base_path: str,
                 read_groups: str, sample_id: str, position_chunk_size: int,
                 debug_tags: bool, first_chunk: bool,
                 version: str = "lariat_tpu", cl: str = "lariat_tpu"):
        self.contigs = contigs
        self.tid = {name: i for i, (name, _) in enumerate(contigs)}
        self.position_chunk_size = position_chunk_size
        self.debug_tags = debug_tags
        os.makedirs(base_path, exist_ok=True)
        names = [c[0] for c in contigs]
        lengths = [c[1] for c in contigs]

        def make(path: str, chunk_first: bool) -> BAMWriter:
            return BAMWriter(open(path, "wb"),
                             build_header_text(contigs, read_groups, sample_id,
                                               version, cl, chunk_first),
                             names, lengths)

        self.barcode_sorted = make(os.path.join(base_path, "bc_sorted_bam.bam"),
                                   first_chunk)
        self.position_bucketed: Dict[str, List[BAMWriter]] = {}
        self._all_writers = [self.barcode_sorted]
        chr_first = first_chunk
        last_writer: Optional[BAMWriter] = None
        running = 0
        for index, (name, length) in enumerate(contigs):
            num_chunks = int(math.ceil(length / position_chunk_size))
            buckets: List[BAMWriter] = [None] * max(num_chunks, 1)
            idx_str = f"{index:06d}"
            if num_chunks > 1:
                for ci in range(num_chunks):
                    off_str = f"{ci * position_chunk_size:010d}"
                    w = make(os.path.join(
                        base_path,
                        f"{idx_str}-{name}_{off_str}_pos_bucketed.bam"),
                        chr_first)
                    chr_first = False
                    buckets[ci] = w
                    self._all_writers.append(w)
            else:
                if running == 0 or running + length > position_chunk_size:
                    last_writer = make(os.path.join(
                        base_path,
                        f"{idx_str}-{name}_0000000000_pos_bucketed.bam"),
                        chr_first)
                    chr_first = False
                    self._all_writers.append(last_writer)
                    running = length
                else:
                    running += length
                buckets[0] = last_writer
            self.position_bucketed[name] = buckets
        unmapped = make(os.path.join(base_path,
                                     "ZZZ_unmapped_pos_bucketed.bam"),
                        first_chunk)
        self.position_bucketed["unmapped"] = [unmapped]
        self._all_writers.append(unmapped)

    def close(self) -> None:
        seen = set()
        for w in self._all_writers:
            if id(w) not in seen:
                seen.add(id(w))
                w.close()

    # ------------------------------------------------------------- emission

    def _bucket_for(self, aln: Alignment, unmapped: bool) -> BAMWriter:
        if unmapped:
            return self.position_bucketed["unmapped"][0]
        return self.position_bucketed[aln.contig][
            aln.pos // self.position_chunk_size]

    def dump(self, alignments: List[List[Alignment]], attach_bx: bool) -> None:
        """DoDumpToBam (bamwriter.go:634-657)."""
        for arr in alignments:
            if not arr:
                raise RuntimeError("not all read_ids are spoken for")
            read_output = False
            for aln in arr:
                if aln.active:
                    self.append_bams(aln, aln, attach_bx)
                    if aln.secondary is not None:
                        self.append_bams(aln.secondary, aln, attach_bx)
                    read_output = True
            if not read_output:
                raise RuntimeError("read_id has no active alignment")

    def append_bams(self, aln: Alignment, primary: Alignment,
                    attach_bx: bool) -> None:
        rec = build_record(aln, primary, attach_bx, self.tid,
                           self.debug_tags).pack()   # pack ONCE, write twice
        self.barcode_sorted._bgzf.write(rec)
        self._bucket_for(aln, aln.is_unmapped())._bgzf.write(rec)


def build_record(aln: Alignment, primary: Alignment, attach_bx: bool,
                 tid: dict, debug_tags: bool) -> BAMRecord:
        """AppendBam (bamwriter.go:286-568)."""
        rec = BAMRecord()
        flags = 0
        if (not aln.is_proper) and aln.score - 17 < 19:
            aln.pos = -1
            aln.mapq = 0
        mate = primary.mate_alignment
        if aln.mate_id >= 0:
            flags |= 1
            if aln.is_proper:
                if aln is primary:
                    flags |= 0x2
                elif mate is not None and is_pair(aln, mate):
                    flags |= 0x2
            if mate is None or mate.pos == -1 or (
                    not primary.is_proper and mate.score - 17 < 19):
                flags |= 0x8
                rec.mate_pos = -1
                rec.mate_ref_id = -1
            else:
                if mate.reversed_:
                    flags |= 0x20
                rec.mate_ref_id = tid.get(mate.contig, -1)
                rec.mate_pos = int(mate.pos)
            if aln.read1:
                flags |= 0x40
            else:
                flags |= 0x80
            if aln.duplicate:
                flags |= 0x400
            if mate is None or mate.pos == -1:
                rec.mate_ref_id = -1
                rec.tlen = 0
            elif aln is primary:
                if (aln.contig == mate.contig
                        and (primary.is_proper or mate.score - 17 >= 19)):
                    if aln.reversed_:
                        rec.tlen = -int(aln.aend - mate.pos)
                    else:
                        rec.tlen = int(mate.aend - aln.pos)
                else:
                    rec.tlen = 0
            else:
                rec.tlen = 0
        else:
            rec.mate_pos = -1
            rec.mate_ref_id = -1

        if aln is not primary:
            flags |= 256
        rec.ref_id = tid.get(aln.contig, -1)
        rec.mapq = aln.mapq & 0xff
        if aln.pos == -1:
            flags |= 0x4
            rec.mapq = 0
            rec.ref_id = -1
        if aln.reversed_:
            flags |= 0x10
        rec.name = aln.read_name.rstrip("\n")
        rec.flag = flags

        seq = aln.read_seq
        pos = int(aln.pos)
        cigar = [(CIGAR_TABLE[op], ln) for op, ln in aln.cigar]
        qual = aln.read_qual
        if aln.reversed_:
            seq = reverse_comp(seq)
            qual = qual[::-1]
        if primary is not aln:
            seq, qual, cigar = hard_clip(seq, qual, cigar)
        rec.pos = pos
        rec.cigar = cigar
        rec.seq = seq
        rec.qual = fix_qual(qual)
        rec.aux = build_aux_tags(aln, primary, attach_bx, debug_tags)
        return rec


def build_aux_tags(aln: Alignment, primary: Alignment, attach_bx: bool,
                   debug_tags: bool) -> bytes:
        fq = aln.fastq
        aux = bytearray()
        aux += aux_string(b"RX", fq.raw_barcode10x)
        aux += aux_string(b"QX", fq.barcode10x_qual)
        if aln.read1:
            aux += aux_string(b"TR", fq.trim_bases)
            aux += aux_string(b"TQ", fq.trim_quals)
        if len(fq.barcode) > 1:
            aux += aux_string(b"BC", fq.barcode)
            aux += aux_string(b"QT", fq.barcode_qual)
        if fq.read_group_id:
            aux += aux_string(b"RG", fq.read_group_id.encode())
        as_val = aln.score
        if aln.mapq_data is not None:
            d = aln.mapq_data
            aux += aux_int(b"XS", int(d.second_best_score))
            as_val = int(d.score)
            xc = []
            if d.second_best is not None:
                for rl, fl in zip(d.second_best.mismatch_read_locs,
                                  d.second_best.mismatch_locs):
                    xc.append(f"{fl},{rl},1;")
            aux += aux_string(b"XC", "".join(xc).encode())
            ac = [f"{fl},{rl},1;" for rl, fl in
                  zip(aln.mismatch_read_locs, aln.mismatch_locs)]
            aux += aux_string(b"AC", "".join(ac).encode())
        aux += aux_int(b"AS", as_val)
        second_best_active = 0
        if (aln.mapq_data is not None and aln.mapq_data.second_best is not None
                and aln.mapq_data.second_best.active_molecule):
            second_best_active = 1
        aux += aux_string(b"XM", str(second_best_active).encode())
        aux += aux_string(b"AM", b"1" if aln.active_molecule else b"0")
        tandem = 0
        if (aln.mapq_data is not None and aln.mapq_data.second_best is not None
                and aln.molecule_id == aln.mapq_data.second_best.molecule_id):
            tandem = 1
        aux += aux_int(b"XT", tandem)

        secondary = aln.secondary if aln.secondary is not None else aln.primary
        if secondary is not None and secondary.pos > -1:
            cig = list(secondary.cigar)
            strand = "+"
            if secondary.reversed_:
                strand = "-"
                cig = cig[::-1]
            cigar_str = ""
            indel_len = 0
            for op, ln in cig:
                if op == 3 and aln.secondary is not None:
                    ch = "H"
                else:
                    ch = CIGAR_CHAR[op]
                if op in (1, 2):
                    indel_len += ln
                cigar_str += f"{ln}{ch}"
            sa = (f"{secondary.contig},{secondary.pos},{strand},{cigar_str},"
                  f"{secondary.mapq},{len(secondary.mismatch_locs) + indel_len};")
            aux += aux_string(b"SA", sa.encode())

        if debug_tags and aln.mapq_data is not None:
            # bamwriter.go:498-557 tag set and order (XM/XC/AC deliberately
            # repeat the non-debug tag names, matching the reference)
            d = aln.mapq_data

            def fmt_ops(a):
                return (f"Match:{a.matches}:Mismatches:{a.mismatches}"
                        f":Indels:{a.indels}"
                        f":soft_clipped:{a.soft_clipped}").encode()

            mate = primary.mate_alignment
            if d.second_best is not None:
                sb = d.second_best
                if sb.mate_alignment is not None:
                    aux += aux_string(
                        b"XM",
                        f"{sb.mate_alignment.log_alignment_probability:.6f}"
                        .encode())
                    aux += aux_string(b"XZ", fmt_ops(sb.mate_alignment))
                aux += aux_string(b"XX", fmt_ops(sb))
                aux += aux_string(
                    b"XL", f"{sb.log_alignment_probability:.6f}".encode())
                aux += aux_string(
                    b"XP", str(d.second_best_proper_pair).lower().encode())
                aux += aux_string(
                    b"XR", str(d.second_best_molecule_reads).encode())
                aux += aux_string(
                    b"XC",
                    f"{d.second_best_molecule_confidence:.6f}".encode())
            aux += aux_string(b"AA", d.active_alignments_in_molecules.encode())
            aux += aux_string(b"CP", str(d.copies).encode())
            aux += aux_string(b"CM", str(d.copies_in_active_molecules).encode())
            aux += aux_string(b"CU", str(d.unique_molecules_active).encode())
            aux += aux_string(b"CS",
                              str(d.copies_outside_active_molecules).encode())
            aux += aux_string(b"RD", str(d.reads_in_molecule).encode())
            aux += aux_string(b"MS",
                              f"{aln.sum_move_probability_change:.6f}".encode())
            aux += aux_string(b"MC", f"{aln.molecule_confidence:.6f}".encode())
            aux += aux_string(b"PP", str(aln.is_proper).lower().encode())
            if mate is not None:
                aux += aux_string(b"PS", str(mate.score).encode())
                aux += aux_string(
                    b"PL", f"{mate.log_alignment_probability:.6f}".encode())
            aux += aux_string(b"AC", fmt_ops(aln))
            if mate is not None:
                aux += aux_string(b"PC", fmt_ops(mate))

        barcode_parts = fq.barcode10x.split(b"-")
        if len(barcode_parts) > 1 and attach_bx:
            aux += aux_string(b"BX", fq.barcode10x)
            if aln.active_molecule:
                aux += aux_string(
                    b"DM", f"{aln.molecule_difference:.6f}".encode())
        return bytes(aux)
