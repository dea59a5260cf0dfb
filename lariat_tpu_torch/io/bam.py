"""BAM record serialization (spec-conformant own implementation).

Replaces the reference's biogo.bam submodule (``inference/bamwriter.go:6``,
usage at bamwriter.go:354-567): header writing, record packing (flags, CIGAR,
4-bit seq, qual, aux tags) over BGZF.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, List, Optional, Sequence, Tuple

import numpy as np

from .bgzf import BGZFWriter

SEQ_NYBBLE = {65: 1, 67: 2, 71: 4, 84: 8, 78: 15,
              97: 1, 99: 2, 103: 4, 116: 8, 110: 15}
_NYB_TABLE = [15] * 256
for _b, _v in SEQ_NYBBLE.items():
    _NYB_TABLE[_b] = _v
for _b in range(256):
    if _b not in SEQ_NYBBLE:
        _NYB_TABLE[_b] = 15
# bytes.translate table: base ASCII -> 4-bit code (C-speed per record)
_NYB_BYTES = bytes(_NYB_TABLE)
CIGAR_OPS = "MIDNSHP=X"


def reg2bin(beg: int, end: int) -> int:
    """Standard BAM bin computation (SAM spec section 5.3)."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


_BODY = struct.Struct("<iiBBHHHiiii")
_LEN = struct.Struct("<I")
_INT = struct.Struct("<i")


class BAMRecord:
    """A fully-specified BAM alignment record ready for packing."""

    __slots__ = ("name", "flag", "ref_id", "pos", "mapq", "cigar", "mate_ref_id",
                 "mate_pos", "tlen", "seq", "qual", "aux")

    def __init__(self):
        self.name = ""
        self.flag = 0
        self.ref_id = -1
        self.pos = -1
        self.mapq = 0
        self.cigar: Sequence[Tuple[int, int]] = ()  # (SAM op code, len)
        self.mate_ref_id = -1
        self.mate_pos = -1
        self.tlen = 0
        self.seq = b""
        self.qual = b""          # phred values (already -33)
        self.aux = b""

    def pack(self) -> bytes:
        name_b = self.name.encode() + b"\x00"
        n_cigar = len(self.cigar)
        l_seq = len(self.seq)
        end = self.pos + ref_len_from_cigar(self.cigar)
        if end <= self.pos:
            end = self.pos + 1
        bin_ = reg2bin(self.pos, end) if self.pos >= 0 else 4680
        if n_cigar:
            cigar_b = struct.pack(
                "<%dI" % n_cigar,
                *((ln << 4) | op for op, ln in self.cigar))
        else:
            cigar_b = b""
        if l_seq:
            codes = np.frombuffer(self.seq.translate(_NYB_BYTES), np.uint8)
            nyb_arr = codes[0::2] << 4
            nyb_arr[: l_seq // 2] |= codes[1::2]
            nyb = nyb_arr.tobytes()
        else:
            nyb = b""
        qual_b = bytes(self.qual) if self.qual else b"\xff" * l_seq
        body = _BODY.pack(
            self.ref_id, self.pos, len(name_b), self.mapq,
            bin_, n_cigar, self.flag, l_seq, self.mate_ref_id, self.mate_pos,
            self.tlen) + name_b + cigar_b + nyb + qual_b + self.aux
        return _LEN.pack(len(body)) + body


def ref_len_from_cigar(cigar: Sequence[Tuple[int, int]]) -> int:
    n = 0
    for op, ln in cigar:
        if op in (0, 2, 3, 7, 8):  # M, D, N, =, X
            n += ln
    return n


def aux_string(tag: bytes, data: bytes) -> bytes:
    return tag + b"Z" + data + b"\x00"


def aux_int(tag: bytes, value: int) -> bytes:
    v = int(value) & 0xffffffff
    if v >= 1 << 31:
        v -= 1 << 32
    return tag + b"i" + _INT.pack(v)


def aux_float(tag: bytes, value: float) -> bytes:
    return tag + b"f" + struct.pack("<f", value)


class BAMWriter:
    """Single BAM file writer: header + records over BGZF."""

    def __init__(self, fh: BinaryIO, header_text: str,
                 ref_names: List[str], ref_lengths: List[int]):
        self._bgzf = BGZFWriter(fh)
        text = header_text.encode()
        out = b"BAM\x01" + struct.pack("<i", len(text)) + text
        out += struct.pack("<i", len(ref_names))
        for name, length in zip(ref_names, ref_lengths):
            nb = name.encode() + b"\x00"
            out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
        self._bgzf.write(out)

    def write(self, rec: BAMRecord) -> None:
        self._bgzf.write(rec.pack())

    def close(self) -> None:
        self._bgzf.close()


def build_header_text(contigs: List[Tuple[str, int]], read_groups: str,
                      sample_id: str, version: str, cl: str,
                      first_chunk: bool) -> str:
    """Header parity with CreateBAM (bamwriter.go:46-124): @SQ from contigs,
    @RG from sample:library:gem_group:flowcell:lane ids, @PG lariat, @CO
    10x_bam_to_fastq lines on the first chunk only."""
    lines = []
    for name, length in contigs:
        lines.append(f"@SQ\tSN:{name}\tLN:{length}")
    for rg_id in read_groups.split(","):
        fields = rg_id.split(":")
        if len(fields) < 5 or not rg_id:
            continue
        lines.append(
            f"@RG\tID:{rg_id}\tLB:{fields[1]}.{fields[2]}\tPL:ILLUMINA"
            f"\tPU:{rg_id}\tSM:{fields[0]}")
    lines.append(f"@PG\tID:lariat\tPN:longranger.lariat\tCL:{cl}\tVN:{version}")
    if first_chunk:
        lines.append("@CO\t10x_bam_to_fastq:R1(RX:QX,TR:TQ,SEQ:QUAL)")
        lines.append("@CO\t10x_bam_to_fastq:R2(SEQ:QUAL)")
        lines.append("@CO\t10x_bam_to_fastq:I1(BC:QT)")
    return "\n".join(lines) + "\n"
