"""Minimal BAM reader for validation harnesses and tests: a copy of
lariat_tpu/io/bamread.py.

Parses our own (spec-conformant) BAM output so the metrics harness
(``tools/check.py``, the equivalent of the reference's go/check.py), the
bench's record diff rate and ``tools/bam2sam.py`` can inspect records
without external tools. ``BamFile.data`` is the whole decompressed stream
and ``BamFile._records_start`` its offset past the header.
"""

from __future__ import annotations

import dataclasses
import gzip
import struct
from typing import Dict, Iterator, List, Optional, Tuple

CIGAR_OPS = "MIDNSHP=X"
NYB2BASE = "=ACMGRSVTWYHKDBN"


@dataclasses.dataclass
class BamRead:
    name: str
    flag: int
    ref_id: int
    ref_name: str
    pos: int
    mapq: int
    cigar: List[Tuple[str, int]]
    mate_ref_id: int
    mate_pos: int
    tlen: int
    seq: str
    qual: bytes
    tags: Dict[str, object]

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & 0x4)

    @property
    def is_proper_pair(self) -> bool:
        return bool(self.flag & 0x2)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & 0x10)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & 0x100)

    @property
    def is_duplicate(self) -> bool:
        return bool(self.flag & 0x400)

    @property
    def is_read1(self) -> bool:
        return bool(self.flag & 0x40)


class BamFile:
    def __init__(self, path: str):
        with gzip.open(path, "rb") as f:
            self.data = f.read()
        assert self.data[:4] == b"BAM\x01", "not a BAM file"
        l_text = struct.unpack_from("<i", self.data, 4)[0]
        self.header_text = self.data[8:8 + l_text].decode()
        off = 8 + l_text
        n_ref = struct.unpack_from("<i", self.data, off)[0]
        off += 4
        self.references: List[Tuple[str, int]] = []
        for _ in range(n_ref):
            l_name = struct.unpack_from("<i", self.data, off)[0]
            name = self.data[off + 4:off + 4 + l_name - 1].decode()
            length = struct.unpack_from("<i", self.data, off + 4 + l_name)[0]
            self.references.append((name, length))
            off += 8 + l_name
        self._records_start = off

    def __iter__(self) -> Iterator[BamRead]:
        off = self._records_start
        data = self.data
        while off < len(data):
            block_size = struct.unpack_from("<I", data, off)[0]
            body = data[off + 4: off + 4 + block_size]
            off += 4 + block_size
            yield self._parse(body)

    def _parse(self, b: bytes) -> BamRead:
        (ref_id, pos, l_name, mapq, _bin, n_cigar, flag, l_seq,
         mate_ref, mate_pos, tlen) = struct.unpack_from("<iiBBHHHiiii", b, 0)
        off = 32
        name = b[off:off + l_name - 1].decode()
        off += l_name
        cigar = []
        for _ in range(n_cigar):
            v = struct.unpack_from("<I", b, off)[0]
            cigar.append((CIGAR_OPS[v & 0xf], v >> 4))
            off += 4
        seq_bytes = b[off:off + (l_seq + 1) // 2]
        off += (l_seq + 1) // 2
        seq = "".join(
            NYB2BASE[(seq_bytes[i // 2] >> (4 if i % 2 == 0 else 0)) & 0xf]
            for i in range(l_seq))
        qual = b[off:off + l_seq]
        off += l_seq
        tags: Dict[str, object] = {}
        while off < len(b):
            tag = b[off:off + 2].decode()
            typ = chr(b[off + 2])
            off += 3
            if typ == "Z":
                end = b.index(b"\x00", off)
                tags[tag] = b[off:end].decode()
                off = end + 1
            elif typ == "i":
                tags[tag] = struct.unpack_from("<i", b, off)[0]
                off += 4
            elif typ == "f":
                tags[tag] = struct.unpack_from("<f", b, off)[0]
                off += 4
            elif typ in "cC":
                tags[tag] = b[off]
                off += 1
            elif typ in "sS":
                tags[tag] = struct.unpack_from("<h" if typ == "s" else "<H",
                                               b, off)[0]
                off += 2
            elif typ == "A":
                tags[tag] = chr(b[off])
                off += 1
            else:
                raise ValueError(f"unhandled aux type {typ}")
        ref_name = self.references[ref_id][0] if ref_id >= 0 else "*"
        return BamRead(name=name, flag=flag, ref_id=ref_id, ref_name=ref_name,
                       pos=pos, mapq=mapq, cigar=cigar, mate_ref_id=mate_ref,
                       mate_pos=mate_pos, tlen=tlen, seq=seq, qual=qual,
                       tags=tags)
