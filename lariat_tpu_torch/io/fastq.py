"""Interleaved 10X FASTQ reader with barcode grouping.

Parses the 9-line record format the reference consumes
(reference ``go/src/fastqreader/reader.go:91-149``; format doc ``README.md:37-47``):

    @<qname> [... <read-group-id>]
    R1 bases
    R1 quals
    R2 bases
    R2 quals
    10X barcode            (comma-separated: corrected[,raw]; corrected ends "-<gem>")
    10X barcode quals
    sample index
    sample index quals

Semantics reproduced exactly:
 - R1 trimming: first ``min(len, trim)`` bases move to ``trim_bases``/``trim_quals``
   (reader.go:129-137).
 - Barcode field comma-split: corrected = first, raw = last (reader.go:141-143).
 - ``read_barcode_set``: groups consecutive same-barcode records; <=30,000 per
   batch; non-whitelist barcodes (no '-') force-flushed at 200 records;
   continuation batches of a previously flushed barcode break at 200 with
   ``unique_barcode=False``; pending-record carryover; deferred EOF
   (reader.go:176-260).
"""

from __future__ import annotations

import dataclasses
import gzip
import io
import os
import shutil
import subprocess
from typing import BinaryIO, Iterator, List, Optional, Tuple


@dataclasses.dataclass
class FastQRecord:
    read1: bytes = b""
    read_qual1: bytes = b""
    read2: bytes = b""
    read_qual2: bytes = b""
    trim_bases: bytes = b""
    trim_quals: bytes = b""
    barcode10x: bytes = b""
    barcode10x_qual: bytes = b""
    raw_barcode10x: bytes = b""
    barcode: bytes = b""          # sample index
    barcode_qual: bytes = b""
    read_info: str = ""           # qname
    read_group_id: str = ""


def open_maybe_gzip(path: str) -> BinaryIO:
    """Open a possibly-gzipped file for reading.

    The reference spawns the system ``gunzip -c`` for speed (zipread.go:62-85);
    we do the same when available, falling back to Python's gzip module.
    """
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic != b"\x1f\x8b":
        return open(path, "rb")
    for exe in ("pigz", "gzip"):
        prog = shutil.which(exe)
        if prog:
            proc = subprocess.Popen(
                [prog, "-dc", path], stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, bufsize=1 << 20)
            assert proc.stdout is not None
            return _SubprocessStream(proc)
    return gzip.open(path, "rb")


class _SubprocessStream(io.RawIOBase):
    """Wraps a decompressor child's stdout and reaps the child on EOF or
    close, so long multi-chunk runs don't accumulate zombies."""

    def __init__(self, proc: subprocess.Popen):
        self._proc = proc
        self._raw = proc.stdout

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        n = self._raw.readinto(b)
        if not n and self._proc.poll() is None:
            self._reap()
        return n

    def _reap(self) -> None:
        """wait with a bounded grace period, escalating to kill — a
        decompressor that ignores SIGTERM must not hang the pipeline."""
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait()

    def close(self) -> None:
        if not self.closed:
            try:
                self._raw.close()
            finally:
                if self._proc.poll() is None:
                    self._proc.terminate()
                self._reap()
        super().close()


class FastQReader:
    """Pull single records or same-barcode record sets from a 10X fastq."""

    def __init__(self, path: str):
        self.path = path
        self._stream = io.BufferedReader(open_maybe_gzip(path), 1 << 20)
        self.line = 0
        self.deferred_eof = False
        self.pending: Optional[FastQRecord] = None
        self.last_barcode: Optional[bytes] = None

    def close(self) -> None:
        self._stream.close()

    def read_one(self, trim: int) -> Optional[FastQRecord]:
        """Read a single 9-line record; None at EOF (reader.go:91-149)."""
        rec = FastQRecord()
        # Search for the next start-of-record line.
        while True:
            line = self._stream.readline()
            self.line += 1
            if not line:
                return None
            if line.startswith(b"@"):
                fields = line[1:].split()
                rec.read_info = fields[0].decode() if fields else ""
                rec.read_group_id = fields[-1].decode() if len(fields) >= 2 else ""
                break
            # reference logs bad lines and keeps scanning
        body: List[bytes] = []
        for _ in range(8):
            line = self._stream.readline()
            if not line:
                return None
            body.append(line.rstrip(b"\n"))
        to_trim = min(len(body[0]), trim)
        rec.read1 = body[0][to_trim:]
        rec.read_qual1 = body[1][to_trim:]
        rec.trim_bases = body[0][:to_trim]
        rec.trim_quals = body[1][:to_trim]
        rec.read2 = body[2]
        rec.read_qual2 = body[3]
        barcodes = body[4].split(b",")
        rec.barcode10x = barcodes[0]
        rec.raw_barcode10x = barcodes[-1]
        rec.barcode10x_qual = body[5]
        rec.barcode = body[6]
        rec.barcode_qual = body[7]
        return rec

    @staticmethod
    def not_whitelist(rec: FastQRecord) -> bool:
        """True when the barcode lacks the '-<gem>' suffix (reader.go:162-169)."""
        return b"-" not in rec.barcode10x

    def read_barcode_set(self, trim: int) -> Tuple[Optional[List[FastQRecord]], bool]:
        """Return (records, unique_barcode); records None at stream end.

        Mirrors reader.go:176-260 including the force-flush and carryover rules.
        """
        if self.deferred_eof and self.pending is None:
            return None, False
        records: List[FastQRecord] = []
        if self.pending is not None:
            records.append(self.pending)
            self.pending = None
        new_barcode = False
        hit_eof = False
        while len(records) < 30000:
            rec = self.read_one(trim)
            if rec is None:
                if not records:
                    return None, False
                self.deferred_eof = True
                hit_eof = True
                break
            records.append(rec)
            if len(records) == 1:
                continue
            first = records[0]
            if rec.barcode10x != first.barcode10x or (
                    self.not_whitelist(first) and len(records) - 1 >= 200):
                # Transitioned to a new GEM (or forced flush): defer this record.
                self.pending = rec
                records.pop()
                new_barcode = True
                break
            if (self.last_barcode is not None
                    and first.barcode10x == self.last_barcode
                    and len(records) - 1 >= 200):
                # Continuation of a previously flushed barcode: abnormal break.
                break
        if records:
            self.last_barcode = bytes(records[0].barcode10x)
        if new_barcode or hit_eof:
            unique = True
        else:
            unique = False
        return records, unique

    def iter_barcode_sets(self, trim: int) -> Iterator[Tuple[List[FastQRecord], bool]]:
        while True:
            records, unique = self.read_barcode_set(trim)
            if records is None:
                return
            yield records, unique
