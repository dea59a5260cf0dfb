"""A plain BAM reader: BGZF blocks inflated with zlib, records split by
their sizes, the fixed fields gathered into numpy arrays. It reads what
the program wrote, to judge it, and shares no code with the program."""

from __future__ import annotations

import dataclasses
import struct
import zlib

import numpy as np

# 4-bit SEQ codes -> 0-3 (A C G T), 4 for anything else
_NIB = np.full(16, 4, np.uint8)
_NIB[[1, 2, 4, 8]] = [0, 1, 2, 3]


def inflate(path: str) -> bytes:
    """The BGZF file's uncompressed bytes."""
    with open(path, "rb") as f:
        data = f.read()
    out, off = [], 0
    while off < len(data):
        if data[off:off + 2] != b"\x1f\x8b":
            raise ValueError(f"{path}: no gzip member at {off}")
        xlen = struct.unpack_from("<H", data, off + 10)[0]
        p, bsize = off + 12, None
        while p < off + 12 + xlen:
            slen = struct.unpack_from("<H", data, p + 2)[0]
            if data[p:p + 2] == b"BC":
                bsize = struct.unpack_from("<H", data, p + 4)[0]
            p += 4 + slen
        if bsize is None:
            raise ValueError(f"{path}: a block without its size")
        out.append(zlib.decompress(data[off + 12 + xlen:off + bsize - 7],
                                   -15))
        off += bsize + 1
    return b"".join(out)


@dataclasses.dataclass
class Records:
    refs: list               # [(name, length)]
    raw: bytes
    off: np.ndarray          # (n,) offset of each record's block_size
    ref_id: np.ndarray
    pos: np.ndarray
    mapq: np.ndarray
    flag: np.ndarray
    l_seq: np.ndarray
    next_ref_id: np.ndarray
    next_pos: np.ndarray
    n_cigar: np.ndarray
    l_name: np.ndarray

    @property
    def n(self) -> int:
        return len(self.off)

    def names(self) -> list:
        raw, off, ln = self.raw, self.off.tolist(), self.l_name.tolist()
        return [raw[o + 36:o + 35 + k].decode() for o, k in zip(off, ln)]

    def cigar_at(self) -> np.ndarray:
        return self.off + 36 + self.l_name

    def _cigar_at(self, i: int) -> int:
        return int(self.off[i]) + 36 + int(self.l_name[i])

    def cigar(self, i: int) -> list:
        """[(op, length)] of record ``i`` (op: 0 M, 1 I, 2 D, 4 S, 5 H...)."""
        o, k = self._cigar_at(i), int(self.n_cigar[i])
        return [(c & 15, c >> 4)
                for c in struct.unpack_from(f"<{k}I", self.raw, o)]

    def first_cigar(self) -> np.ndarray:
        """Each record's first CIGAR word (0 where it has none)."""
        a = np.frombuffer(self.raw, np.uint8)
        o = self.cigar_at()[:, None] + np.arange(4)[None, :]
        w = a[np.minimum(o, len(a) - 1)].copy().view("<u4").ravel()
        return np.where(self.n_cigar > 0, w, 0)

    def seq_codes(self, idx: np.ndarray, length: int) -> np.ndarray:
        """(len(idx), length) SEQ codes 0-3 (4 for others) of records
        ``idx``, which must all hold ``length`` bases."""
        a = np.frombuffer(self.raw, np.uint8)
        start = (self.cigar_at() + 4 * self.n_cigar)[idx]
        nb = (length + 1) // 2
        b = a[start[:, None] + np.arange(nb)[None, :]]
        out = np.empty((len(idx), 2 * nb), np.uint8)
        out[:, 0::2] = _NIB[b >> 4]
        out[:, 1::2] = _NIB[b & 15]
        return out[:, :length]

    def aux(self, i: int) -> dict:
        """Record ``i``'s tags (Z, A, integer types)."""
        o = int(self.off[i])
        end = o + 4 + struct.unpack_from("<i", self.raw, o)[0]
        q = self._cigar_at(i) + 4 * int(self.n_cigar[i])
        q += (int(self.l_seq[i]) + 1) // 2 + int(self.l_seq[i])
        raw, out = self.raw, {}
        while q < end:
            tag, t = raw[q:q + 2].decode(), chr(raw[q + 2])
            q += 3
            if t == "Z" or t == "H":
                e = raw.index(b"\0", q)
                out[tag] = raw[q:e].decode()
                q = e + 1
            elif t == "A":
                out[tag] = chr(raw[q])
                q += 1
            else:
                fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i",
                       "I": "I", "f": "f"}[t]
                out[tag] = struct.unpack_from("<" + fmt, raw, q)[0]
                q += struct.calcsize(fmt)
        return out


def _field(a: np.ndarray, at: np.ndarray, dtype: str) -> np.ndarray:
    k = np.dtype(dtype).itemsize
    return a[at[:, None] + np.arange(k)[None, :]].copy().view(dtype).ravel()


def read(path: str) -> Records:
    raw = inflate(path)
    if raw[:4] != b"BAM\1":
        raise ValueError(f"{path}: not a BAM")
    l_text = struct.unpack_from("<i", raw, 4)[0]
    p = 8 + l_text
    n_ref = struct.unpack_from("<i", raw, p)[0]
    p += 4
    refs = []
    for _ in range(n_ref):
        ln = struct.unpack_from("<i", raw, p)[0]
        name = raw[p + 4:p + 3 + ln].decode()
        p += 4 + ln
        refs.append((name, struct.unpack_from("<i", raw, p)[0]))
        p += 4
    offs = []
    n = len(raw)
    while p < n:
        offs.append(p)
        p += 4 + int.from_bytes(raw[p:p + 4], "little")
    if p != n:
        raise ValueError(f"{path}: a record runs past the end")
    off = np.array(offs, dtype=np.int64)
    a = np.frombuffer(raw, np.uint8)
    if not len(off):
        z = np.zeros(0, np.int64)
        return Records(refs, raw, off, *([z] * 9))
    return Records(
        refs=refs, raw=raw, off=off,
        ref_id=_field(a, off + 4, "<i4").astype(np.int64),
        pos=_field(a, off + 8, "<i4").astype(np.int64),
        l_name=a[off + 12].astype(np.int64),
        mapq=a[off + 13].astype(np.int64),
        n_cigar=_field(a, off + 16, "<u2").astype(np.int64),
        flag=_field(a, off + 18, "<u2").astype(np.int64),
        l_seq=_field(a, off + 20, "<i4").astype(np.int64),
        next_ref_id=_field(a, off + 24, "<i4").astype(np.int64),
        next_pos=_field(a, off + 28, "<i4").astype(np.int64))


def count(path: str) -> int:
    """Records in a BAM, without gathering their fields."""
    raw = inflate(path)
    l_text = struct.unpack_from("<i", raw, 4)[0]
    p = 8 + l_text
    n_ref = struct.unpack_from("<i", raw, p)[0]
    p += 4
    for _ in range(n_ref):
        p += 8 + struct.unpack_from("<i", raw, p)[0]
    k = 0
    while p < len(raw):
        p += 4 + int.from_bytes(raw[p:p + 4], "little")
        k += 1
    return k
