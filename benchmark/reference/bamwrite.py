"""A plain BAM writer for the control's records: BGZF blocks made with
zlib, the fields the judge reads, an ``AC`` tag a mismatch."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000"
                     "000000")
_SEQ4 = np.array([1, 2, 4, 8, 15], np.uint8)     # A C G T N as 4-bit codes


def _block(data: bytes) -> bytes:
    c = zlib.compressobj(1, zlib.DEFLATED, -15)
    body = c.compress(data) + c.flush()
    return (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00"
            + struct.pack("<H", len(body) + 25) + body
            + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data)))


def pack_seq(seq: np.ndarray) -> np.ndarray:
    """(n, L) codes 0-4 -> (n, (L + 1) // 2) 4-bit packed SEQ bytes."""
    nib = _SEQ4[seq]
    if nib.shape[1] % 2:
        nib = np.concatenate([nib, np.zeros((len(nib), 1), np.uint8)], 1)
    return ((nib[:, 0::2] << 4) | nib[:, 1::2]).astype(np.uint8)


def record(name: str, flag: int, ref_id: int, pos: int, mapq: int,
           cigar: list, seq4: np.ndarray, n: int, next_ref_id: int,
           next_pos: int, tlen: int, tags: bytes = b"") -> bytes:
    """One record; ``seq4`` its ``n`` bases packed by ``pack_seq``."""
    nm = name.encode() + b"\0"
    cig = b"".join(struct.pack("<I", ln << 4 | op) for op, ln in cigar)
    body = (struct.pack("<iiBBHHHiiii", ref_id, pos, len(nm), mapq, 4680,
                        len(cigar), flag, n, next_ref_id, next_pos, tlen)
            + nm + cig + seq4.tobytes() + b"\xff" * n + tags)
    return struct.pack("<i", len(body)) + body


def tag_z(tag: str, value: str) -> bytes:
    return tag.encode() + b"Z" + value.encode() + b"\0"


def write(paths: list, refs: list, records: list) -> None:
    """``refs`` [(name, length)], ``records`` record bytes, in order; the
    same file to each of ``paths``."""
    head = b"@HD\tVN:1.4\n"
    data = [b"BAM\1", struct.pack("<i", len(head)), head,
            struct.pack("<i", len(refs))]
    for name, ln in refs:
        nm = name.encode() + b"\0"
        data += [struct.pack("<i", len(nm)), nm, struct.pack("<i", ln)]
    data += records
    raw = b"".join(data)
    blob = b"".join(_block(raw[i:i + 0xFF00])
                    for i in range(0, len(raw), 0xFF00)) + _EOF
    for path in paths:
        with open(path, "wb") as f:
            f.write(blob)
