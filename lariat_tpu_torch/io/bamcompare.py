"""Whole-file identity of two BAM files, up to the ``@PG CL`` field.

The CLI writes ``CL:`` as its argv (``io/bam.py`` ``build_header_text``), so
two runs of the same input by different entry points (``python -m
lariat_tpu.cli`` against ``python -m lariat_tpu_torch.cli``, another
``-output``) differ there and nowhere else. ``compare_bams`` holds two files
to that:

- both are well-formed BGZF (every block's ``BC`` extra field, its CRC and
  its size) ending in the 28-byte EOF block;
- the decompressed streams, with CL set to one value in both headers and
  ``l_text`` fixed to match, are equal in full;
- every BGZF block that holds no header byte and covers the same range of
  the normalised stream in both files is equal byte for byte, block size
  included; when both headers have one length, every such block must have
  a partner. The writer fills 65,280-byte blocks from the header onwards,
  so a CL of another length shifts every later block: those blocks are
  counted as ``shifted``, not compared, and the EOF block is left.

Any other difference raises ``BamMismatch`` naming the first differing
offset.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

from .bgzf import BGZF_EOF

NORMAL_CL = b"CL"


class BamMismatch(AssertionError):
    """Two BAM files differ beyond their ``@PG CL`` field."""


def bgzf_blocks(raw: bytes, what: str = "") -> List[Tuple[int, int, bytes]]:
    """(offset in the file, block length, decompressed bytes) of every BGZF
    block; raises BamMismatch on a malformed block or a bad CRC."""
    out = []
    off = 0
    while off < len(raw):
        if raw[off:off + 4] != b"\x1f\x8b\x08\x04" or off + 18 > len(raw):
            raise BamMismatch(f"{what}: no BGZF block header at byte {off}")
        (xlen,) = struct.unpack_from("<H", raw, off + 10)
        extra = raw[off + 12:off + 12 + xlen]
        bsize = None
        p = 0
        while p + 4 <= len(extra):
            slen = struct.unpack_from("<H", extra, p + 2)[0]
            if extra[p:p + 2] == b"BC" and slen == 2:
                bsize = struct.unpack_from("<H", extra, p + 4)[0]
            p += 4 + slen
        if bsize is None:
            raise BamMismatch(f"{what}: block at byte {off} has no BC field")
        n = bsize + 1
        if off + n > len(raw):
            raise BamMismatch(f"{what}: block at byte {off} runs past the "
                              f"file")
        body = raw[off + 12 + xlen:off + n - 8]
        crc, isize = struct.unpack_from("<II", raw, off + n - 8)
        try:
            data = zlib.decompress(body, -15)
        except zlib.error as e:
            raise BamMismatch(f"{what}: block at byte {off}: {e}") from e
        if len(data) != isize or zlib.crc32(data) != crc:
            raise BamMismatch(f"{what}: block at byte {off}: size or CRC")
        out.append((off, n, data))
        off += n
    return out


def header_end(data: bytes, what: str = "") -> int:
    """Offset of the first record in a decompressed BAM stream."""
    if data[:4] != b"BAM\x01":
        raise BamMismatch(f"{what}: not a BAM")
    (l_text,) = struct.unpack_from("<i", data, 4)
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 8 + l_name
    return off


def normalise_cl(data: bytes) -> bytes:
    """The stream with the value of every ``@PG`` line's CL field set to
    ``NORMAL_CL`` and ``l_text`` fixed to match."""
    (l_text,) = struct.unpack_from("<i", data, 4)
    lines = data[8:8 + l_text].split(b"\n")
    for i, line in enumerate(lines):
        if line.startswith(b"@PG\t"):
            lines[i] = b"\t".join(
                b"CL:" + NORMAL_CL if f.startswith(b"CL:") else f
                for f in line.split(b"\t"))
    text = b"\n".join(lines)
    return (data[:4] + struct.pack("<i", len(text)) + text
            + data[8 + l_text:])


def _records(data: bytes, start: int, what: str) -> int:
    n, pos = 0, start
    while pos < len(data):
        pos += 4 + struct.unpack_from("<i", data, pos)[0]
        n += 1
    if pos != len(data):
        raise BamMismatch(f"{what}: truncated record")
    return n


def compare_bams(path_a: str, path_b: str) -> Dict[str, int]:
    """Hold two BAM files to identity up to CL (module docstring); returns
    what was compared: the normalised stream's bytes and records, each
    file's blocks, the blocks and compressed bytes compared byte for byte
    (the EOF block included), the blocks holding header bytes and the
    blocks shifted by the CL's length."""
    files = []
    for path in (path_a, path_b):
        with open(path, "rb") as f:
            raw = f.read()
        if not raw.endswith(BGZF_EOF):
            raise BamMismatch(f"{path}: no BGZF EOF block")
        blocks = bgzf_blocks(raw, path)
        data = b"".join(d for _, _, d in blocks)
        norm = normalise_cl(data)
        files.append((path, raw, blocks, data, norm))
    ((pa, raw_a, blocks_a, data_a, norm_a),
     (pb, raw_b, blocks_b, data_b, norm_b)) = files
    if norm_a != norm_b:
        i = next((k for k, (x, y) in enumerate(zip(norm_a, norm_b))
                  if x != y), min(len(norm_a), len(norm_b)))
        where = ("header" if i < header_end(norm_a, pa) else "records")
        raise BamMismatch(f"{pa} vs {pb}: decompressed streams (CL "
                          f"normalised) differ at byte {i} ({where}; "
                          f"lengths {len(norm_a)}, {len(norm_b)})")
    hdr_norm = header_end(norm_a, pa)

    def by_range(path, raw, blocks, norm):
        """Blocks holding no header byte, keyed by their range of the
        normalised stream -> compressed bytes; and the count of the rest."""
        data_len = sum(len(d) for _, _, d in blocks)
        shift = len(norm) - data_len
        hdr = hdr_norm - shift
        out, start, n_hdr = {}, 0, 0
        for off, n, d in blocks:
            if start < hdr and len(d):
                n_hdr += 1
            elif len(d):
                out[(start + shift, len(d))] = raw[off:off + n]
            start += len(d)
        return out, n_hdr

    rec_a, hdr_blocks = by_range(pa, raw_a, blocks_a, norm_a)
    rec_b, _ = by_range(pb, raw_b, blocks_b, norm_b)
    if len(norm_a) - len(data_a) == len(norm_b) - len(data_b) \
            and set(rec_a) != set(rec_b):
        raise BamMismatch(f"{pa} vs {pb}: headers of one length, but the "
                          f"BGZF blocks past them are framed differently")
    compared = compared_bytes = 0
    for key in sorted(set(rec_a) & set(rec_b)):
        if rec_a[key] != rec_b[key]:
            raise BamMismatch(f"{pa} vs {pb}: the BGZF block of stream bytes "
                              f"[{key[0]}, {key[0] + key[1]}) differs")
        compared += 1
        compared_bytes += len(rec_a[key])
    return {"stream_bytes": len(norm_a),
            "records": _records(norm_a, hdr_norm, pa),
            "blocks": len(blocks_a), "blocks_other": len(blocks_b),
            "blocks_compared": compared + 1,
            "bytes_compared": compared_bytes + len(BGZF_EOF),
            "header_blocks": hdr_blocks,
            "shifted_blocks": len(rec_a) - compared}
