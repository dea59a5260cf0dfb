"""BGZF (blocked gzip) writer — the BAM container format.

Replaces the role of the reference's biogo.bam BGZF layer (consumed at
``inference/bamwriter.go:6,117``). Pure-Python zlib implementation; each
block holds up to 64 KiB of uncompressed data and carries the BC extra field
with the compressed block size, closing with the standard EOF marker.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import BinaryIO, Optional

MAX_BLOCK = 65280  # keep compressed size safely under 65536
BGZF_EOF = bytes([
    0x1f, 0x8b, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xff, 0x06, 0x00,
    0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00])


_native_lib = None
_native_checked = False


def _get_native():
    """Load native/liblariat_native.so's multithreaded BGZF compressor."""
    global _native_lib, _native_checked
    if _native_checked:
        return _native_lib
    _native_checked = True
    try:
        from ..index.suffix import _load_native
        lib = _load_native()
        if lib is None:
            return None
        lib.bgzf_compress_many.restype = ctypes.c_int64
        lib.bgzf_compress_many.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int]
        _native_lib = lib
    except (OSError, AttributeError):
        _native_lib = None
    return _native_lib


# Buffer this much before handing off to the native parallel compressor.
NATIVE_FLUSH = 4 << 20


class BGZFWriter:
    def __init__(self, fh: BinaryIO, level: int = 2, threads: int = 4):
        self._fh = fh
        self._level = level
        self._threads = threads
        self._buf = bytearray()
        self._native = _get_native()

    def write(self, data: bytes) -> None:
        self._buf += data
        if self._native is not None:
            if len(self._buf) >= NATIVE_FLUSH:
                self._flush_native(len(self._buf) // MAX_BLOCK * MAX_BLOCK)
            return
        while len(self._buf) >= MAX_BLOCK:
            self._flush_block(MAX_BLOCK)

    def _flush_native(self, n: int) -> None:
        if n <= 0:
            return
        chunk = bytes(self._buf[:n])
        del self._buf[:n]
        cap = n + (n // MAX_BLOCK + 2) * 128 + 1024
        dst = ctypes.create_string_buffer(cap)
        written = self._native.bgzf_compress_many(
            chunk, n, dst, cap, self._level, self._threads)
        if written < 0:
            raise RuntimeError("native bgzf compression failed")
        self._fh.write(dst.raw[:written])

    def _flush_block(self, n: int) -> None:
        chunk = bytes(self._buf[:n])
        del self._buf[:n]
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        comp = co.compress(chunk) + co.flush()
        bsize = len(comp) + 25 + 1  # header(18) + comp + crc(4) + isize(4) - 1
        header = struct.pack(
            "<BBBBIBBHBBHH",
            0x1f, 0x8b, 8, 4,     # gzip magic, deflate, FEXTRA
            0, 0, 0xff,           # mtime, xfl, os
            6,                    # XLEN
            66, 67, 2,            # SI1='B', SI2='C', SLEN=2
            bsize)
        self._fh.write(header)
        self._fh.write(comp)
        self._fh.write(struct.pack("<II", zlib.crc32(chunk),
                                   len(chunk) & 0xffffffff))

    def close(self) -> None:
        if self._native is not None and self._buf:
            self._flush_native(len(self._buf))
        while self._buf:
            self._flush_block(min(len(self._buf), MAX_BLOCK))
        self._fh.write(BGZF_EOF)
        self._fh.flush()


def bgzf_decompress(path: str) -> bytes:
    """Read back a BGZF file (for tests); gzip module handles member chains."""
    import gzip
    with gzip.open(path, "rb") as f:
        return f.read()
