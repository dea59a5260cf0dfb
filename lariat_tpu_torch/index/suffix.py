"""Suffix array construction: ctypes bridge to the native SA-IS library.

The C++ library (``native/sais.cpp``) is built on demand with the system
toolchain; a pure-numpy fallback handles small inputs when no compiler is
available (tests, tiny fixtures).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "liblariat_native.so")
_lock = threading.Lock()
_lib = None


def _load_native():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        srcs = [os.path.join(_NATIVE_DIR, f)
                for f in ("sais.cpp", "bgzf.cpp", "seed.cpp", "ksw.cpp",
                          "align1.cpp")]
        if not os.path.exists(_LIB_PATH) or any(
                os.path.exists(f)
                and os.path.getmtime(_LIB_PATH) < os.path.getmtime(f)
                for f in srcs):
            try:
                subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                               capture_output=True)
            except (OSError, subprocess.CalledProcessError):
                return None
        lib = ctypes.CDLL(_LIB_PATH)
        lib.sais_u8_i32.restype = ctypes.c_int
        lib.sais_u8_i32.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32]
        lib.fm_collect_seeds_batch.restype = ctypes.c_int64
        lib.fm_sa_lookup_batch.restype = None
        lib.sais_u8_i64.restype = ctypes.c_int
        lib.sais_u8_i64.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64]
        _lib = lib
        return _lib


def suffix_array(text: np.ndarray, alphabet_size: int) -> np.ndarray:
    """Suffix array of ``text`` (uint8, values < alphabet_size).

    ``text[-1]`` must be a unique smallest sentinel. Returns int64 (or int32
    for small inputs) array ``sa`` with ``sa[i]`` = start of the i-th smallest
    suffix.
    """
    text = np.ascontiguousarray(text, dtype=np.uint8)
    n = len(text)
    lib = _load_native()
    if lib is None:
        # numpy fallback: fine for test-sized inputs
        order = np.argsort([text[i:].tobytes() for i in range(n)], kind="stable")
        return order.astype(np.int64)
    if n < 2**31 - 1:
        sa = np.empty(n, dtype=np.int32)
        rc = lib.sais_u8_i32(
            text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n, alphabet_size)
    else:
        sa = np.empty(n, dtype=np.int64)
        rc = lib.sais_u8_i64(
            text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, alphabet_size)
    if rc != 0:
        raise RuntimeError(f"sais failed rc={rc}")
    return sa.astype(np.int64, copy=False)
