"""ctypes wrappers for the native (C++) seeding and SA-lookup hot paths."""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional

import numpy as np

from . import suffix

_c_i64p = ctypes.POINTER(ctypes.c_int64)
_c_u32p = ctypes.POINTER(ctypes.c_uint32)
_c_u8p = ctypes.POINTER(ctypes.c_uint8)

N_THREADS = 4

_tls = threading.local()


def _fm_ptrs(fm):
    """Cached ctypes argument prefix for an FMIndex (pointers stay valid:
    the pointed-to arrays are cached on the fm object)."""
    t = getattr(fm, "_native_ptr_cache", None)
    if t is None:
        occ = np.ascontiguousarray(fm.occ_ckpt)
        fm._occ_contig_cache = occ
        t = (fm.packed_words.ctypes.data_as(_c_u32p),
             occ.ctypes.data_as(_c_i64p),
             fm.L2.ctypes.data_as(_c_i64p),
             fm.sa_samples.ctypes.data_as(_c_i64p),
             ctypes.c_int64(fm.primary), ctypes.c_int64(fm.seq_len),
             ctypes.c_int64(fm.sa_intv))
        fm._native_ptr_cache = t
    return t


def _occ_contig(fm):
    occ = getattr(fm, "_occ_contig_cache", None)
    if occ is None:
        occ = np.ascontiguousarray(fm.occ_ckpt)
        fm._occ_contig_cache = occ
    return occ


def _scratch(cap: int) -> np.ndarray:
    buf = getattr(_tls, "seed_out", None)
    if buf is None or len(buf) < cap:
        buf = np.empty((cap, 5), dtype=np.int64)
        _tls.seed_out = buf
    return buf


def collect_seeds_batch(fm, reads: List[np.ndarray], opt
                        ) -> Optional[List[np.ndarray]]:
    """Batched mem_collect_intv; returns per-read (n, 5) int64 arrays
    [x0, x1, s, qb, qe], or None when the native library is unavailable."""
    lib = suffix._load_native()
    if lib is None or not hasattr(lib, "fm_collect_seeds_batch"):
        return None
    n = len(reads)
    if n == 0:
        return []
    lens = np.fromiter((len(r) for r in reads), np.int64, n)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    total_len = int(offsets[-1])
    flat = np.concatenate([np.asarray(r, dtype=np.uint8) for r in reads]) \
        if total_len else np.zeros(1, np.uint8)
    cap = total_len * 2 + 64 * n + 64
    out = _scratch(cap)
    counts = np.empty(n, dtype=np.int64)
    offs = np.empty(n, dtype=np.int64)
    ptrs = _fm_ptrs(fm)
    while True:
        total = lib.fm_collect_seeds_batch(
            *ptrs,
            flat.ctypes.data_as(_c_u8p), offsets.ctypes.data_as(_c_i64p),
            ctypes.c_int64(n), ctypes.c_int(opt.min_seed_len),
            ctypes.c_double(opt.split_factor), ctypes.c_int(opt.split_width),
            ctypes.c_int64(opt.max_mem_intv),
            out.ctypes.data_as(_c_i64p), ctypes.c_int64(len(out)),
            counts.ctypes.data_as(_c_i64p), offs.ctypes.data_as(_c_i64p),
            ctypes.c_int(N_THREADS))
        if total >= 0:
            break
        cap = len(out) * 4
        _tls.seed_out = None
        out = _scratch(cap)
    return [out[offs[i]:offs[i] + counts[i]].copy() for i in range(n)]


def collect_seeds_rbegs_batch(fm, reads: List[np.ndarray], opt
                              ) -> Optional[tuple]:
    """Fused seeding + occurrence SA dereference (one native call).

    Returns (mems_per_read, rbegs_per_read) where mems are (n, 5) int64
    arrays and rbegs int64 arrays in enumerate_occurrences order, or None
    when the fused symbol is unavailable.
    """
    lib = suffix._load_native()
    if lib is None or not hasattr(lib, "fm_collect_seeds_rbegs_batch"):
        return None
    n = len(reads)
    if n == 0:
        return [], []
    lens = np.fromiter((len(r) for r in reads), np.int64, n)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    total_len = int(offsets[-1])
    flat = np.concatenate([np.asarray(r, dtype=np.uint8) for r in reads]) \
        if total_len else np.zeros(1, np.uint8)
    cap = total_len * 2 + 64 * n + 64
    out = _scratch(cap)
    counts = np.empty(n, dtype=np.int64)
    offs = np.empty(n, dtype=np.int64)
    cap_rb = total_len * 4 + 64 * n + 64
    rb_counts = np.empty(n, dtype=np.int64)
    rb_offs = np.empty(n, dtype=np.int64)
    n_mems_out = np.zeros(1, dtype=np.int64)
    ptrs = _fm_ptrs(fm)
    lib.fm_collect_seeds_rbegs_batch.restype = ctypes.c_int64
    while True:
        rb_out = np.empty(cap_rb, dtype=np.int64)
        total = lib.fm_collect_seeds_rbegs_batch(
            *ptrs,
            flat.ctypes.data_as(_c_u8p), offsets.ctypes.data_as(_c_i64p),
            ctypes.c_int64(n), ctypes.c_int(opt.min_seed_len),
            ctypes.c_double(opt.split_factor), ctypes.c_int(opt.split_width),
            ctypes.c_int64(opt.max_mem_intv), ctypes.c_int64(opt.max_occ),
            out.ctypes.data_as(_c_i64p), ctypes.c_int64(len(out)),
            counts.ctypes.data_as(_c_i64p), offs.ctypes.data_as(_c_i64p),
            rb_out.ctypes.data_as(_c_i64p), ctypes.c_int64(cap_rb),
            rb_counts.ctypes.data_as(_c_i64p),
            rb_offs.ctypes.data_as(_c_i64p),
            n_mems_out.ctypes.data_as(_c_i64p), ctypes.c_int(N_THREADS))
        if total >= 0:
            break
        if n_mems_out[0] < 0:          # mems capacity exceeded
            _tls.seed_out = None
            out = _scratch(len(out) * 4)
        else:                          # rbeg capacity exceeded
            cap_rb *= 4
    mems = [out[offs[i]:offs[i] + counts[i]].copy() for i in range(n)]
    rbegs = [rb_out[rb_offs[i]:rb_offs[i] + rb_counts[i]].copy()
             for i in range(n)]
    return mems, rbegs


def sa_lookup_batch(fm, rows: np.ndarray) -> Optional[np.ndarray]:
    lib = suffix._load_native()
    if lib is None or not hasattr(lib, "fm_sa_lookup_batch"):
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    out = np.empty(len(rows), dtype=np.int64)
    lib.fm_sa_lookup_batch(
        *_fm_ptrs(fm),
        rows.ctypes.data_as(_c_i64p), ctypes.c_int64(len(rows)),
        out.ctypes.data_as(_c_i64p), ctypes.c_int(N_THREADS))
    return out
