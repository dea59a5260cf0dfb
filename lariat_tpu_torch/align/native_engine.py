"""ctypes wrapper for the C++ mem_align1_core (native/align1.cpp).

One FFI call runs chain -> filter -> extend -> dedup/patch for a whole batch
of reads (typically every read of a barcode); the Python implementation in
chaining.py/extension.py remains the executable reference and the two are
asserted identical by tests. Set LARIAT_NO_NATIVE_ALIGN1=1 to force Python.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Sequence

import numpy as np

from ..index import suffix
from .extension import AlnReg

_tls = threading.local()
_checked = False
_ok = False


def _lib():
    global _checked, _ok
    lib = suffix._load_native()
    if not _checked:
        _checked = True
        _ok = (lib is not None and hasattr(lib, "mem_align1_batch")
               and not os.environ.get("LARIAT_NO_NATIVE_ALIGN1"))
        if _ok:
            p, i64 = ctypes.c_void_p, ctypes.c_int64
            lib.mem_align1_batch.restype = i64
            lib.mem_align1_batch.argtypes = [
                p, i64, p, i64, p, p, i64, p, p, p, p, p, p, p, i64, p, p]
            if hasattr(lib, "mem_reg2aln_batch"):
                lib.mem_reg2aln_batch.restype = i64
                lib.mem_reg2aln_batch.argtypes = [
                    p, i64, p, i64, p, p, p, i64, p, p, p, p, i64]
            if hasattr(lib, "mismatch_walk_batch"):
                lib.mismatch_walk_batch.restype = i64
                lib.mismatch_walk_batch.argtypes = [
                    p, p, p, p, i64, p, p, p, i64]
            if hasattr(lib, "mismatch_walk_fetch_batch"):
                lib.mismatch_walk_fetch_batch.restype = i64
                lib.mismatch_walk_fetch_batch.argtypes = [
                    p, p, p, p, i64, p, p, p, i64]
    return lib if _ok else None


def _genome_blobs(fm):
    t = getattr(fm, "_align1_blobs", None)
    if t is None:
        pac = np.ascontiguousarray(fm.pac)
        offs = np.array([c.offset for c in fm.contigs], dtype=np.int64)
        fm._align1_blobs = t = (pac, offs)
    return t


def _opt_blobs(opt):
    oi = np.array([
        opt.match_score, -opt.mismatch_penalty, -1,
        opt.gap_open_del, opt.gap_extend_del, opt.gap_open_ins,
        opt.gap_extend_ins, opt.pen_clip5, opt.pen_clip3, opt.zdrop,
        opt.band_width, opt.max_chain_gap, opt.max_occ, opt.min_seed_len,
        opt.min_chain_weight, opt.max_chain_extend], dtype=np.int64)
    od = np.array([opt.mask_level, opt.mask_level_redun, opt.drop_ratio],
                  dtype=np.float64)
    return oi, od


def reg2aln_batch(fm, opt, tasks) -> Optional[list]:
    """mem_reg2aln for (seq_bytes, AlnReg) tasks in one native call.

    Returns SingleReadAlignment list (None regs -> empty alignment), or
    None when the library is missing.
    """
    lib = _lib()
    if lib is None or not hasattr(lib, "mem_reg2aln_batch"):
        return None
    from .engine import SingleReadAlignment, encode_read
    n = len(tasks)
    out = [None] * n
    reads = []
    read_key = {}
    rows = []
    live = []
    for idx, (seq, reg) in enumerate(tasks):
        if reg is None or reg.rb < 0 or reg.re < 0:
            out[idx] = SingleReadAlignment()
            continue
        k = read_key.get(id(seq))
        if k is None:
            k = len(reads)
            read_key[id(seq)] = k
            reads.append(encode_read(seq))
        rows.append((k, reg.qb, reg.qe, reg.rb, reg.re, reg.truesc, reg.w))
        live.append(idx)
    if not rows:
        return out
    pac, contig_offs = _genome_blobs(fm)
    oi, od = _opt_blobs(opt)
    m = len(reads)
    lens = np.fromiter((len(q) for q in reads), np.int64, m)
    r_off = np.zeros(m + 1, np.int64)
    np.cumsum(lens, out=r_off[1:])
    flat = (np.concatenate(reads) if r_off[-1]
            else np.zeros(1, np.uint8))
    flat = np.ascontiguousarray(flat, dtype=np.uint8)
    trows = np.ascontiguousarray(np.array(rows, dtype=np.int64))
    meta = np.empty((len(rows), 6), np.int64)
    cap = int(lens.sum()) * 2 + 16 * len(rows) + 16
    while True:
        cig = np.empty(2 * cap, np.int32)
        total = lib.mem_reg2aln_batch(
            pac.ctypes.data, fm.l_pac, contig_offs.ctypes.data,
            len(contig_offs), flat.ctypes.data, r_off.ctypes.data,
            trows.ctypes.data, len(rows), oi.ctypes.data, od.ctypes.data,
            meta.ctypes.data, cig.ctypes.data, cap)
        if total >= 0:
            break
        cap *= 4
    contigs = fm.contigs
    for (k, qb, qe, rb, re, truesc, w), (idx, mrow) in zip(
            rows, zip(live, meta.tolist())):
        pos, rid, is_rev, nm, n_pairs, coff = mrow
        flatc = cig[2 * coff:2 * (coff + n_pairs)].tolist()
        cigar = tuple(zip(flatc[0::2], flatc[1::2]))
        reg = tasks[idx][1]
        out[idx] = SingleReadAlignment(
            pos=pos - contigs[rid].offset, rid=rid, chrom=contigs[rid].name,
            reversed_=bool(is_rev), edit_distance=nm, cigar=cigar,
            score=reg.score, sub=max(reg.sub, reg.csub), read_s=reg.qb,
            read_e=reg.qe)
    return out


def mismatch_walk_batch(walks) -> Optional[list]:
    """GetAlignments CIGAR walks in one native call.

    ``walks`` rows: (cigar, ref_bytes, read_bytes, ref_start, ref_end,
    reversed_). Returns per-walk (matches, indels, indel_length,
    soft_clipped, soft_clipped_length, mismatch_locs, mismatch_read_locs),
    or None when the library is missing. Raises RuntimeError on the
    cigar-longer-than-read invariant breach (same as the Python walk).
    """
    lib = _lib()
    if lib is None or not hasattr(lib, "mismatch_walk_batch"):
        return None
    n = len(walks)
    if n == 0:
        return []
    cig_parts = []
    tasks = np.zeros((n, 9), np.int64)
    ref_lens = []
    read_lens = []
    coff = 0
    for i, (cigar, ref, read, rs, re_, rev) in enumerate(walks):
        flat = [v for pair in cigar for v in pair]
        cig_parts.append(flat)
        tasks[i, 0] = coff
        tasks[i, 1] = len(cigar)
        coff += 2 * len(cigar)
        ref_lens.append(len(ref))
        read_lens.append(len(read))
        tasks[i, 6] = rs
        tasks[i, 7] = re_
        tasks[i, 8] = 1 if rev else 0
    tasks[1:, 2] = np.cumsum(ref_lens[:-1])
    tasks[1:, 4] = np.cumsum(read_lens[:-1])
    tasks[:, 3] = ref_lens
    tasks[:, 5] = read_lens
    cigars = np.array([v for part in cig_parts for v in part] or [0],
                      dtype=np.int32)
    refs = np.frombuffer(b"".join(w[1] for w in walks) or b"\0", np.uint8)
    reads = np.frombuffer(b"".join(w[2] for w in walks) or b"\0", np.uint8)
    stats = np.empty((n, 6), np.int64)
    mm_offs = np.empty(n, np.int64)
    cap = max(int(sum(read_lens)), 1)
    while True:
        mm = np.empty((cap, 2), np.int64)
        total = lib.mismatch_walk_batch(
            cigars.ctypes.data, refs.ctypes.data, reads.ctypes.data,
            tasks.ctypes.data, n, stats.ctypes.data, mm_offs.ctypes.data,
            mm.ctypes.data, cap)
        if total == -2:
            raise RuntimeError("cigar longer than read")
        if total >= 0:
            break
        cap *= 4
    out = []
    for i in range(n):
        o = int(mm_offs[i])
        c = int(stats[i, 5])
        pairs = mm[o:o + c]
        out.append((int(stats[i, 0]), int(stats[i, 1]), int(stats[i, 2]),
                    int(stats[i, 3]), int(stats[i, 4]),
                    [int(v) for v in pairs[:, 0]],
                    [int(v) for v in pairs[:, 1]]))
    return out


def mismatch_walk_fetch_batch(fm, walks) -> Optional[list]:
    """mismatch_walk_batch with C++-side reference fetch from the unpacked
    codes cache (no per-candidate Python get_seq).

    ``walks`` rows: (cigar, read_bytes, goff, ref_start, ref_end, reversed_)
    where goff is the contig's global offset. Returns the same tuples as
    mismatch_walk_batch, or None when the native lib / codes cache is
    unavailable. Read bytes are deduped by object identity (each read
    appears once in the concat buffer however many candidates it has).
    """
    lib = _lib()
    codes = getattr(fm, "_codes_cache", None)
    if codes is None and fm.l_pac <= fm.CODES_CACHE_MAX:
        fm.get_seq_codes(0, 1)  # builds and attaches the cache
        codes = getattr(fm, "_codes_cache", None)
    if lib is None or codes is None \
            or not hasattr(lib, "mismatch_walk_fetch_batch"):
        return None
    n = len(walks)
    if n == 0:
        return []
    from itertools import chain
    l_pac = int(fm.l_pac)
    cigs, reads_l, goffs, rss, res_, revs = zip(*walks)
    ncig = np.fromiter(map(len, cigs), np.int64, n)
    total_ops = int(ncig.sum())
    cigars = (np.fromiter(chain.from_iterable(chain.from_iterable(cigs)),
                          np.int32, 2 * total_ops)
              if total_ops else np.zeros(1, np.int32))
    tasks = np.empty((n, 9), np.int64)
    tasks[0, 0] = 0
    np.cumsum(2 * ncig[:-1], out=tasks[1:, 0])
    tasks[:, 1] = ncig
    goff_a = np.fromiter(goffs, np.int64, n)
    rs_a = np.fromiter(rss, np.int64, n)
    re_a = np.fromiter(res_, np.int64, n)
    np.clip(goff_a + rs_a, 0, None, out=tasks[:, 2])
    np.clip(goff_a + re_a, None, l_pac, out=tasks[:, 3])
    tasks[:, 6] = rs_a
    tasks[:, 7] = re_a
    tasks[:, 8] = np.fromiter(revs, bool, n)
    read_offs: dict = {}
    read_chunks = []
    read_total = 0
    col4 = tasks[:, 4]
    col5 = tasks[:, 5]
    for i, read in enumerate(reads_l):
        ro = read_offs.get(id(read))
        if ro is None:
            ro = read_total
            read_offs[id(read)] = ro
            read_chunks.append(read)
            read_total += len(read)
        col4[i] = ro
        col5[i] = len(read)
    read_lens_sum = int(col5.sum())
    reads = np.frombuffer(b"".join(read_chunks) or b"\0", np.uint8)
    stats = np.empty((n, 6), np.int64)
    mm_offs = np.empty(n, np.int64)
    cap = max(int(read_lens_sum), 1)
    while True:
        mm = np.empty((cap, 2), np.int64)
        total = lib.mismatch_walk_fetch_batch(
            cigars.ctypes.data, codes.ctypes.data, reads.ctypes.data,
            tasks.ctypes.data, n, stats.ctypes.data, mm_offs.ctypes.data,
            mm.ctypes.data, cap)
        if total == -2:
            raise RuntimeError("cigar longer than read")
        if total >= 0:
            break
        cap *= 4
    out = []
    stats_l = stats.tolist()
    mm_offs_l = mm_offs.tolist()
    mm0 = mm[:total, 0].tolist()
    mm1 = mm[:total, 1].tolist()
    for i in range(n):
        o = mm_offs_l[i]
        st = stats_l[i]
        c = st[5]
        out.append((st[0], st[1], st[2], st[3], st[4],
                    mm0[o:o + c], mm1[o:o + c]))
    return out


def _regs_from_rows(out: np.ndarray, counts, offs, n: int, total: int
                    ) -> List[List[AlnReg]]:
    """(total, 14) float rows -> per-read AlnReg lists. Bulk .tolist()
    conversion: per-element numpy scalar indexing costs ~100 ns each and
    the row count is ~10 per pair."""
    ints = out[:total, :13].astype(np.int64).tolist()
    fracs = out[:total, 13].tolist()
    offs_l = offs.tolist()
    counts_l = counts.tolist()
    result: List[List[AlnReg]] = []
    for i in range(n):
        o, c = offs_l[i], counts_l[i]
        result.append([AlnReg(*ints[k], fracs[k]) for k in range(o, o + c)])
    return result


def align1_batch(fm, opt, qs: Sequence[np.ndarray],
                 mems_list: Sequence, rbegs_list: Sequence
                 ) -> Optional[List[List[AlnReg]]]:
    """Candidate regions for each read; None when the library is missing.

    ``mems_list[i]`` is the read's SMEM rows ([x0,x1,s,qb,qe] tuples or an
    (n, 5) array), ``rbegs_list[i]`` the SA positions in
    enumerate_occurrences order.
    """
    lib = _lib()
    if lib is None:
        return None
    n = len(qs)
    if n == 0:
        return []
    pac, contig_offs = _genome_blobs(fm)
    oi, od = _opt_blobs(opt)
    lens = np.fromiter((len(q) for q in qs), np.int64, n)
    r_off = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=r_off[1:])
    flat = (np.concatenate([np.ascontiguousarray(q, dtype=np.uint8)
                            for q in qs])
            if r_off[-1] else np.zeros(1, np.uint8))
    m_counts = np.fromiter((len(m) for m in mems_list), np.int64, n)
    m_off = np.zeros(n + 1, np.int64)
    np.cumsum(m_counts, out=m_off[1:])
    if m_off[-1]:
        def _rows(m):
            if isinstance(m, np.ndarray):
                return m.reshape(-1, 5)
            return np.array([(p.x0, p.x1, p.s, p.qb, p.qe) for p in m],
                            dtype=np.int64).reshape(-1, 5)
        mems_flat = np.ascontiguousarray(
            np.concatenate([_rows(m) if len(m)
                            else np.zeros((0, 5), np.int64)
                            for m in mems_list]), dtype=np.int64)
    else:
        mems_flat = np.zeros((1, 5), np.int64)
    b_counts = np.fromiter((len(b) for b in rbegs_list), np.int64, n)
    b_off = np.zeros(n + 1, np.int64)
    np.cumsum(b_counts, out=b_off[1:])
    rbegs_flat = (np.ascontiguousarray(
        np.concatenate([np.asarray(b, dtype=np.int64) for b in rbegs_list]))
        if b_off[-1] else np.zeros(1, np.int64))
    cap = int(b_off[-1]) + 8 * n + 8
    counts = np.empty(n, np.int64)
    offs = np.empty(n, np.int64)
    while True:
        out = np.empty((cap, 14), np.float64)
        total = lib.mem_align1_batch(
            pac.ctypes.data, fm.l_pac, contig_offs.ctypes.data,
            len(contig_offs), flat.ctypes.data, r_off.ctypes.data, n,
            mems_flat.ctypes.data, m_off.ctypes.data, rbegs_flat.ctypes.data,
            b_off.ctypes.data, oi.ctypes.data, od.ctypes.data,
            out.ctypes.data, cap, counts.ctypes.data, offs.ctypes.data)
        if total >= 0:
            break
        cap *= 4
    return _regs_from_rows(out, counts, offs, n, int(total))


class Align1Session:
    """Two-phase mem_align1: C++ control flow + device extension waves.

    Usage (BatchAlignmentEngine.align_batch):

        sess = Align1Session(fm, opt, qs, mems_list, rbegs_list)
        while sess.pending():
            wave = sess.wave_arrays()          # padded (B, L) uint8 buffers
            res = <device extend kernel>(...)
            sess.feed(res)
        regs_per_read = sess.finish()

    Bit-identical to align1_batch (asserted by tests): only the schedule of
    the banded-SW extensions changes, never their inputs.
    """

    _registered = False

    @classmethod
    def _register(cls, lib):
        if cls._registered:
            return
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.a1s_start.restype = p
        lib.a1s_start.argtypes = [p, i64, p, i64, p, p, i64, p, p, p, p,
                                  p, p, p]
        lib.a1s_fill.argtypes = [p, p, i64, p, i64, p, p, p, p]
        if hasattr(lib, "a1s_fill_desc"):
            lib.a1s_fill_desc.argtypes = [p] * 10
        lib.a1s_feed.argtypes = [p, p, p, p, p, p, p, p]
        lib.a1s_finish.restype = i64
        lib.a1s_finish.argtypes = [p, p, i64, p, p]
        lib.a1s_free.argtypes = [p]
        cls._registered = True

    @staticmethod
    def available() -> bool:
        lib = _lib()
        return lib is not None and hasattr(lib, "a1s_start")

    def __init__(self, fm, opt, qs, mems_list, rbegs_list):
        lib = _lib()
        assert lib is not None and hasattr(lib, "a1s_start")
        self._register(lib)
        self.lib = lib
        self.n = n = len(qs)
        self.handle = None
        pac, contig_offs = _genome_blobs(fm)
        self._keep = (pac, contig_offs)   # pointers must outlive the session
        oi, od = _opt_blobs(opt)
        lens = np.fromiter((len(q) for q in qs), np.int64, n)
        r_off = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=r_off[1:])
        flat = (np.concatenate([np.ascontiguousarray(q, dtype=np.uint8)
                                for q in qs])
                if r_off[-1] else np.zeros(1, np.uint8))
        m_counts = np.fromiter((len(m) for m in mems_list), np.int64, n)
        m_off = np.zeros(n + 1, np.int64)
        np.cumsum(m_counts, out=m_off[1:])
        if m_off[-1]:
            mems_flat = np.ascontiguousarray(np.concatenate(
                [np.asarray(m, np.int64).reshape(-1, 5) if len(m)
                 else np.zeros((0, 5), np.int64) for m in mems_list]),
                dtype=np.int64)
        else:
            mems_flat = np.zeros((1, 5), np.int64)
        b_counts = np.fromiter((len(b) for b in rbegs_list), np.int64, n)
        b_off = np.zeros(n + 1, np.int64)
        np.cumsum(b_counts, out=b_off[1:])
        rbegs_flat = (np.ascontiguousarray(
            np.concatenate([np.asarray(b, np.int64) for b in rbegs_list]))
            if b_off[-1] else np.zeros(1, np.int64))
        self.info = np.zeros(4, np.int64)
        self.handle = lib.a1s_start(
            pac.ctypes.data, fm.l_pac, contig_offs.ctypes.data,
            len(contig_offs), flat.ctypes.data, r_off.ctypes.data, n,
            mems_flat.ctypes.data, m_off.ctypes.data, rbegs_flat.ctypes.data,
            b_off.ctypes.data, oi.ctypes.data, od.ctypes.data,
            self.info.ctypes.data)

    def pending(self) -> int:
        return int(self.info[0])

    def phase(self) -> int:
        """0 while serving left waves (end bonus pen_clip5), 1 for right
        (pen_clip3)."""
        return int(self.info[3])

    def wave_arrays(self, pad_b=None, pad_len=64, q_tiers=None,
                    t_tiers=None):
        """(q, qlen, t, tlen, h0, w) padded device-ready arrays.

        B is padded to pad_b(B) (power-of-two bucket by default) and lane
        dims to multiples of pad_len — or to the given fixed tier lists.
        Every distinct (Lq, Lt) pair costs one Mosaic kernel compile
        (minutes over a remote-compile TPU link), so the Pallas path pins
        dims to 2-3 tiers.
        """
        B = int(self.info[0])
        maxq = max(int(self.info[1]), 1)
        maxt = max(int(self.info[2]), 1)
        Lq = _tier(maxq, q_tiers) if q_tiers else -(-maxq // pad_len) * pad_len
        Lt = _tier(maxt, t_tiers) if t_tiers else -(-maxt // pad_len) * pad_len
        Bp = pad_b(B) if pad_b else _pow2(B)
        q = np.zeros((Bp, Lq), np.uint8)
        t = np.zeros((Bp, Lt), np.uint8)
        qlen = np.zeros(Bp, np.int32)
        tlen = np.zeros(Bp, np.int32)
        h0 = np.zeros(Bp, np.int32)
        w = np.zeros(Bp, np.int32)
        self.lib.a1s_fill(self.handle, q.ctypes.data, Lq, t.ctypes.data, Lt,
                          qlen.ctypes.data, tlen.ctypes.data,
                          h0.ctypes.data, w.ctypes.data)
        return q, qlen, t, tlen, h0, w

    def wave_descs(self, pad_b=None, pad_len=64, q_tiers=None,
                   t_tiers=None):
        """Descriptor form of wave_arrays: per-task slice descriptors
        (rid, qstart, qdir, qlen, tstart, tdir, tlen, h0, w), padded like
        wave_arrays plus (Lq, Lt) tier dims. The device reconstructs q/t
        from resident reads + pac (ops/resident.py) — ~48 B/task upload
        instead of ~3 KB. Padded tasks have qlen = tlen = 0."""
        if not hasattr(self.lib, "a1s_fill_desc"):
            return None
        B = int(self.info[0])
        maxq = max(int(self.info[1]), 1)
        maxt = max(int(self.info[2]), 1)
        Lq = _tier(maxq, q_tiers) if q_tiers else -(-maxq // pad_len) * pad_len
        Lt = _tier(maxt, t_tiers) if t_tiers else -(-maxt // pad_len) * pad_len
        Bp = pad_b(B) if pad_b else _pow2(B)
        rid = np.zeros(Bp, np.int32)
        qstart = np.zeros(Bp, np.int64)
        qdir = np.ones(Bp, np.int32)
        qlen = np.zeros(Bp, np.int32)
        tstart = np.zeros(Bp, np.int64)
        tdir = np.ones(Bp, np.int32)
        tlen = np.zeros(Bp, np.int32)
        h0 = np.zeros(Bp, np.int32)
        w = np.zeros(Bp, np.int32)
        self.lib.a1s_fill_desc(
            self.handle, rid.ctypes.data, qstart.ctypes.data,
            qdir.ctypes.data, qlen.ctypes.data, tstart.ctypes.data,
            tdir.ctypes.data, tlen.ctypes.data, h0.ctypes.data,
            w.ctypes.data)
        return (rid, qstart, qdir, qlen, tstart, tdir, tlen, h0, w,
                Lq, Lt)

    def feed(self, score, qle, tle, gtle, gscore, max_off) -> int:
        """Feed device results (any array-likes, first pending() entries
        used); returns the next wave size."""
        B = int(self.info[0])
        arrs = [np.ascontiguousarray(np.asarray(a)[:B], dtype=np.int32)
                for a in (score, qle, tle, gtle, gscore, max_off)]
        self.lib.a1s_feed(self.handle, *(a.ctypes.data for a in arrs),
                          self.info.ctypes.data)
        return int(self.info[0])

    def finish(self):
        """Regions per read (same semantics as align1_batch)."""
        from .extension import AlnReg
        n = self.n
        counts = np.empty(n, np.int64)
        offs = np.empty(n, np.int64)
        cap = 64 * n + 64
        while True:
            out = np.empty((cap, 14), np.float64)
            total = self.lib.a1s_finish(self.handle, out.ctypes.data, cap,
                                        counts.ctypes.data, offs.ctypes.data)
            if total >= 0:
                break
            cap *= 4
        return _regs_from_rows(out, counts, offs, n, int(total))

    def close(self):
        if self.handle:
            self.lib.a1s_free(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _pow2(n: int, floor: int = 128) -> int:
    b = floor
    while b < n:
        b <<= 1
    return b


class Reg2AlnSession:
    """Two-phase mem_reg2aln: C++ ladder/finish + device global-DP waves.

    Same protocol as Align1Session; feed() takes the padded cigar matrix
    that ksw_cigar_from_ops_batch produces (no per-task Python)."""

    _registered = False

    @classmethod
    def _register(cls, lib):
        if cls._registered:
            return
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.r2s_start.restype = p
        lib.r2s_start.argtypes = [p, i64, p, i64, p, p, p, i64, p, p]
        lib.r2s_fill.argtypes = [p, p, i64, p, i64, p, p, p]
        if hasattr(lib, "r2s_fill_desc"):
            lib.r2s_fill_desc.argtypes = [p] * 9
        lib.r2s_feed.argtypes = [p, p, p, i64, p, p]
        lib.r2s_finish.restype = i64
        lib.r2s_finish.argtypes = [p, p, p, i64]
        lib.r2s_free.argtypes = [p]
        cls._registered = True

    @staticmethod
    def available() -> bool:
        lib = _lib()
        return lib is not None and hasattr(lib, "r2s_start")

    def __init__(self, fm, opt, reads, task_rows):
        """reads: list of code arrays; task_rows: (n, 7) int64
        [read_idx, qb, qe, rb, re, truesc, reg_w]."""
        lib = _lib()
        assert lib is not None and hasattr(lib, "r2s_start")
        self._register(lib)
        self.lib = lib
        self.n = len(task_rows)
        self.handle = None
        pac, contig_offs = _genome_blobs(fm)
        self._keep = (pac, contig_offs)
        oi, _ = _opt_blobs(opt)
        m = len(reads)
        lens = np.fromiter((len(q) for q in reads), np.int64, m)
        r_off = np.zeros(m + 1, np.int64)
        np.cumsum(lens, out=r_off[1:])
        flat = (np.concatenate([np.ascontiguousarray(q, dtype=np.uint8)
                                for q in reads])
                if r_off[-1] else np.zeros(1, np.uint8))
        rows = np.ascontiguousarray(np.asarray(task_rows, np.int64)
                                    .reshape(-1, 7))
        self.info = np.zeros(4, np.int64)
        self.handle = lib.r2s_start(
            pac.ctypes.data, fm.l_pac, contig_offs.ctypes.data,
            len(contig_offs), flat.ctypes.data, r_off.ctypes.data,
            rows.ctypes.data, len(rows), oi.ctypes.data,
            self.info.ctypes.data)

    def pending(self) -> int:
        return int(self.info[0])

    def wave_arrays(self, pad_b=None, pad_len=64, q_tiers=None,
                    t_tiers=None):
        B = int(self.info[0])
        maxq = max(int(self.info[1]), 1)
        maxt = max(int(self.info[2]), 1)
        Lq = _tier(maxq, q_tiers) if q_tiers else -(-maxq // pad_len) * pad_len
        Lt = _tier(maxt, t_tiers) if t_tiers else -(-maxt // pad_len) * pad_len
        Bp = pad_b(B) if pad_b else _pow2(B)
        q = np.zeros((Bp, Lq), np.uint8)
        t = np.zeros((Bp, Lt), np.uint8)
        qlen = np.ones(Bp, np.int32)   # pad lanes: 1-base dummies
        tlen = np.ones(Bp, np.int32)
        w = np.ones(Bp, np.int32)
        self.lib.r2s_fill(self.handle, q.ctypes.data, Lq, t.ctypes.data, Lt,
                          qlen.ctypes.data, tlen.ctypes.data, w.ctypes.data)
        return q, qlen, t, tlen, w

    def wave_descs(self, pad_b=None, pad_len=64, q_tiers=None,
                   t_tiers=None):
        """Descriptor form of wave_arrays (see Align1Session.wave_descs).
        Pad lanes are 1-base dummies like wave_arrays. Returns
        (rid, qstart, qdir, qlen, tstart, tdir, tlen, w, Lq, Lt)."""
        if not hasattr(self.lib, "r2s_fill_desc"):
            return None
        B = int(self.info[0])
        maxq = max(int(self.info[1]), 1)
        maxt = max(int(self.info[2]), 1)
        Lq = _tier(maxq, q_tiers) if q_tiers else -(-maxq // pad_len) * pad_len
        Lt = _tier(maxt, t_tiers) if t_tiers else -(-maxt // pad_len) * pad_len
        Bp = pad_b(B) if pad_b else _pow2(B)
        rid = np.zeros(Bp, np.int32)
        qstart = np.zeros(Bp, np.int64)
        qdir = np.ones(Bp, np.int32)
        qlen = np.ones(Bp, np.int32)   # pad lanes: 1-base dummies
        tstart = np.zeros(Bp, np.int64)
        tdir = np.ones(Bp, np.int32)
        tlen = np.ones(Bp, np.int32)
        w = np.ones(Bp, np.int32)
        self.lib.r2s_fill_desc(
            self.handle, rid.ctypes.data, qstart.ctypes.data,
            qdir.ctypes.data, qlen.ctypes.data, tstart.ctypes.data,
            tdir.ctypes.data, tlen.ctypes.data, w.ctypes.data)
        return rid, qstart, qdir, qlen, tstart, tdir, tlen, w, Lq, Lt

    def feed(self, score, cig_mat, nops) -> int:
        """score int32[B+]; cig_mat (B+, 2*cap) int32 op/len pairs;
        nops int32[B+]. Only the first pending() rows are consumed."""
        B = int(self.info[0])
        score = np.ascontiguousarray(np.asarray(score)[:B], np.int32)
        cig_mat = np.ascontiguousarray(np.asarray(cig_mat)[:B], np.int32)
        nops = np.ascontiguousarray(np.asarray(nops)[:B], np.int32)
        cap = cig_mat.shape[1] // 2
        self.lib.r2s_feed(self.handle, score.ctypes.data, cig_mat.ctypes.data,
                          cap, nops.ctypes.data, self.info.ctypes.data)
        return int(self.info[0])

    def feed_cigar_lists(self, score, cigars) -> int:
        """Fallback feed from per-task [(op, len), ...] lists."""
        B = int(self.info[0])
        cap = max((len(c) for c in cigars[:B]), default=1) + 1
        mat = np.zeros((B, 2 * cap), np.int32)
        nops = np.zeros(B, np.int32)
        for i, c in enumerate(cigars[:B]):
            nops[i] = len(c)
            if c:
                mat[i, :2 * len(c)] = np.asarray(c, np.int32).ravel()
        return self.feed(score, mat, nops)

    def finish(self):
        """(meta (n,6) int64, cigar flat int32 pairs): mem_reg2aln_batch
        format [pos_global, rid, is_rev, NM, n_cigar, cigar_off]."""
        meta = np.empty((self.n, 6), np.int64)
        cap = 16 * self.n + 16
        while True:
            cig = np.empty(2 * cap, np.int32)
            total = self.lib.r2s_finish(self.handle, meta.ctypes.data,
                                        cig.ctypes.data, cap)
            if total >= 0:
                break
            cap *= 4
        return meta, cig

    def close(self):
        if self.handle:
            self.lib.r2s_free(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _tier(x: int, tiers) -> int:
    """Smallest tier >= x, or a multiple of the last tier."""
    for t in tiers:
        if x <= t:
            return t
    last = tiers[-1]
    return -(-x // last) * last
