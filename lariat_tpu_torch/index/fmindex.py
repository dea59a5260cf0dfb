"""FMD-index: 2-bit genome, BWT, occ checkpoints, sampled suffix array.

The index layout matches the semantics the reference's native engine consumes
via ``bwa_idx_load`` (reference ``go/src/gobwa/gobwa.go:128-147``):

- text T = forward genome ++ reverse-complement (length ``seq_len = 2*l_pac``),
  suffix array over T$ with the sentinel row removed from the physical BWT and
  remembered as ``primary``;
- ``L2[c]`` cumulative base counts, ``occ`` rank checkpoints, suffix-array
  samples every ``sa_intv`` rows;
- ambiguous FASTA bases are replaced by pseudo-random bases from an LCG seeded
  with 11 (drand48 semantics), and recorded as amb regions, reproducing the
  native index builder's behavior so scores match on N-containing genomes.

Can also load an existing BWA-format index (``.pac/.ann/.amb/.bwt/.sa``) so
users of the reference can reuse their prebuilt genome indexes directly.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import List, Optional, Tuple

import numpy as np

from . import suffix

OCC_INTERVAL = 128
SA_INTERVAL = 32
# rows an index build step handles at a time (the SA's BWT gather, the
# primary search, the counts, the occ checkpoints): 2^26 rows hold the
# step's temporaries near 0.6 GB; tests shrink it to cross chunk seams
_BUILD_CHUNK = 1 << 26

# base codes: A=0 C=1 G=2 T=3, anything else 4 (nst_nt4 semantics)
NT4_TABLE = np.full(256, 4, dtype=np.uint8)
for _i, _b in enumerate(b"ACGT"):
    NT4_TABLE[_b] = _i
    NT4_TABLE[ord(chr(_b).lower())] = _i


_FWD_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)
_RC_LUT = np.frombuffer(b"TGCA", dtype=np.uint8)


@dataclasses.dataclass
class Contig:
    name: str
    offset: int
    length: int


@dataclasses.dataclass
class AmbRegion:
    offset: int
    length: int
    base: str


class Drand48:
    """drand48-family LCG; bwa seeds it with 11 for ambiguous-base fill."""

    A = 0x5DEECE66D
    C = 0xB
    MASK = (1 << 48) - 1

    def __init__(self, seed: int = 11):
        self.x = ((seed << 16) | 0x330E) & self.MASK

    def lrand48(self) -> int:
        self.x = (self.A * self.x + self.C) & self.MASK
        return self.x >> 17


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """Pack base codes (0..3) 4-per-byte, first base in the high bits."""
    n = len(codes)
    padded = np.zeros((n + 3) // 4 * 4, dtype=np.uint8)
    padded[:n] = codes
    q = padded.reshape(-1, 4)
    return (q[:, 0] << 6 | q[:, 1] << 4 | q[:, 2] << 2 | q[:, 3]).astype(np.uint8)


def unpack_2bit(pac: np.ndarray, n: int) -> np.ndarray:
    q = np.empty((len(pac), 4), dtype=np.uint8)
    q[:, 0] = pac >> 6
    q[:, 1] = (pac >> 4) & 3
    q[:, 2] = (pac >> 2) & 3
    q[:, 3] = pac & 3
    return q.reshape(-1)[:n]


class FMIndex:
    """Host-side FMD index with bwa-convention rank/SA operations."""

    def __init__(self, *, l_pac: int, primary: int, L2: np.ndarray,
                 bwt_codes: np.ndarray, sa_intv: int, sa_samples: np.ndarray,
                 pac: np.ndarray, contigs: List[Contig],
                 ambs: Optional[List[AmbRegion]] = None,
                 occ_ckpt: Optional[np.ndarray] = None):
        self.l_pac = int(l_pac)
        self.seq_len = 2 * self.l_pac
        self.primary = int(primary)
        self.L2 = np.asarray(L2, dtype=np.int64)          # length 5 cumulative
        self.bwt_codes = np.asarray(bwt_codes, dtype=np.uint8)  # physical BWT
        self.sa_intv = int(sa_intv)
        self.sa_samples = np.asarray(sa_samples, dtype=np.int64)
        self.pac = np.asarray(pac, dtype=np.uint8)        # forward 2-bit packed
        self.contigs = contigs
        self.ambs = ambs or []
        self.name_to_tid = {c.name: i for i, c in enumerate(contigs)}
        # occ checkpoints every OCC_INTERVAL bases over the physical BWT
        # (a full pass over bwt_codes — persisted in the npz so loading an
        # hg38-scale index skips ~30 s of recount)
        if occ_ckpt is None:
            occ_ckpt = _blocked_counts(self.bwt_codes, OCC_INTERVAL)
        self.occ_ckpt = occ_ckpt  # int64[(nblocks+1), 4]: counts before block
        self._packed_words = None
        self._dir = None          # .lariat.d path when mmap-loaded from one

    # ---------------- rank / search primitives (bwa conventions) -----------

    def occ(self, k, c) -> int:
        """Count of code c in physical BWT rows [0..k] of the rotation matrix.

        k is a row index in the (seq_len+1)-row matrix; k may be -1 (returns
        0) or seq_len (returns total). Handles the removed sentinel row.
        """
        if k == self.seq_len:
            return int(self.L2[c + 1] - self.L2[c])
        if k < 0:
            return 0
        k = int(k)
        if k >= self.primary:
            k -= 1
        blk, rem = divmod(k + 1, OCC_INTERVAL)
        base = int(self.occ_ckpt[blk, c])
        if rem:
            start = blk * OCC_INTERVAL
            base += int(np.count_nonzero(self.bwt_codes[start:start + rem] == c))
        return base

    def occ4(self, k) -> np.ndarray:
        """occ for all four codes at once."""
        if k == self.seq_len:
            return (self.L2[1:5] - self.L2[0:4]).astype(np.int64)
        if k < 0:
            return np.zeros(4, dtype=np.int64)
        k = int(k)
        if k >= self.primary:
            k -= 1
        blk, rem = divmod(k + 1, OCC_INTERVAL)
        out = self.occ_ckpt[blk].copy()
        if rem:
            start = blk * OCC_INTERVAL
            seg = self.bwt_codes[start:start + rem]
            out += np.bincount(seg, minlength=4).astype(np.int64)
        return out

    def backward_ext(self, k: int, l: int, c: int) -> Tuple[int, int]:
        """One backward-search step; interval [k, l] inclusive, empty if k>l."""
        nk = int(self.L2[c]) + self.occ(k - 1, c) + 1
        nl = int(self.L2[c]) + self.occ(l, c)
        return nk, nl

    def sa_lookup(self, k: int) -> int:
        """Text position of the suffix at row k (bwt_sa semantics)."""
        steps = 0
        while k % self.sa_intv != 0:
            steps += 1
            k = self.lf(k)
        # sa_samples[0] is -1 by convention: a walk that wraps through the
        # sentinel row accumulates one extra step which the -1 cancels.
        return int(self.sa_samples[k // self.sa_intv]) + steps

    def lf(self, k: int) -> int:
        """LF mapping / bwt_invPsi: row of the suffix starting one base earlier."""
        if k == self.primary:
            return 0
        kx = k - 1 if k > self.primary else k
        c = int(self.bwt_codes[kx])
        return int(self.L2[c]) + self.occ(k, c)

    @property
    def packed_words(self) -> np.ndarray:
        """BWT as uint32 words (16 codes/word, base 0 high bits), block-padded.

        Computed by pairwise doubling (2 -> 4 -> 8 -> 16 codes per element)
        so the cost is ~4 shrinking passes; the naive 16x (N, 16)-astype
        version took ~10 min at hg38 scale. Persisted by ``save_dir`` so
        loads (and every forked worker) skip even that.
        """
        if self._packed_words is None:
            n = len(self.bwt_codes)
            n_blocks = (n + OCC_INTERVAL - 1) // OCC_INTERVAL
            pad = np.zeros(n_blocks * OCC_INTERVAL, dtype=np.uint8)
            pad[:n] = self.bwt_codes
            c2 = (pad[0::2] << 2) | pad[1::2]          # 2 codes / uint8
            c4 = (c2[0::2].astype(np.uint16) << 4) | c2[1::2]
            c8 = (c4[0::2] << np.uint16(8)) | c4[1::2]  # 8 codes / uint16
            c16 = (c8[0::2].astype(np.uint32) << 16) | c8[1::2]
            self._packed_words = np.ascontiguousarray(c16)
        return self._packed_words

    def sa_lookup_many(self, rows: np.ndarray) -> np.ndarray:
        """Batched sa_lookup, native when available."""
        from . import native_ops
        out = native_ops.sa_lookup_batch(self, rows)
        if out is not None:
            return out
        return np.array([self.sa_lookup(int(r)) for r in rows], dtype=np.int64)

    # ---------------- sequence fetch ---------------------------------------

    # Genomes below this size keep a fully unpacked codes array (1 byte/base)
    # for O(1) window fetches; larger ones (hg38 ~3.1 GB) unpack per window.
    # Workers forked after the first fetch share the cache copy-on-write.
    CODES_CACHE_MAX = 1 << 31

    def ensure_codes_cache(self) -> None:
        """Unpack the full 2-bit pac to a byte-per-base cache even past
        CODES_CACHE_MAX (1 byte/base, ~3.1 GB for hg38). The CLI calls this
        BEFORE forking workers so the cache is shared copy-on-write instead
        of being skipped (per-window unpack) in every worker.

        Disk-cached as ``codes.npy`` in the .lariat.d dir (atomic rename):
        the unpack is a ~31 s single-thread pass at hg38 scale, paid once
        per index instead of once per run."""
        if getattr(self, "_codes_cache", None) is not None:
            return
        d = getattr(self, "_dir", None)
        path = os.path.join(d, "codes.npy") if d else None
        if path and os.path.exists(path):
            self._codes_cache = np.load(path, mmap_mode="r")
            return
        self._codes_cache = unpack_2bit(self.pac, self.l_pac)
        if path:
            try:
                import tempfile
                fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
                with os.fdopen(fd, "wb") as f:
                    np.save(f, self._codes_cache)
                os.replace(tmp, path)
            except OSError:
                pass

    # Arrays below this size stay wherever they were loaded; migrating tiny
    # test indexes would only add noise.
    _HOT_MIN_BYTES = 64 << 20

    def ensure_native_hot(self) -> None:
        """Migrate the native seeder's hot arrays (packed BWT words, occ
        checkpoints, SA samples) from their file-backed mmaps into anonymous
        transparent-hugepage memory.

        At hg38 scale these are ~4.6 GB of 4 KB-paged, file-backed mmap;
        every FM operation (occ rank, LF step) is a random access, so the
        dTLB misses dominate and even software prefetch is dropped on them.
        2 MB huge pages cut the walk from ~9 us to ~4 us per SA occurrence
        (measured, 3.09 Gbp / sa_intv=32). The CLI calls this BEFORE forking
        workers so the one hot copy is shared copy-on-write — the per-worker
        page-fault warmup disappears too."""
        import mmap as _mmap

        if getattr(self, "_hot_bufs", None):
            return
        bufs = []
        copies = []
        for name in ("_packed_words", "occ_ckpt", "sa_samples",
                     "_codes_cache", "pac"):
            src = (self.packed_words if name == "_packed_words"
                   else getattr(self, name, None))
            if src is None:
                continue
            src = np.ascontiguousarray(src)
            if src.nbytes < self._HOT_MIN_BYTES:
                continue
            try:
                # MAP_PRIVATE, not the fileno=-1 default of MAP_SHARED:
                # shared anonymous memory is shmem, whose THP policy
                # (shmem_enabled) is commonly `never`, silently turning the
                # MADV_HUGEPAGE below into a no-op. Private anonymous memory
                # follows the main `enabled=madvise` policy and still shares
                # read-only across the pre-fork worker pool.
                flags = getattr(_mmap, "MAP_PRIVATE", 0) | getattr(
                    _mmap, "MAP_ANONYMOUS", 0)
                buf = (_mmap.mmap(-1, src.nbytes, flags=flags) if flags
                       else _mmap.mmap(-1, src.nbytes))
            except (OSError, ValueError, OverflowError):
                continue  # low-RAM host: keep the file-backed mapping
            try:
                buf.madvise(_mmap.MADV_HUGEPAGE)
            except (AttributeError, OSError):
                pass  # still worth it: anonymous pages beat file-backed
            dst = np.frombuffer(buf, dtype=src.dtype).reshape(src.shape)
            copies.append((name, src, dst))
            bufs.append(buf)
        if copies:
            # np.copyto releases the GIL: fan the ~8 GB of hugepage fills
            # over a few threads (the copies were ~28 s sequential at hg38
            # scale — fault + write bound, scales with cores)
            from concurrent.futures import ThreadPoolExecutor

            def _fill(item):
                name, src, dst = item
                dst.setflags(write=True)
                np.copyto(dst, src)
                dst.setflags(write=False)
                setattr(self, name, dst)
            with ThreadPoolExecutor(max_workers=min(4, len(copies))) as ex:
                list(ex.map(_fill, copies))
        if bufs:
            self._hot_bufs = bufs  # keep the mappings alive
            # ctypes pointer caches hold addresses into the old mmaps
            for cache in ("_native_ptr_cache", "_occ_contig_cache",
                          "_align1_blobs"):
                if hasattr(self, cache):
                    delattr(self, cache)

    def get_seq_codes(self, start: int, end: int) -> np.ndarray:
        """Base codes of the forward pac in global coords [start, end)."""
        start = max(0, int(start))
        end = min(self.l_pac, int(end))
        if end <= start:
            return np.zeros(0, dtype=np.uint8)
        cache = getattr(self, "_codes_cache", None)
        if cache is None and self.l_pac <= self.CODES_CACHE_MAX:
            cache = unpack_2bit(self.pac, self.l_pac)
            self._codes_cache = cache
        if cache is not None:
            return cache[start:end]
        first_byte = start // 4
        last_byte = (end + 3) // 4
        codes = unpack_2bit(self.pac[first_byte:last_byte],
                            (last_byte - first_byte) * 4)
        return codes[start - first_byte * 4: start - first_byte * 4 + (end - start)]

    def fetch_fmd(self, start: int, end: int) -> np.ndarray:
        """Base codes of the doubled (FMD) text for [start, end), clamped.

        Positions >= l_pac map to the reverse-complement strand, mirroring
        bns_fetch_seq over the doubled coordinate space (gobwa.go:50-80).
        """
        start, end = int(start), int(end)
        start = max(0, start)
        end = min(self.seq_len, end)
        if end <= start:
            return np.zeros(0, dtype=np.uint8)
        if end <= self.l_pac:
            return self.get_seq_codes(start, end)
        if start >= self.l_pac:
            fwd = self.get_seq_codes(self.seq_len - end, self.seq_len - start)
            return (3 - fwd)[::-1].copy()
        raise ValueError("fetch_fmd range crosses the strand boundary")

    def get_seq(self, chrom: str, start: int, end: int, reversed_: bool) -> bytes:
        """ASCII sequence of contig [start, end), revcomp when reversed_.

        Mirrors GoBwaReference.GetSeq (gobwa.go:50-80).
        """
        tid = self.name_to_tid[chrom]
        off = self.contigs[tid].offset
        codes = self.get_seq_codes(off + start, off + end)
        if reversed_:
            return _RC_LUT[codes[::-1]].tobytes()
        return _FWD_LUT[codes].tobytes()

    def pos_to_contig(self, pos: int) -> int:
        """tid for a forward-strand global position."""
        offs = getattr(self, "_contig_offs", None)
        if offs is None:
            offs = np.array([c.offset for c in self.contigs], dtype=np.int64)
            self._contig_offs = offs
        return int(np.searchsorted(offs, pos, side="right") - 1)

    # ---------------- persistence -------------------------------------------

    def save(self, prefix: str) -> None:
        np.savez_compressed(
            prefix + ".lariat.npz",
            l_pac=self.l_pac, primary=self.primary, L2=self.L2,
            bwt_codes=self.bwt_codes, sa_intv=self.sa_intv,
            sa_samples=self.sa_samples, pac=self.pac,
            occ_ckpt=self.occ_ckpt,
            contig_names=np.array([c.name for c in self.contigs]),
            contig_offsets=np.array([c.offset for c in self.contigs]),
            contig_lengths=np.array([c.length for c in self.contigs]),
            amb_offsets=np.array([a.offset for a in self.ambs], dtype=np.int64),
            amb_lengths=np.array([a.length for a in self.ambs], dtype=np.int64),
            amb_bases=np.array([a.base for a in self.ambs]))

    # Large arrays stored as individual .npy files so they can be mmapped:
    # loading an hg38-scale index is then ~instant (pages fault in on
    # demand and are shared across forked workers via the page cache),
    # vs minutes to stream-read an 8.5 GB npz into anonymous memory.
    _DIR_BIG = ("bwt_codes", "sa_samples", "pac", "occ_ckpt")

    def save_dir(self, prefix: str) -> None:
        """Persist as a ``<prefix>.lariat.d/`` directory (mmap-on-load)."""
        d = prefix + ".lariat.d"
        os.makedirs(d, exist_ok=True)
        for name in self._DIR_BIG:
            np.save(os.path.join(d, name + ".npy"), getattr(self, name))
        # derived but expensive at scale; the native seeding path needs it
        np.save(os.path.join(d, "packed_words.npy"), self.packed_words)
        np.savez(
            os.path.join(d, "meta.npz"),
            l_pac=self.l_pac, primary=self.primary, L2=self.L2,
            sa_intv=self.sa_intv,
            contig_names=np.array([c.name for c in self.contigs]),
            contig_offsets=np.array([c.offset for c in self.contigs]),
            contig_lengths=np.array([c.length for c in self.contigs]),
            amb_offsets=np.array([a.offset for a in self.ambs], dtype=np.int64),
            amb_lengths=np.array([a.length for a in self.ambs], dtype=np.int64),
            amb_bases=np.array([a.base for a in self.ambs]))

    @classmethod
    def load_dir(cls, prefix: str) -> "FMIndex":
        d = prefix + ".lariat.d"
        z = np.load(os.path.join(d, "meta.npz"), allow_pickle=False)
        big = {name: np.load(os.path.join(d, name + ".npy"), mmap_mode="r")
               for name in cls._DIR_BIG}
        contigs = [Contig(str(n), int(o), int(L)) for n, o, L in zip(
            z["contig_names"], z["contig_offsets"], z["contig_lengths"])]
        ambs = [AmbRegion(int(o), int(L), str(b)) for o, L, b in zip(
            z["amb_offsets"], z["amb_lengths"], z["amb_bases"])]
        fm = cls(l_pac=int(z["l_pac"]), primary=int(z["primary"]),
                 L2=z["L2"], sa_intv=int(z["sa_intv"]), contigs=contigs,
                 ambs=ambs, **big)
        pw = os.path.join(d, "packed_words.npy")
        if os.path.exists(pw):
            fm._packed_words = np.load(pw, mmap_mode="r")
        fm._dir = d   # derived device tables (fused/pac_words) cache here
        return fm

    @classmethod
    def load(cls, prefix: str) -> "FMIndex":
        if os.path.isdir(prefix + ".lariat.d"):
            return cls.load_dir(prefix)
        z = np.load(prefix + ".lariat.npz", allow_pickle=False)
        contigs = [Contig(str(n), int(o), int(L)) for n, o, L in zip(
            z["contig_names"], z["contig_offsets"], z["contig_lengths"])]
        ambs = [AmbRegion(int(o), int(L), str(b)) for o, L, b in zip(
            z["amb_offsets"], z["amb_lengths"], z["amb_bases"])]
        return cls(l_pac=int(z["l_pac"]), primary=int(z["primary"]),
                   L2=z["L2"], bwt_codes=z["bwt_codes"],
                   sa_intv=int(z["sa_intv"]), sa_samples=z["sa_samples"],
                   pac=z["pac"], contigs=contigs, ambs=ambs,
                   occ_ckpt=(z["occ_ckpt"] if "occ_ckpt" in z.files
                             else None))


def _blocked_counts(codes: np.ndarray, interval: int) -> np.ndarray:
    """Per-code counts before each interval block (plus final total row).

    Counted ``_BUILD_CHUNK`` codes (rounded to whole blocks) at a time, so
    the temporaries stay a chunk long at hg38 scale."""
    n = len(codes)
    nblocks = (n + interval - 1) // interval
    out = np.zeros((nblocks + 1, 4), dtype=np.int64)
    step = max(1, _BUILD_CHUNK // interval) * interval
    for i in range(0, n, step):
        part = codes[i:i + step]
        nb = (len(part) + interval - 1) // interval
        pad = np.full(nb * interval, 255, dtype=np.uint8)
        pad[:len(part)] = part
        b0 = 1 + i // interval
        for c in range(4):
            out[b0:b0 + nb, c] = (pad == c).reshape(nb, interval).sum(
                axis=1, dtype=np.int64)
    np.cumsum(out, axis=0, out=out)
    return out


# ---------------------------- FASTA parsing ---------------------------------

def parse_fasta(path: str):
    """Yield (name, sequence_bytes) per contig; name = first header word."""
    name = None
    chunks: List[bytes] = []
    with open(path, "rb") as f:
        for line in f:
            line = line.strip()
            if line.startswith(b">"):
                if name is not None:
                    yield name, b"".join(chunks)
                name = line[1:].split()[0].decode()
                chunks = []
            elif line:
                chunks.append(line)
    if name is not None:
        yield name, b"".join(chunks)


def encode_genome(path: str):
    """FASTA -> (codes uint8, contigs, ambs) with bwa amb randomization."""
    rng = Drand48(11)
    contigs: List[Contig] = []
    ambs: List[AmbRegion] = []
    parts: List[np.ndarray] = []
    offset = 0
    for name, seq in parse_fasta(path):
        raw = NT4_TABLE[np.frombuffer(seq, dtype=np.uint8)]
        codes = raw.copy()
        amb_mask = raw >= 4
        if amb_mask.any():
            idxs = np.nonzero(amb_mask)[0]
            # record amb runs of the same source character, bwa-style
            chars = np.frombuffer(seq, dtype=np.uint8)[idxs]
            run_start = 0
            for j in range(1, len(idxs) + 1):
                if (j == len(idxs) or idxs[j] != idxs[j - 1] + 1
                        or chars[j] != chars[j - 1]):
                    ambs.append(AmbRegion(offset + int(idxs[run_start]),
                                          int(j - run_start),
                                          chr(chars[run_start])))
                    run_start = j
            for i in idxs:
                codes[i] = rng.lrand48() & 3
        parts.append(codes)
        contigs.append(Contig(name, offset, len(codes)))
        offset += len(codes)
    return (np.concatenate(parts) if parts else
            np.zeros(0, dtype=np.uint8)), contigs, ambs


def _text_with_sentinel(fwd: np.ndarray) -> np.ndarray:
    """T$ with codes shifted by one: ``fwd + 1``, then the reverse
    complement ``(3 - fwd)[::-1] + 1``, then the sentinel 0, written
    straight into one array (no whole-length temporary)."""
    l_pac = len(fwd)
    with_sent = np.empty(2 * l_pac + 1, dtype=np.uint8)
    np.add(fwd, 1, out=with_sent[:l_pac])
    np.subtract(4, fwd[::-1], out=with_sent[l_pac:2 * l_pac])
    with_sent[2 * l_pac] = 0
    return with_sent


def _bwt_from_sa(with_sent: np.ndarray, sa: np.ndarray):
    """(``primary``, the physical BWT) from the SA over T$, a chunk of SA
    rows at a time: row r's code is ``text[sa[r] - 1]``, the sentinel row
    (``sa == 0``) is ``primary`` and is left out, so the rows after it are
    written one slot lower."""
    n = len(sa)
    bwt = np.empty(n - 1, dtype=np.uint8)
    primary, shift = -1, 0
    for i in range(0, n, _BUILD_CHUNK):
        part = sa[i:i + _BUILD_CHUNK]
        rows = with_sent[part - 1]
        rows -= 1
        hit = np.flatnonzero(part == 0)
        if len(hit):
            k = int(hit[0])
            primary, shift = i + k, 1
            bwt[i:i + k] = rows[:k]
            bwt[i + k:i + len(part) - 1] = rows[k + 1:]
        else:
            bwt[i - shift:i + len(part) - shift] = rows
    return primary, bwt


def _text_counts(fwd: np.ndarray) -> np.ndarray:
    """Counts of each code in the text (forward and reverse complement):
    code c of the complement is 3 - c of ``fwd``."""
    counts = np.zeros(4, dtype=np.int64)
    for i in range(0, len(fwd), _BUILD_CHUNK):
        counts += np.bincount(fwd[i:i + _BUILD_CHUNK], minlength=4)[:4]
    return counts + counts[::-1]


def build_index(fasta_path: str, sa_intv: int = SA_INTERVAL) -> FMIndex:
    """Build the FMD index from a FASTA (offline tool path).

    Only the SA-IS call holds the whole-length arrays at once (``fwd``,
    T$ and the SA); the BWT, ``primary`` and the counts are taken a
    chunk at a time, and T$ and the SA are freed before the object counts
    its occ checkpoints. At hg38 scale the build peaks near 70 GiB of
    RSS."""
    fwd, contigs, ambs = encode_genome(fasta_path)
    l_pac = len(fwd)
    # SA over T$ with sentinel: shift codes +1, sentinel 0
    with_sent = _text_with_sentinel(fwd)
    sa = suffix.suffix_array(with_sent, 5)  # length seq_len+1; sa[0]=seq_len
    # BWT of rows: char before suffix start; the sentinel row is primary
    primary, bwt_codes = _bwt_from_sa(with_sent, sa)
    del with_sent
    # sampled SA every sa_intv rows (row indexing includes sentinel row 0);
    # sample[0] = -1 so sentinel-wrapping sa_lookup walks come out right
    sa_samples = sa[::sa_intv].astype(np.int64)
    sa_samples[0] = -1
    del sa
    L2 = np.zeros(5, dtype=np.int64)
    L2[1:] = np.cumsum(_text_counts(fwd))
    pac = pack_2bit(fwd)
    del fwd
    return FMIndex(l_pac=l_pac, primary=primary, L2=L2, bwt_codes=bwt_codes,
                   sa_intv=sa_intv, sa_samples=sa_samples,
                   pac=pac, contigs=contigs, ambs=ambs)


# ---------------------------- BWA index compatibility ------------------------

def load_bwa_index(prefix: str) -> FMIndex:
    """Load a prebuilt BWA-format index (.pac/.ann/.amb/.bwt/.sa).

    Format equivalent to what bwa_idx_load consumes (gobwa.go:128-147):
    .bwt = primary(u64) L2[1..4](u64) then interleaved (4xu64 occ checkpoint
    per 128 bases + 2-bit codes packed 16/u32); .sa = primary, L2[1..4],
    sa_intv, seq_len, then samples for rows sa_intv, 2*sa_intv, ...
    """
    contigs: List[Contig] = []
    with open(prefix + ".ann") as f:
        header = f.readline().split()
        l_pac, n_seqs = int(header[0]), int(header[1])
        for _ in range(n_seqs):
            meta = f.readline().split()
            name = meta[1]
            nums = f.readline().split()
            contigs.append(Contig(name, int(nums[0]), int(nums[1])))
    ambs: List[AmbRegion] = []
    with open(prefix + ".amb") as f:
        hdr = f.readline().split()
        n_holes = int(hdr[2])
        for _ in range(n_holes):
            o, ln, ch = f.readline().split()
            ambs.append(AmbRegion(int(o), int(ln), ch))
    pac = np.fromfile(prefix + ".pac", dtype=np.uint8)
    # validate l_pac against pac file encoding (trailing length byte)
    tail = int(pac[-1])
    pac_codes = pac[:-1] if tail != 0 else pac[:-2]
    expect_bytes = (l_pac + 3) // 4
    pac_codes = pac_codes[:expect_bytes]

    with open(prefix + ".bwt", "rb") as f:
        raw = f.read()
    primary = struct.unpack("<Q", raw[:8])[0]
    L2 = np.zeros(5, dtype=np.int64)
    L2[1:] = struct.unpack("<4Q", raw[8:40])
    payload = np.frombuffer(raw[40:], dtype=np.uint32)
    seq_len = 2 * l_pac
    bwt_codes = _deinterleave_bwa_bwt(payload, seq_len)

    with open(prefix + ".sa", "rb") as f:
        sraw = f.read()
    sa_primary = struct.unpack("<Q", sraw[:8])[0]
    assert sa_primary == primary
    sa_intv, sa_seq_len = struct.unpack("<QQ", sraw[40:56])
    assert sa_seq_len == seq_len
    n_sa = (seq_len + sa_intv) // sa_intv
    body = np.frombuffer(sraw[56:], dtype=np.uint64)[:n_sa - 1]
    sa_samples = np.empty(n_sa, dtype=np.int64)
    sa_samples[0] = -1  # row 0 = sentinel; never dereferenced
    sa_samples[1:] = body.astype(np.int64)
    return FMIndex(l_pac=l_pac, primary=int(primary), L2=L2,
                   bwt_codes=bwt_codes, sa_intv=int(sa_intv),
                   sa_samples=sa_samples, pac=pac_codes, contigs=contigs,
                   ambs=ambs)


def _deinterleave_bwa_bwt(payload: np.ndarray, seq_len: int) -> np.ndarray:
    """Strip the interleaved occ checkpoints, return per-base codes."""
    n_data_words = (seq_len + 15) // 16
    n_ckpt = seq_len // OCC_INTERVAL + 1
    words_per_block = OCC_INTERVAL // 16  # 8 data words per 128 bases
    ckpt_words = 8  # 4 x u64 = 8 x u32
    data = np.empty(n_data_words, dtype=np.uint32)
    src = 0
    dst = 0
    remaining = n_data_words
    for _ in range(n_ckpt):
        src += ckpt_words
        take = min(words_per_block, remaining)
        if take <= 0:
            break
        data[dst:dst + take] = payload[src:src + take]
        src += take
        dst += take
        remaining -= take
    # unpack 16 bases per u32, first base in the high bits
    shifts = np.arange(15, -1, -1, dtype=np.uint32) * 2
    codes = ((data[:, None] >> shifts[None, :]) & 3).astype(np.uint8).reshape(-1)
    return codes[:seq_len]
