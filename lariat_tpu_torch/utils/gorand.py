"""Deterministic per-read tie-break PRNG (Go math/rand-style ALFG).

The reference breaks score ties with ``rand.New(rand.NewSource(seed))`` where
seed comes from the md5 of the read name (``inference/lariat.go:1481-1486``).
We reproduce the same *structure*: md5-seeded, additive lagged Fibonacci
generator (len 607, tap 273) with Go's seeding recipe, Float64 in [0,1).

NOT bit-exact with Go's value stream: Go's seeding XORs a 607-entry constant
table (``rngCooked``) that is baked into its source and not reproducible here
(we generate our own equivalent table with the documented procedure). The
tie-break noise is < 0.5 and only decides between *exactly tied* candidate
pairs, where the reference's choice is itself arbitrary; the RFA optimizer
and MAPQ model downstream are unaffected. The stream is stable across runs
and platforms, which is what barcode-level determinism requires.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


RNG_LEN = 607
RNG_TAP = 273
INT32_MAX = (1 << 31) - 1
MASK64 = (1 << 64) - 1
_A, _Q, _R = 48271, 44488, 3399

_COOKED_CACHE = os.path.join(os.path.dirname(__file__), "_gorand_cooked.npy")
_cooked: Optional[np.ndarray] = None


def _seedrand(x: int) -> int:
    hi, lo = divmod(x, _Q)
    x = _A * lo - _R * hi
    if x < 0:
        x += INT32_MAX
    return x


def _gen_cooked() -> np.ndarray:
    """Recompute rngCooked per gen_cooked.go."""
    vec = [0] * RNG_LEN
    x = 1
    for i in range(-20, RNG_LEN):
        x = _seedrand(x)
        if i >= 0:
            u = (x << 20) & MASK64
            x = _seedrand(x)
            u ^= (x << 10) & MASK64
            x = _seedrand(x)
            u ^= x
            vec[i] = u
    # run the ALFG 780,000 steps
    tap, feed = 0, RNG_LEN - RNG_TAP
    v = np.array(vec, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for _ in range(780000):
            tap -= 1
            if tap < 0:
                tap += RNG_LEN
            feed -= 1
            if feed < 0:
                feed += RNG_LEN
            v[feed] = v[feed] + v[tap]
    return v


def _get_cooked() -> np.ndarray:
    global _cooked
    if _cooked is not None:
        return _cooked
    if os.path.exists(_COOKED_CACHE):
        _cooked = np.load(_COOKED_CACHE)
        return _cooked
    _cooked = _gen_cooked()
    try:
        np.save(_COOKED_CACHE, _cooked)
    except OSError:
        pass
    return _cooked


# Powers of the Park-Miller multiplier for vectorized seeding: the seedrand
# chain is x_n = x_0 * A^n mod M, so the whole 1881-step init chain is one
# elementwise modmul against precomputed powers.
_N_CHAIN = 22 + 3 * RNG_LEN
_A_POWERS: Optional[np.ndarray] = None


def _get_powers() -> np.ndarray:
    global _A_POWERS
    if _A_POWERS is None:
        p = np.empty(_N_CHAIN, dtype=np.uint64)
        v = 1
        for i in range(_N_CHAIN):
            p[i] = v
            v = (v * _A) % INT32_MAX
        _A_POWERS = p
    return _A_POWERS


def _chain_matrix(s: np.ndarray, su: np.ndarray) -> np.ndarray:
    """(n, N_CHAIN) seeding chains; C++ helper when built (the constant
    modulus 2^31-1 strength-reduces, unlike numpy's uint64 %)."""
    try:
        from ..index.suffix import _load_native
        lib = _load_native()
    except Exception:
        lib = None
    p = _get_powers()
    if lib is not None and hasattr(lib, "gorand_chain_batch"):
        import ctypes
        out = np.empty((len(s), _N_CHAIN), dtype=np.uint64)
        lib.gorand_chain_batch(
            ctypes.c_void_p(s.ctypes.data), ctypes.c_int64(len(s)),
            ctypes.c_void_p(p.ctypes.data), ctypes.c_int64(_N_CHAIN),
            ctypes.c_void_p(out.ctypes.data))
        return out
    return (su[:, None] * p[None, :]) % np.uint64(INT32_MAX)


class GoRand:
    """rand.New(rand.NewSource(seed)) value stream."""

    @classmethod
    def batch_first_floats(cls, seeds, k: int = 16) -> np.ndarray:
        """(n, k) array of each seed's first k Float64 draws, vectorized.

        Bit-identical to ``GoRand(seed).float64()`` streams: the ALFG has no
        read-after-write collisions in its first 273 steps (draw i reads
        vec[333-i] and vec[606-i] of the INITIAL state and only writes
        vec[333-i], which is re-read no sooner than draw i+273), so for
        k <= 273 each output is a plain elementwise sum over 2k initial
        slots — 6k chain columns instead of the full 1821-column state.
        Consumers drawing few values per read (tagBestAlignments draws
        ~n_aln*n_mate) skip ~100x of the per-read setup. Rows where a draw
        rounds to 1.0 (Go retries; p ~ 2^-53 per draw) fall back to the
        sequential generator.
        """
        if k > 273:
            raise ValueError("fast path only valid for k <= 273")
        cooked = _get_cooked()
        p = _get_powers()
        n = len(seeds)
        s = np.fromiter((int(x) % INT32_MAX for x in seeds), np.int64, n)
        s[s == 0] = 89482311
        su = s.astype(np.uint64)
        i = np.arange(k)
        slots = np.concatenate([333 - i, 606 - i])            # (2k,)
        M = np.uint64(INT32_MAX)
        a = (su[:, None] * p[21 + 3 * slots][None, :]) % M
        b = (su[:, None] * p[22 + 3 * slots][None, :]) % M
        c = (su[:, None] * p[23 + 3 * slots][None, :]) % M
        vec = (((a << np.uint64(40)) ^ (b << np.uint64(20)) ^ c)
               ^ cooked[slots][None, :])
        x = vec[:, :k] + vec[:, k:]                # uint64 add wraps mod 2^64
        f = ((x & np.uint64((1 << 63) - 1)).astype(np.float64)
             / float(1 << 63))
        bad = f >= 1.0
        if bad.any():
            for r in np.nonzero(bad.any(axis=1))[0]:
                g = cls(int(seeds[r]))
                f[r] = [g.float64() for _ in range(k)]
        return f

    @classmethod
    def batch(cls, seeds) -> list:
        """Vectorized construction of many generators (one chain matmul)."""
        cooked = _get_cooked()
        s = np.fromiter((int(x) % INT32_MAX for x in seeds), np.int64,
                        len(seeds))
        s[s == 0] = 89482311
        su = s.astype(np.uint64)
        chain = _chain_matrix(s, su)
        a = chain[:, 21:21 + 3 * RNG_LEN:3]
        b = chain[:, 22:22 + 3 * RNG_LEN:3]
        c = chain[:, 23:23 + 3 * RNG_LEN:3]
        u = (a << np.uint64(40)) ^ (b << np.uint64(20)) ^ c ^ cooked[None, :]
        out = []
        for row in u:
            obj = cls.__new__(cls)
            obj.tap = 0
            obj.feed = RNG_LEN - RNG_TAP
            obj.vec = row.tolist()
            out.append(obj)
        return out

    def __init__(self, seed: int):
        cooked = _get_cooked()
        self.tap = 0
        self.feed = RNG_LEN - RNG_TAP
        seed = seed % INT32_MAX
        if seed < 0:
            seed += INT32_MAX
        if seed == 0:
            seed = 89482311
        # chain[k] = seedrand^k(seed); slot i consumes chain[21+3i .. 23+3i]
        chain = (np.uint64(seed) * _get_powers()) % np.uint64(INT32_MAX)
        a = chain[21:21 + 3 * RNG_LEN:3]
        b = chain[22:22 + 3 * RNG_LEN:3]
        c = chain[23:23 + 3 * RNG_LEN:3]
        u = (a << np.uint64(40)) ^ (b << np.uint64(20)) ^ c ^ cooked
        self.vec = u.tolist()

    def uint64(self) -> int:
        self.tap -= 1
        if self.tap < 0:
            self.tap += RNG_LEN
        self.feed -= 1
        if self.feed < 0:
            self.feed += RNG_LEN
        x = (self.vec[self.feed] + self.vec[self.tap]) & MASK64
        self.vec[self.feed] = x
        return x

    def uint64_n(self, k: int) -> np.ndarray:
        """Next ``k`` raw draws as uint64 array — bit-exact with ``k``
        successive ``uint64()`` calls.

        Chunks cap at RNG_TAP draws and at the tap/feed wrap boundaries:
        within such a chunk, draw j writes vec[feed-j] which no later
        in-chunk draw reads (a collision needs j'-j = RNG_TAP), so each
        chunk is one elementwise wrap-around add over pre-chunk state.
        """
        out = np.empty(k, np.uint64)
        vec = np.asarray(self.vec, dtype=np.uint64)
        tap, feed = self.tap, self.feed
        done = 0
        while done < k:
            ts = tap - 1 if tap > 0 else RNG_LEN - 1   # pre-decremented
            fs = feed - 1 if feed > 0 else RNG_LEN - 1
            b = min(RNG_TAP, ts + 1, fs + 1, k - done)
            f_sl = vec[fs - b + 1: fs + 1][::-1]
            t_sl = vec[ts - b + 1: ts + 1][::-1]
            x = f_sl + t_sl                      # uint64 add wraps mod 2^64
            vec[fs - b + 1: fs + 1] = x[::-1]
            out[done:done + b] = x
            done += b
            tap = ts - b + 1
            feed = fs - b + 1
        self.tap, self.feed = tap, feed
        self.vec = vec.tolist()
        return out

    def int63(self) -> int:
        return self.uint64() & ((1 << 63) - 1)

    def float64(self) -> float:
        while True:
            f = self.int63() / (1 << 63)
            if f != 1.0:
                return f


class FastF64:
    """Sequential Float64 cursor over a precomputed batch_first_floats row;
    transparently falls back to the full generator past the prefix.

    The fallback serves from vectorized blocks: Go's Float64 stream is
    exactly the uint64 stream filtered of values whose top 63 bits round to
    1.0 (the retry loop re-draws), so ``uint64_n`` + a mask replay it
    bit-exactly — including the discard of the prefix already served from
    ``row``, whose overshoot becomes the first buffered block.
    """

    __slots__ = ("seed", "row", "i", "_g", "_buf", "_bi")

    _M63 = np.uint64((1 << 63) - 1)
    _SCALE = float(1 << 63)

    def __init__(self, seed: int, row: np.ndarray):
        self.seed = seed
        self.row = row
        self.i = 0
        self._g = None
        self._buf = None
        self._bi = 0

    def _draw_floats(self, k: int) -> np.ndarray:
        u = self._g.uint64_n(k)
        f = (u & self._M63).astype(np.float64) / self._SCALE
        return f[f != 1.0]

    def _refill(self) -> None:
        if self._g is None:
            self._g = GoRand(self.seed)
            disc = len(self.row)       # draws already served from the row
            while disc > 0:
                f = self._draw_floats(disc + 32)
                if len(f) >= disc:
                    self._buf = f[disc:]
                    self._bi = 0
                    disc = 0
                else:
                    disc -= len(f)
            if self._buf is not None and self._bi < len(self._buf):
                return
        while True:
            f = self._draw_floats(512)
            if len(f):
                self._buf = f
                self._bi = 0
                return

    def float64(self) -> float:
        i = self.i
        self.i = i + 1
        if i < len(self.row):
            return float(self.row[i])
        if self._buf is None or self._bi >= len(self._buf):
            self._refill()
        v = float(self._buf[self._bi])
        self._bi += 1
        return v

    def float64_n(self, k: int) -> np.ndarray:
        """Next ``k`` draws as a float64 array — the stream is identical to
        ``k`` successive ``float64()`` calls (vectorized consumers)."""
        i = self.i
        m = min(max(len(self.row) - i, 0), k)
        out = np.empty(k, np.float64)
        if m:
            out[:m] = self.row[i:i + m]
            self.i = i + m
        j = m
        while j < k:
            if self._buf is None or self._bi >= len(self._buf):
                self._refill()
            take = min(k - j, len(self._buf) - self._bi)
            out[j:j + take] = self._buf[self._bi:self._bi + take]
            self._bi += take
            self.i += take
            j += take
        return out
