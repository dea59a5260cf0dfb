"""The device align step -- the port of lariat_tpu/parallel/align_step.py.

``DeviceGenome`` holds the device FM index, the 2-bit pac and the sampled
suffix array. Two callers use it:

- device seeding (``collect_seeds_rbegs_device``) runs K5
  ``sa_walk_chunk`` (``csrc/sa_walk.cu``) through ``sa_lookup_batch_host``,
  which walks a lookup's rows in one launch and adds the samples on the
  host;
- the one-call align steps ``align_step`` (exact suffix seed, K7, which
  applies the seed mask where it reads a base) and ``align_step_smem``
  (round-1 SMEMs, K4b) map each read to one position: the SA lookup with
  the samples added on the card (``sa_lookup_batch``, K5's lookup entry),
  then a banded extension of the whole read, oriented to its hit's strand,
  against the implied window of the forward strand (K1's step entry,
  ``sw_extend.extend_step``, which stages the window itself: K8's
  ``fetch_window_batch`` stays the port of the reference's function, off
  the steps' path).

On a CUDA tensor every step launches its kernel; on a CPU tensor it runs
its plain twin. ``plain=True`` runs the twins on any device (the kernels'
yardstick on the card, as the reference's ``use_pallas=False``). The glue
between the kernels (the anchor pick, the hit's strand and forward start)
is torch ops, as it is XLA ops in the reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..align.ksw import _mat_params
from ..ops import _build, resident, smem_device, sw_extend
from ..ops.fm_batch import (DeviceFMIndex, backward_search,
                            backward_search_plain, lf_batch, lf_row)


# LF steps a lookup allows a walk (the reference's 64 + 448); a walk of
# sa_intv 32 outlives it with odds (31/32)**512, about 1e-7
LOOKUP_STEPS = 512
# lookups a DeviceGenome logs; later ones go unlogged
WALK_LOG_CAP = 1024
# the align steps' extension: the seed's score, and the reference
# extend_batch's defaults
STEP_H0 = 19
STEP_SCORING = dict(o_del=6, e_del=1, o_ins=6, e_ins=1, end_bonus=5,
                    zdrop=100)


@dataclasses.dataclass
class DeviceGenome:
    """The device FM index (shared with the engine's seeding, not a second
    upload), the forward pac and the SA sampling. ``pac_words`` is the
    engine's tensor when the caller has one, else uploaded at the first
    window fetch; the samples (int64, about 1.55 GB at hg38) are uploaded
    at the first ``sa_lookup_batch``, never by ``sa_lookup_batch_host``,
    which adds them on the host. ``walks`` logs the first ``WALK_LOG_CAP``
    host lookups' K5 launches on the card: rows (padded), max_steps, the
    longest walk's steps and the walks longer than 64 steps."""
    fmd: DeviceFMIndex
    sa_intv: int
    l_pac: int
    pac_words: Optional[torch.Tensor] = None
    walks: List[dict] = dataclasses.field(default_factory=list)
    host: object = dataclasses.field(default=None, repr=False)
    sa_samples: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                           repr=False)
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock,
                                              repr=False)

    @classmethod
    def from_host(cls, fm, fmd: DeviceFMIndex,
                  pac_words: Optional[torch.Tensor] = None
                  ) -> "DeviceGenome":
        return cls(fmd=fmd, sa_intv=int(fm.sa_intv), l_pac=int(fm.l_pac),
                   pac_words=pac_words, host=fm)

    def pac(self) -> torch.Tensor:
        """The 2-bit forward pac on the index's device (int32 words)."""
        with self._lock:
            if self.pac_words is None:
                self.pac_words = resident.pac_words_from_fm(self.host,
                                                            self.fmd.device)
            return self.pac_words

    def samples(self) -> torch.Tensor:
        """The SA samples as int64 on the index's device."""
        with self._lock:
            if self.sa_samples is None:
                self.sa_samples = torch.from_numpy(np.ascontiguousarray(
                    self.host.sa_samples, dtype=np.int64)).to(
                        self.fmd.device)
            return self.sa_samples


def sa_walk_chunk_plain(g: DeviceGenome, k: torch.Tensor,
                        steps: torch.Tensor, done: torch.Tensor,
                        max_steps: int,
                        touched: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain twin of K5 (every lane in lock step); ``touched`` (a bool per
    fused row) gets the rows its LF steps read set."""
    fmd = g.fmd
    dt = k.dtype
    k, steps = k.long(), steps.long()
    done = done | (k % g.sa_intv == 0)
    for _ in range(max_steps):
        if bool(done.all()):
            break
        lf = torch.where(k == fmd.primary, 0, lf_batch(fmd, k).long())
        if touched is not None:
            touched[lf_row(fmd, k[~done & (k != fmd.primary)])] = True
        k = torch.where(done, k, lf)
        steps = torch.where(done, steps, steps + 1)
        done = done | (k % g.sa_intv == 0)
    return torch.stack([k, steps, done.long()]).to(dt)


def sa_walk_chunk(g: DeviceGenome, k: torch.Tensor, steps: torch.Tensor,
                  done: torch.Tensor, max_steps: int) -> torch.Tensor:
    """K5: one bounded, resumable stretch of the LF walk. Each lane not
    done steps k -> LF(k) (row primary -> 0), counting steps, until k is a
    sampled row (k % sa_intv == 0) or ``max_steps`` steps ran. k, steps
    (n,) in the index dtype, done (n,) bool -> (3, n) [k, steps, done] in
    k's dtype."""
    dev = k.device
    if not _build.on_cuda(k):
        return sa_walk_chunk_plain(g, k, steps, done, max_steps)
    n = int(k.shape[0])
    dt = g.fmd.idx_dtype
    _build.check("k", k, dev, (n,), (dt,))
    _build.check("steps", steps, dev, (n,), (dt,))
    _build.check("done", done, dev, (n,), (torch.bool,))
    out = torch.empty((3, n), dtype=dt, device=dev)
    fmd = g.fmd
    _build.launch("sa_walk", k, steps, done, fmd.fused, fmd.L2, fmd.primary,
                  fmd.seq_len, g.sa_intv, int(dt == torch.int64), n,
                  max_steps, out, size=n)
    return out


def sa_lookup_batch_plain(g: DeviceGenome, k: torch.Tensor,
                          max_steps: int = LOOKUP_STEPS,
                          touched: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Plain twin of K5's lookup entry: the walk from 0 steps, then the
    sample add, the sample index clamped as the reference's gather clamps
    it."""
    z = torch.zeros_like(k)
    kk, steps = sa_walk_chunk_plain(g, k, z, z.bool(), max_steps,
                                    touched)[:2].long()
    samples = g.samples()
    si = torch.clamp(kk // g.sa_intv, 0, samples.shape[0] - 1)
    return samples[si] + steps


def sa_lookup_batch(g: DeviceGenome, k: torch.Tensor,
                    max_steps: int = LOOKUP_STEPS) -> torch.Tensor:
    """SA positions (int64) of BWT rows k >= 0 (n,) in the index dtype: K5's
    lookup entry walks each row to a sampled one (up to ``max_steps`` LF
    steps) and adds its sample on the card."""
    if not _build.on_cuda(k):
        return sa_lookup_batch_plain(g, k, max_steps)
    dev, n, dt = k.device, int(k.shape[0]), g.fmd.idx_dtype
    _build.check("k", k, dev, (n,), (dt,))
    samples = g.samples()
    out = torch.empty(n, dtype=torch.int64, device=dev)
    fmd = g.fmd
    _build.launch("sa_walk", k, fmd.fused, fmd.L2, fmd.primary, fmd.seq_len,
                  g.sa_intv, int(dt == torch.int64), samples,
                  samples.shape[0], n, max_steps, out, size=n,
                  entry="lariat_sa_lookup")
    return out


def sa_lookup_batch_host(g: DeviceGenome, fm,
                         rows: np.ndarray) -> np.ndarray:
    """SA positions of BWT rows: one K5 launch walks every row up to
    ``LOOKUP_STEPS`` LF steps (each thread leaves when its row is sampled),
    one download brings (k, steps) back, and the sample add happens on the
    host. The reference's two phases (64 steps for all, then the unfinished
    rows for the rest of 512) give the same positions."""
    n = len(rows)
    if n == 0:
        return np.zeros(0, np.int64)
    dev = g.fmd.device
    dt = np.int32 if g.fmd.idx_dtype == torch.int32 else np.int64
    npad = 128
    while npad < n:
        npad <<= 1
    karr = np.zeros(npad, dt)
    karr[:n] = rows
    kd = torch.from_numpy(karr).to(dev)
    walk = (kd, torch.zeros_like(kd),
            torch.zeros(npad, dtype=torch.bool, device=dev))
    k, steps = sa_walk_chunk(g, *walk, LOOKUP_STEPS)[:2].cpu().numpy()
    if dev.type == "cuda" and len(g.walks) < WALK_LOG_CAP:
        g.walks.append({"rows": npad, "max_steps": LOOKUP_STEPS,
                        "longest": int(steps.max()),
                        "past_64": int((steps > 64).sum())})
    sa = np.asarray(fm.sa_samples)
    return (sa[(k[:n] // fm.sa_intv).astype(np.int64)]
            + steps[:n].astype(np.int64))


def fetch_window_batch_plain(g: DeviceGenome, start: torch.Tensor,
                             length: int) -> torch.Tensor:
    """Plain twin of K8."""
    return resident.fetch_forward_batch(g.pac(), g.l_pac, start, length)


def fetch_window_batch(g: DeviceGenome, start: torch.Tensor,
                       length: int) -> torch.Tensor:
    """K8: (B, length) int32 forward-strand codes at start[b] + p, 4
    outside [0, l_pac); start (B,) may be negative."""
    if not _build.on_cuda(start):
        return fetch_window_batch_plain(g, start, length)
    dev, B = start.device, int(start.shape[0])
    pac = g.pac()
    _build.check("pac_words", pac, dev, tuple(pac.shape))
    if pac.dim() != 1 or g.l_pac > 16 * pac.shape[0]:
        raise ValueError(f"pac_words: {tuple(pac.shape)} words cannot hold "
                         f"l_pac {g.l_pac}")
    start = start.to(torch.int64).contiguous()
    _build.check("start", start, dev, (B,), (torch.int64,))
    out = torch.empty((B, length), dtype=torch.int32, device=dev)
    _build.launch("fetch_window", start, pac, g.l_pac, B, length, out,
                  size=B)
    return out


def exact_match_batch_suffix(fmd: DeviceFMIndex, reads: torch.Tensor,
                             start: torch.Tensor, lens: torch.Tensor,
                             max_iters: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7 over reads[start:lens) per item, an N skipped (the reference's
    rule here; ``fm_batch.exact_match_batch`` empties on N instead)."""
    return backward_search(fmd, reads, lens, start, max_iters, skip_n=True)


class AlignStepResult(NamedTuple):
    pos: torch.Tensor       # (B,) forward-strand hit position (or -1)
    is_rev: torch.Tensor    # (B,) hit on the reverse strand
    n_hits: torch.Tensor    # (B,) occurrence count of the anchor seed
    score: torch.Tensor     # (B,) extension score at the hit
    mapped: torch.Tensor    # (B,) bool


class StepClock:
    """Time of each named part of an align step: CUDA events around it on
    the card, the host clock on the CPU. ``ms()`` synchronises and sums
    the parts by name."""

    def __init__(self, device: torch.device):
        self.device = device
        self.marks: List[tuple] = []

    @contextlib.contextmanager
    def part(self, name: str):
        if self.device.type == "cuda":
            # on the step's card's stream, not the current card's
            stream = torch.cuda.current_stream(self.device)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record(stream)
            yield
            b.record(stream)
        else:
            a = time.perf_counter()
            yield
            b = time.perf_counter()
        self.marks.append((name, a, b))

    def ms(self) -> Dict[str, float]:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out: Dict[str, float] = {}
        for name, a, b in self.marks:
            t = (a.elapsed_time(b) if self.device.type == "cuda"
                 else (b - a) * 1e3)
            out[name] = out.get(name, 0.0) + t
        return out


class _NoClock:
    @staticmethod
    def part(name: str):
        return contextlib.nullcontext()


class _Steps(NamedTuple):
    search: Callable
    lookup: Callable
    min_starts: Callable
    fetch_extend: Callable


_KERNEL_STEPS = _Steps(backward_search, sa_lookup_batch,
                       smem_device.min_starts_kernel, sw_extend.extend_step)
_PLAIN_STEPS = _Steps(backward_search_plain, sa_lookup_batch_plain,
                      smem_device.min_starts_kernel_plain,
                      sw_extend.extend_step_plain)


def _scores(mat) -> Tuple[int, int, int]:
    """(match, mismatch, N) of bwa's uniform (5, 5) matrix; raises on any
    other (K1 takes the three scalars)."""
    m = mat.cpu().numpy() if isinstance(mat, torch.Tensor) else mat
    params = _mat_params(np.asarray(m))
    if params is None:
        raise ValueError("the align step needs bwa's uniform score matrix "
                         "(ksw.fill_score_matrix)")
    return params


def forward_start(g: DeviceGenome, pos_fmd: torch.Tensor, qb: torch.Tensor,
                  lens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(is_rev, fwd_start): the strand of a hit at doubled-text position
    ``pos_fmd`` of read offset ``qb``, and the whole read's start projected
    to the forward strand (a reverse hit spans [2 l_pac - dstart - n,
    2 l_pac - dstart), dstart = pos_fmd - qb)."""
    dstart = pos_fmd - qb.long()
    is_rev = pos_fmd >= g.l_pac
    return is_rev, torch.where(is_rev, 2 * g.l_pac - dstart - lens.long(),
                               dstart)


def _map_and_extend(g: DeviceGenome, steps: _Steps, clock, reads, lens, row,
                    qb, mapped, n_hits, window, scores) -> AlignStepResult:
    """The steps after the anchor: the SA lookup of ``row``, the read's
    forward-strand start implied by the anchor's read offset ``qb``, and
    the extension of the whole read, oriented to the forward strand,
    against the window there. Unmapped lanes (row 0) extend too, as in the
    reference. ``reads`` (B, L) uint8."""
    with clock.part("sa_lookup"):
        pos_fmd = steps.lookup(g, row)
    with clock.part("orient"):
        is_rev, fwd_start = forward_start(g, pos_fmd, qb, lens)
    with clock.part("fetch_extend"):
        a, b, n = scores
        score = steps.fetch_extend(reads, lens, fwd_start, is_rev, g.pac(),
                                   g.l_pac, window, h0=STEP_H0, match_sc=a,
                                   mismatch_sc=b, n_sc=n, **STEP_SCORING)[0]
    return AlignStepResult(pos=torch.where(mapped, fwd_start, -1),
                           is_rev=is_rev & mapped, n_hits=n_hits,
                           score=score, mapped=mapped)


def align_step(g: DeviceGenome, reads: torch.Tensor, lens: torch.Tensor,
               mat, seed_len: int = 32, window: int = 32,
               plain: bool = False,
               clock: Optional[StepClock] = None) -> AlignStepResult:
    """One device alignment step: seed by an exact match of the read's last
    ``seed_len`` bases (K7, an N skipped), SA-dereference its first row
    (K5), and extend the whole read against the implied window with band
    ``window`` (K1's step entry).

    reads (B, L) codes 0..4, lens (B,); mat bwa's uniform (5, 5) matrix.
    ``clock`` (a StepClock) gets each part's time."""
    scores = _scores(mat)
    steps = _PLAIN_STEPS if plain else _KERNEL_STEPS
    clock = clock or _NoClock()
    lens = lens.to(reads.device, torch.int32)
    reads8 = reads.to(torch.uint8).contiguous()
    with clock.part("exact_match"):
        start = torch.clamp(lens - seed_len, min=0)
        k, l = steps.search(g.fmd, reads8, lens, start, seed_len, True)
    n_hits = torch.clamp(l - k + 1, min=0)
    mapped = n_hits > 0
    return _map_and_extend(g, steps, clock, reads8, lens,
                           torch.where(mapped, k, 0), start, mapped, n_hits,
                           window, scores)


def align_step_smem(g: DeviceGenome, reads: torch.Tensor, lens: torch.Tensor,
                    mat, window: int = 32, min_seed_len: int = 19,
                    plain: bool = False,
                    clock: Optional[StepClock] = None) -> AlignStepResult:
    """One device alignment step on round-1 SMEMs: K4b's minimal start b(e)
    of every (read, e) lane ([b(e), e) is an SMEM iff b(e + 1) > b(e)),
    the anchor on the longest SMEM of at least ``min_seed_len`` bases (ties:
    fewest occurrences, then the leftmost), then as ``align_step``. An
    unmapped read's n_hits is its lane e = 1's interval size, as in the
    reference."""
    scores = _scores(mat)
    steps = _PLAIN_STEPS if plain else _KERNEL_STEPS
    clock = clock or _NoClock()
    B, L = reads.shape
    dev = reads.device
    dt = g.fmd.idx_dtype
    lens = lens.to(dev, torch.int32)
    reads8 = reads.to(torch.uint8).contiguous()
    with clock.part("lanes"):
        lane = torch.arange(B * L, dtype=torch.int32, device=dev)
        read_idx, e_arr = lane // L, lane % L + 1
        min_intv = torch.ones(B * L, dtype=dt, device=dev)
    with clock.part("min_starts"):
        b, x0, _, s, valid = steps.min_starts(g.fmd, reads8, read_idx, e_arr,
                                              min_intv, L)
    with clock.part("anchor_pick"):
        b, x0, s, valid = (v.reshape(B, L) for v in (b, x0, s, valid))
        e_mat = torch.arange(1, L + 1, dtype=torch.int32, device=dev)[None, :]
        valid = valid & (e_mat <= lens[:, None])
        big = 1 << 30
        bnext = torch.cat([torch.where(valid[:, 1:], b[:, 1:], big),
                           torch.full((B, 1), big, dtype=b.dtype,
                                      device=dev)], dim=1)
        length = e_mat - b
        is_smem = valid & (bnext > b) & (length >= min_seed_len)
        occ_pen = torch.clamp(s.long(), max=1 << 20)
        key = torch.where(is_smem, length.long() * (1 << 24) - occ_pen, -1)
        # the first lane of the largest key (jnp.argmax's tie rule), by
        # construction
        col = torch.arange(L, device=dev)[None, :]
        top = key.max(dim=1, keepdim=True).values
        pick = torch.where(key == top, col, L).min(dim=1).values[:, None]
        mapped = is_smem.gather(1, pick)[:, 0]
        qb = b.gather(1, pick)[:, 0]
        row = torch.where(mapped, x0.gather(1, pick)[:, 0], 0)
        n_hits = s.gather(1, pick)[:, 0]
    return _map_and_extend(g, steps, clock, reads8, lens, row, qb, mapped,
                           n_hits, window, scores)
