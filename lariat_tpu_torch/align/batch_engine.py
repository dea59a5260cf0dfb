"""The batch alignment engine on PyTorch: every DP wave of the priming pass
runs through the port's kernels.

``TorchBatchAlignmentEngine`` is the host control flow of lariat_tpu's
``BatchAlignmentEngine`` (``align_batch``, ``prime_regions``, the reg2aln
session path and the Python replays), copied without its JAX and Pallas
branches. Each call picks its path as the reference does:

  seed extension  the C++ session (native/align1.cpp ``a1s_*``) when
                  ``native_engine.Align1Session.available()``, else
                  ``_align_batch_python``, the Python replay of chain2aln
                  (``_prepare_chains``, ``_ExtBatcher``: four K1 waves
                  through the tile entry, left, its band retry, right, its
                  retry)
  mate rescue     ``local_align_device``, two-pass K3
  reg2aln         the C++ session (``r2s_*``) when
                  ``Reg2AlnSession.available()``, else ``_reg2aln_python``,
                  the w2 band ladder on the host with K2 + K2b waves, and
                  ``_finish_reg2aln``

``LARIAT_NO_NATIVE_ALIGN1=1`` (read once a process by ``native_engine``)
takes the replays. A session's waves are fed from resident data: the
group's reads and the pac on the device, one descriptor matrix a wave
(K1's descriptor entry, ``build_qt`` before K2).

The engine is the reference's drop-in: ``prime_regions(recs)`` without a
score delta returns the pairs' (regs1, regs2) before rescue,
``prime_pairs`` fills ``_pair_cache`` for ``rfa.candidates.get_chains``,
and ``align1`` runs one read through ``align_batch``. Setting
``abort_prime`` makes a priming pass raise ``PrimeAborted`` at its next
wave boundary (the seeding call, each session wave, the rescue wave); its
sessions close without finishing. The Python replays check it only where
the reference's do: at the rescue wave. The CLI's router sets it at the
end of its input, after a grace, and host-routes the batches whose passes
it abandons.

The wave split (the reference's ``mesh`` and ``_shard_wave``): given
``devices``, a list with one entry a shard (the same card may appear more
than once), each wave's rows are dealt round-robin over them, block d
holding the tasks o with o % n == d; every block is dispatched on its own
device before any is downloaded, and the results are put back in task
order. The genome's pac words and a group's reads are replicated, one copy
a distinct device; seeding and ``_ExtBatcher``'s waves stay on
``devices[0]``. With one device (the default) a wave is one block.

The wave trace, read once at import as the reference reads it:
``LARIAT_WAVE_TRACE=1`` prints the reference's ``[wtrace]`` line, in its
format, for each session wave at its four sites (``ext`` a seed-extension
wave, ``loc`` a rescue wave, ``r2a.d`` a reg2aln dispatch, ``r2a.f`` its
download): build, dispatch and download ms and the MB sent each way. A
launch is asynchronous, as a JAX dispatch is, so the download time holds
the kernels' time. ``LARIAT_WAVE_DEBUG=1`` prints the reference's
``[wave]`` line after each seed-extension wave of a session. The Python
replays print neither, as in the reference.

Spans (``utils/spans.py``, recorded with ``LARIAT_SPANS``): a priming pass
is ``prime.regions`` (seeding and extension), ``prime.rescue`` and
``prime.reg2aln``; each seeding call a ``seed.device`` (its ``[seedtrace]``
phases as children) or ``seed.host``; each session wave ``wave.<site>``
with the children ``build``, ``disp`` and ``dl`` and the attributes
``tasks``, ``rows`` (padded), ``up_b`` and ``dn_b``. The ``[wtrace]``
line is printed from these spans.

Seeding follows the reference's policy: ``LARIAT_DEVICE_SEED=1`` runs the
3-round SMEM seeding and its SA walks on the device (``_device_seed``,
kernels K4a-K4c and K5), ``=0`` keeps the host C++ seeder, and unset
(auto) turns device seeding on for a CUDA device at genomes of
``DEVICE_SEED_AUTO_MIN_LPAC`` (1 Gbp) and above. The index uploads once,
on a thread of its own started by the first batch that seeds, on a CUDA
stream of its own, and is published when that stream has finished. In
auto mode the host C++ seeder serves every batch until then; a forced run
waits for it. An upload or kernel error raises, at every seeding call
after it (no silent fallback to the host seeder).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import contexts, get_device
from ..index import native_ops
from ..ops import _build, fm_batch, resident, smem_device, sw_extend, sw_global
from ..parallel import align_step
from ..utils import spans
from . import ksw, native_engine
from .chaining import Chain, chain_seeds, enumerate_occurrences, filter_chains
from .engine import (AlignmentEngine, OP_M, SingleReadAlignment, cigar_nm,
                     encode_read)
from .extension import (MAX_BAND_TRY, AlnReg, cal_max_gap,
                        sort_dedup_patch)
from .seeding import Intv

WAVE_TRACE = os.environ.get("LARIAT_WAVE_TRACE") == "1"
WAVE_DEBUG = os.environ.get("LARIAT_WAVE_DEBUG") == "1"


def _line(text: str) -> None:
    """One line in one write: priming threads print these concurrently,
    and print's separate newline would let their lines run together."""
    print(text + "\n", end="", flush=True)


def _wtrace(kind: str, shape, t_build: float, t_disp: float, t_dl: float,
            up_b: int, dn_b: int) -> None:
    _line(f"[wtrace] {kind:5s} {str(shape):18s} build {t_build*1e3:6.0f}ms "
          f"disp {t_disp*1e3:6.0f}ms dl {t_dl*1e3:6.0f}ms "
          f"up {up_b/1e6:7.2f}MB dn {dn_b/1e6:6.2f}MB")


@dataclasses.dataclass
class _ExtTask:
    key: tuple
    query: np.ndarray
    target: np.ndarray
    h0: int
    w: int


class _ExtBatcher:
    """Extension tasks collected and run as one wave of K1's tile entry
    (``sw_extend.extend_batch``) on one device, padded by
    ``ksw.pad_tiles``, one (8, B) download. Results land in ``results`` by
    task key."""

    def __init__(self, device: torch.device):
        self.tasks: List[_ExtTask] = []
        self.results: Dict[tuple, ksw.ExtendResult] = {}
        self.device = device

    def add(self, key, query, target, h0, w):
        self.tasks.append(_ExtTask(key, query, target, int(h0), int(w)))

    def run(self, scores: dict) -> int:
        """Run the collected tasks with ``scores`` (``extend_batch``'s
        scoring keywords); returns how many ran."""
        if not self.tasks:
            return 0
        B = len(self.tasks)
        qa, qlen, ta, tlen = ksw.pad_tiles([t.query for t in self.tasks],
                                           [t.target for t in self.tasks])
        h0 = np.zeros(len(qlen), np.int32)
        w = np.zeros(len(qlen), np.int32)
        h0[:B] = [t.h0 for t in self.tasks]
        w[:B] = [t.w for t in self.tasks]
        rows = sw_extend.extend_batch(
            *(torch.from_numpy(a).to(self.device)
              for a in (qa, qlen, ta, tlen, w, h0)),
            **scores).cpu().numpy()          # ONE download: (8, Bp)
        score, qle, tle, gtle, gscore, moff = (rows[k].tolist()
                                               for k in range(6))
        for i, t in enumerate(self.tasks):
            self.results[t.key] = ksw.ExtendResult(
                score[i], qle[i], tle[i], gtle[i], gscore[i], moff[i])
        self.tasks = []
        return B


@dataclasses.dataclass
class _ChainCtx:
    chain: Chain
    rmax0: int
    rmax1: int
    rseq: np.ndarray
    srt: List[int]


@dataclasses.dataclass
class _G:
    """One task of the Python reg2aln ladder."""
    idx: int
    q: np.ndarray            # oriented query codes
    rseq: np.ndarray         # oriented reference codes
    truesc: int
    w2: int
    l_query: int
    last_sc: int = -(1 << 30)
    i: int = 0
    score: int = 0
    cigar: Optional[List[Tuple[int, int]]] = None


class PrimeAborted(Exception):
    """A priming pass stopped between waves because ``abort_prime`` was
    set: the caller discards the batch's partial results and host-routes
    it."""


class TorchBatchAlignmentEngine(AlignmentEngine):
    """Engine whose DP waves run as the port's kernels on ``device``
    (``lariat_tpu_torch.device.get_device`` picks it), or split over
    ``devices``, one entry a shard."""

    # genome scale above which device seeding is on by default: host C++
    # seeding is FM-cache-miss-bound at gigabase scale; small genomes keep
    # the (very fast there) host seeder
    DEVICE_SEED_AUTO_MIN_LPAC = 1_000_000_000
    # device types on which auto mode seeds there (the reference's: a real
    # accelerator, never the CPU)
    DEVICE_SEED_AUTO_TYPES = ("cuda",)

    # reg2aln tasks per session: every chunk's wave is dispatched before any
    # is downloaded
    R2ALN_CHUNK = 2048

    def __init__(self, fm, opt=None, pair=None, device=None, devices=None):
        super().__init__(fm, opt, pair)
        if devices is not None and (device is not None or not devices):
            raise ValueError("pass one device or a nonempty list of "
                             "devices")
        self.devices = [get_device(d) for d in (devices or [device])]
        self.device = self.devices[0]
        if any(d.type == "cuda" for d in self.devices):
            _build.load()           # build the kernels now, not mid-wave
        self.shard_waves = 0        # waves split over more than one device
        self.shard_log: list = []   # per split wave: {"Bp", "n_dev", "real"}
        # wall time with a wave dispatched or downloading, summed across
        # priming threads: the CLI reports wall / elapsed as the busy proxy
        self.wave_stats = {"wall": 0.0, "n": 0}
        self._stats_lock = threading.Lock()
        self._pac_lock = threading.Lock()
        self._pac_res: dict = {}    # device -> pac words on it
        self._seed_lock = threading.Lock()
        self._seed_thread: Optional[threading.Thread] = None
        self._seed_state = None     # (DeviceFMIndex, DeviceGenome)
        self._seed_err: Optional[Exception] = None
        self.seed_upload_s: Optional[float] = None   # once it has landed
        # batches seeded by each seeder, the host ones before the first
        # device one, and the mate-rescue tasks of K3's waves
        self.seed_batches = {"host": 0, "device": 0,
                             "host_before_device": None}
        self.rescue_tasks = 0
        self.largest_batch = 0      # pairs of the largest finished pass
        # set by the CLI's router (or a server's abort request) to make the
        # passes in flight stop at their next wave boundary
        self.abort_prime = False

    def _check_abort(self) -> None:
        if self.abort_prime:
            raise PrimeAborted()

    def _wave_done(self, seconds: float, n: int = 1) -> None:
        with self._stats_lock:
            self.wave_stats["wall"] += seconds
            self.wave_stats["n"] += n

    def _pac_resident(self, dev=None):
        """(pac_words tensor on ``dev``, default ``self.device``, l_pac),
        uploaded once a device and shared by every resident-fed wave and
        by the seeding index. The thread that makes it waits for the copy
        before any other can see it: the index upload makes it on a stream
        of its own."""
        dev = self.device if dev is None else dev
        with self._pac_lock:
            if dev not in self._pac_res:
                words = resident.pac_words_from_fm(self.fm, dev)
                if dev.type == "cuda":
                    torch.cuda.current_stream(dev).synchronize()
                self._pac_res[dev] = words
            return self._pac_res[dev], int(self.fm.l_pac)

    def _replicas(self, t: torch.Tensor) -> dict:
        """``t`` copied to each distinct device of the engine."""
        return {dev: t.to(dev) for dev in dict.fromkeys(self.devices)}

    def _split_wave(self, n_rows: int, real: int):
        """The rows of a wave dealt over ``self.devices`` (the reference's
        ``_shard_wave``): ([(device, rows)], inv).

        Block d holds the tasks o with o % n == d, in task order: a wave's
        real tasks fill its first rows, so every device gets an even share
        of them. Blocks may differ by one row and are empty when n_rows <
        n (the caller skips their launch). ``inv`` maps each task to its
        row in the blocks' concatenation, so indexing the concatenated
        results with it restores task order. With one device: one block of
        every row and ``inv`` None, and nothing is logged."""
        n = len(self.devices)
        if n == 1:
            return [(self.device, np.arange(n_rows))], None
        rows = [np.arange(d, n_rows, n) for d in range(n)]
        inv = np.empty(n_rows, np.int64)
        inv[np.concatenate(rows)] = np.arange(n_rows)
        with self._stats_lock:
            self.shard_waves += 1
            self.shard_log.append({"Bp": n_rows, "n_dev": n,
                                   "real": int(real)})
        return list(zip(self.devices, rows)), inv

    def _upload_seed_index(self) -> None:
        """The upload thread: the seeding index and the pac on a CUDA
        stream of its own, waited for, then published as ``_seed_state``;
        an error is kept in ``_seed_err`` for the seeding calls."""
        t0 = time.time()
        try:
            cuda = self.device.type == "cuda"
            stream = torch.cuda.Stream(self.device) if cuda else None
            # the thread starts with card 0 current: leaving a stream
            # context of another card switches back to it, which makes a
            # context there (cudaSetDevice), so the thread takes the
            # engine's card first
            with (torch.cuda.device(self.device) if cuda
                  else contextlib.nullcontext()), torch.cuda.stream(stream):
                fmd = fm_batch.DeviceFMIndex.from_host(self.fm, self.device)
                # the SA walk shares the seeding index and the waves' pac:
                # one copy of each on the device (its SA samples stay on
                # the host: sa_lookup_batch_host adds them there)
                dg = align_step.DeviceGenome.from_host(
                    self.fm, fmd, pac_words=self._pac_resident()[0])
                if cuda:
                    stream.synchronize()
            self.seed_upload_s = time.time() - t0
            self._seed_state = (fmd, dg)
        except Exception as e:  # noqa: BLE001 -- raised by the callers
            self._seed_err = e

    def _seed_index(self, wait: bool = True):
        """The device index for seeding, (DeviceFMIndex, DeviceGenome).

        The first call starts its upload on a thread (the reference's
        ``lariat-dseed-upload``); ``wait`` joins it. Without ``wait`` the
        call that started the upload, and every call until it has landed,
        returns None. An upload error raises here, at every call after
        it."""
        with self._seed_lock:
            started = self._seed_thread is None
            if started:
                self._seed_thread = threading.Thread(
                    target=self._upload_seed_index, daemon=True,
                    name="lariat-seed-upload")
                self._seed_thread.start()
        if wait:
            self._seed_thread.join()
        if self._seed_err is not None:
            raise self._seed_err
        return None if started and not wait else self._seed_state

    def _batch_done(self, pairs: int) -> None:
        """A priming pass of ``pairs`` pairs has finished (an aborted one
        never does)."""
        with self._stats_lock:
            self.largest_batch = max(self.largest_batch, pairs)

    def reset_path_log(self) -> None:
        """Start ``path_log``'s and ``wave_stats``' counts afresh (a server
        after its prewarm); the upload's seconds stay."""
        with self._stats_lock:
            self.wave_stats = {"wall": 0.0, "n": 0}
            self.seed_batches = {"host": 0, "device": 0,
                                 "host_before_device": None}
            self.rescue_tasks = 0
            self.largest_batch = 0

    def _note_seeder(self, device: bool) -> None:
        with self._stats_lock:
            sb = self.seed_batches
            sb["device" if device else "host"] += 1
            if device and sb["host_before_device"] is None:
                sb["host_before_device"] = sb["host"]

    def path_log(self) -> dict:
        """What the CLI prints of the run's device path: the engine's
        device (``"cuda:2"``), the cards on which the process holds a CUDA
        context (``device.contexts``), the batches each seeder served, the
        host-seeded ones before the first device-seeded one, the index
        upload's seconds, the mate-rescue tasks, the pairs of the largest
        finished priming pass, each kernel's largest launch in its own unit
        (``_build.largest``, since the last reset) and the device's peak of
        allocated bytes (``torch.cuda.max_memory_allocated``; None on the
        CPU)."""
        sb = self.seed_batches
        dev = self.device
        return {"device": str(dev), "cuda_contexts": contexts(),
                "seed_host_batches": sb["host"],
                "seed_device_batches": sb["device"],
                "host_batches_before_device": sb["host_before_device"],
                "seed_upload_s": self.seed_upload_s,
                "rescue_tasks": self.rescue_tasks,
                "largest_batch_pairs": self.largest_batch,
                "largest_launches": _build.largest(),
                "cuda_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                    if dev.type == "cuda" else None)}

    def sa_walks(self) -> list:
        """The SA lookups' K5 launches (``DeviceGenome.walks``); empty until
        a batch has seeded on the device."""
        return [] if self._seed_state is None else self._seed_state[1].walks

    def device_seeding(self) -> bool:
        """Whether batches seed on the device (the policy above)."""
        flag = os.environ.get("LARIAT_DEVICE_SEED")
        if flag:
            return flag != "0"
        return (self.device.type in self.DEVICE_SEED_AUTO_TYPES
                and self.fm.l_pac >= self.DEVICE_SEED_AUTO_MIN_LPAC)

    def _device_seed(self, nonempty):
        """Device 3-round SMEM seeding and SA walks, bit-identical to the
        native C++; None sends the batch to the host C++ seeder.

        LARIAT_DEVICE_SEED=1 forces it on (the first call waits for the
        index upload), =0 off; unset, it is on for a CUDA device at l_pac
        >= DEVICE_SEED_AUTO_MIN_LPAC, and the host seeder serves the
        batches until the upload has landed."""
        self._check_abort()
        if not (nonempty and self.device_seeding()):
            return None
        state = self._seed_index(
            wait=bool(os.environ.get("LARIAT_DEVICE_SEED")))
        if state is None:
            return None          # still uploading: the host seeder
        fmd, dg = state
        t_dev = time.time()
        with spans.span("seed.device", reads=len(nonempty)):
            out = smem_device.collect_seeds_rbegs_device(fmd, dg, self.fm,
                                                         nonempty, self.opt)
        self._wave_done(time.time() - t_dev)
        return out

    def _opt_key(self, bonus: int) -> tuple:
        opt = self.opt
        return (opt.gap_open_del, opt.gap_extend_del, opt.gap_open_ins,
                opt.gap_extend_ins, bonus, opt.zdrop, opt.match_score,
                -opt.mismatch_penalty)

    def _ext_scores(self, bonus: int) -> dict:
        """K1's scoring keywords (``sw_extend.extend_batch``) with end
        bonus ``bonus``; N scores -1 (bwa)."""
        return dict(zip(("o_del", "e_del", "o_ins", "e_ins", "end_bonus",
                         "zdrop", "match_sc", "mismatch_sc"),
                        self._opt_key(bonus)), n_sc=-1)

    def align_batch(self, seqs: List[bytes]) -> List[List[AlnReg]]:
        """Candidate regions for a batch of reads (mem_align1_core xN),
        bit-identical to ``align1`` per read: the C++ session replays
        chain2aln while each wave of speculative extensions runs as K1;
        without the native session, ``_align_batch_python``."""
        if native_engine.Align1Session.available():
            out = self._align_batch_session(seqs)
            if out is not None:
                return out
        return self._align_batch_python(seqs)

    def _align_batch_session(self, seqs: List[bytes]
                             ) -> Optional[List[List[AlnReg]]]:
        """``align_batch`` through the C++ session, each wave fed from
        resident data (K1's descriptor entry); None when the native seeder
        is unavailable."""
        opt = self.opt
        qs = [encode_read(s) for s in seqs]
        nonempty = [q for q in qs if len(q)]
        seeded = self._device_seed(nonempty)
        self._note_seeder(seeded is not None)
        if seeded is None:
            with spans.span("seed.host", reads=len(nonempty)):
                seeded = native_ops.collect_seeds_rbegs_batch(
                    self.fm, nonempty, opt)
        if seeded is None:
            return None
        mems_ne, rbegs_ne = seeded
        empty_m = np.zeros((0, 5), np.int64)
        empty_b = np.zeros(0, np.int64)
        mems_list, rbegs_list = [], []
        it = iter(zip(mems_ne, rbegs_ne))
        for q in qs:
            if len(q):
                m, b = next(it)
                mems_list.append(m)
                rbegs_list.append(b)
            else:
                mems_list.append(empty_m)
                rbegs_list.append(empty_b)
        sess = native_engine.Align1Session(self.fm, opt, qs, mems_list,
                                           rbegs_list)
        try:
            reads = self._replicas(resident.put_reads(qs, "cpu").codes)
            l_pac = int(self.fm.l_pac)
            while sess.pending():
                self._check_abort()
                bonus = opt.pen_clip5 if sess.phase() == 0 else opt.pen_clip3
                with spans.span("wave.ext",
                                timed=WAVE_TRACE or WAVE_DEBUG) as wave:
                    step = wave.child("build")
                    (rid, qstart, qdir, qlen, tstart, tdir, tlen, h0, w,
                     Lq, Lt) = sess.wave_descs()
                    desc = resident.pack_desc(rid, qstart, qdir, qlen,
                                              tstart, tdir, tlen, h0, w,
                                              l_pac)
                    real = np.count_nonzero(qlen)
                    blocks, inv = self._split_wave(len(desc), real)
                    step.end()
                    step = wave.child("disp")
                    t_dev = time.time()
                    outs = [resident.extend_wave_resident(
                        reads[dev], self._pac_resident(dev)[0], l_pac,
                        torch.from_numpy(
                            desc if inv is None else desc[idx]).to(dev),
                        Lq=Lq, Lt=Lt, opt_key=self._opt_key(bonus))
                        for dev, idx in blocks if len(idx)]
                    step.end()
                    with wave.child("dl"):
                        rows = ksw.download_blocks(outs, inv, 1)  # (8, B)
                    self._wave_done(time.time() - t_dev)
                    wave.set(tasks=int(real), rows=len(desc),
                             up_b=desc.nbytes, dn_b=rows.nbytes)
                if WAVE_TRACE:
                    _wtrace("ext", (len(qlen), Lq, Lt), wave.kid_s("build"),
                            wave.kid_s("disp"), wave.kid_s("dl"),
                            desc.nbytes, rows.nbytes)
                sess.feed(rows[0], rows[1], rows[2], rows[3], rows[4],
                          rows[5])
                if WAVE_DEBUG:
                    _line(f"[wave] phase={sess.phase()} B={len(qlen)} "
                          f"q={Lq} t={Lt} "
                          f"{time.time() - wave.t0 / 1e9:.2f}s")
            return sess.finish()
        finally:
            sess.close()

    # --------------------------------------- the Python replay of chain2aln

    def _prepare_chains(self, q: np.ndarray,
                        mems=None, rbegs=None) -> List[_ChainCtx]:
        opt, fm = self.opt, self.fm
        chains = filter_chains(opt, chain_seeds(fm, q, opt, mems, rbegs))
        out = []
        l_query = len(q)
        for c in chains:
            if not c.seeds:
                continue
            rmax0, rmax1 = fm.seq_len, 0
            for t in c.seeds:
                b = t.rbeg - (t.qbeg + cal_max_gap(opt, t.qbeg))
                e = (t.rbeg + t.len + (l_query - t.qbeg - t.len)
                     + cal_max_gap(opt, l_query - t.qbeg - t.len))
                rmax0 = min(rmax0, b)
                rmax1 = max(rmax1, e)
            rmax0 = max(rmax0, 0)
            rmax1 = min(rmax1, fm.seq_len)
            if rmax0 < fm.l_pac < rmax1:
                if c.seeds[0].rbeg < fm.l_pac:
                    rmax1 = fm.l_pac
                else:
                    rmax0 = fm.l_pac
            rseq = fm.fetch_fmd(rmax0, rmax1)
            srt = sorted(range(len(c.seeds)),
                         key=lambda i: (c.seeds[i].score, i), reverse=True)
            out.append(_ChainCtx(c, rmax0, rmax1, rseq, srt))
        return out

    def _ext_wave(self, batcher: _ExtBatcher, bonus: int) -> None:
        """Run ``batcher``'s tasks as one K1 wave, counted as a wave."""
        t_dev = time.time()
        if batcher.run(self._ext_scores(bonus)):
            self._wave_done(time.time() - t_dev)

    def _align_batch_python(self, seqs: List[bytes]) -> List[List[AlnReg]]:
        """The Python replay of chain2aln (``align_batch`` without the
        native session): host seeding, four K1 waves (left extensions,
        their band retries, right extensions, theirs) on ``self.device``,
        then mem_chain2aln's sequential control flow over the cached
        results, and ``sort_dedup_patch``."""
        opt = self.opt
        qs = [encode_read(s) for s in seqs]
        # native batched seeding + one batched SA dereference for all reads
        nonempty = [q for q in qs if len(q)]
        with spans.span("seed.host", reads=len(nonempty)):
            seeds_per = native_ops.collect_seeds_batch(self.fm, nonempty,
                                                       opt)
        self._note_seeder(False)
        mems_per: List[Optional[List[Intv]]] = [None] * len(qs)
        rbegs_per: List[Optional[List[int]]] = [None] * len(qs)
        if seeds_per is not None:
            it = iter(seeds_per)
            all_rows = []
            occ_info = []
            for i, q in enumerate(qs):
                if not len(q):
                    continue
                arr = next(it)
                mems = [Intv(int(r[0]), int(r[1]), int(r[2]), int(r[3]),
                             int(r[4])) for r in arr]
                mems_per[i] = mems
                occs = enumerate_occurrences(mems, opt)
                occ_info.append((i, len(occs)))
                all_rows.extend(row for _, row in occs)
            rows = np.asarray(all_rows, dtype=np.int64)
            rb = (self.fm.sa_lookup_many(rows) if len(rows)
                  else np.zeros(0, np.int64))
            off = 0
            for i, n in occ_info:
                rbegs_per[i] = [int(v) for v in rb[off:off + n]]
                off += n
        ctxs: List[List[_ChainCtx]] = [
            self._prepare_chains(q, mems_per[i], rbegs_per[i])
            if len(q) else [] for i, q in enumerate(qs)]
        # ---- wave L: left extensions (band try ladder, speculative) -------
        batcher = _ExtBatcher(self.device)
        for ri, clist in enumerate(ctxs):
            for ci, ctx in enumerate(clist):
                for si in ctx.srt:
                    s = ctx.chain.seeds[si]
                    if s.qbeg:
                        qseg = qs[ri][:s.qbeg][::-1]
                        tseg = ctx.rseq[:s.rbeg - ctx.rmax0][::-1]
                        batcher.add((ri, ci, si, "L", 0), qseg, tseg,
                                    s.len * opt.match_score,
                                    opt.band_width)
        self._ext_wave(batcher, opt.pen_clip5)
        # band-doubling retries for left
        retry = []
        for t_key, res in list(batcher.results.items()):
            if t_key[3] != "L" or t_key[4] != 0:
                continue
            if not (res.max_off
                    < (opt.band_width >> 1) + (opt.band_width >> 2)):
                retry.append(t_key)
        for key in retry:
            ri, ci, si, _, _ = key
            ctx = ctxs[ri][ci]
            s = ctx.chain.seeds[si]
            qseg = qs[ri][:s.qbeg][::-1]
            tseg = ctx.rseq[:s.rbeg - ctx.rmax0][::-1]
            batcher.add((ri, ci, si, "L", 1), qseg, tseg,
                        s.len * opt.match_score, opt.band_width << 1)
        self._ext_wave(batcher, opt.pen_clip5)

        def left_result(ri, ci, si) -> Tuple[ksw.ExtendResult, int]:
            """Replay the MAX_BAND_TRY ladder for one left extension."""
            prev = -1
            for i in range(MAX_BAND_TRY):
                aw = opt.band_width << i
                res = batcher.results.get((ri, ci, si, "L", i))
                if res is None:  # retry not run => ladder stopped earlier
                    break
                if res.score == prev or res.max_off < (aw >> 1) + (aw >> 2):
                    return res, aw
                prev = res.score
                last, law = res, aw
            return (res, aw) if res is not None else (last, law)

        # ---- wave R: right extensions (h0 from the left outcome) ----------
        right_specs: Dict[tuple, Tuple[int, int]] = {}
        for ri, clist in enumerate(ctxs):
            for ci, ctx in enumerate(clist):
                for si in ctx.srt:
                    s = ctx.chain.seeds[si]
                    l_query = len(qs[ri])
                    if s.qbeg + s.len == l_query:
                        continue
                    if s.qbeg:
                        # a->score after the left step is the local-extension
                        # max regardless of the gscore (to-end) choice
                        lres, _ = left_result(ri, ci, si)
                        sc0 = lres.score
                    else:
                        sc0 = s.len * opt.match_score
                    qe = s.qbeg + s.len
                    re_off = s.rbeg + s.len - ctx.rmax0
                    qseg = qs[ri][qe:]
                    tseg = ctx.rseq[re_off:]
                    right_specs[(ri, ci, si)] = (sc0, re_off)
                    batcher.add((ri, ci, si, "R", 0), qseg, tseg, sc0,
                                opt.band_width)
        self._ext_wave(batcher, opt.pen_clip3)
        retry = []
        for t_key, res in list(batcher.results.items()):
            if t_key[3] != "R" or t_key[4] != 0:
                continue
            sc0 = right_specs[t_key[:3]][0]
            if (res.score != sc0 and not (
                    res.max_off
                    < (opt.band_width >> 1) + (opt.band_width >> 2))):
                retry.append(t_key)
        for key in retry:
            ri, ci, si, _, _ = key
            ctx = ctxs[ri][ci]
            s = ctx.chain.seeds[si]
            sc0, re_off = right_specs[(ri, ci, si)]
            qseg = qs[ri][s.qbeg + s.len:]
            tseg = ctx.rseq[re_off:]
            batcher.add((ri, ci, si, "R", 1), qseg, tseg, sc0,
                        opt.band_width << 1)
        self._ext_wave(batcher, opt.pen_clip3)

        def right_result(ri, ci, si) -> Tuple[ksw.ExtendResult, int]:
            # C's loop reads prev = a->score, which entering the right step
            # equals sc0 (the left outcome)
            prev = right_specs[(ri, ci, si)][0]
            res = law = None
            for i in range(MAX_BAND_TRY):
                aw = opt.band_width << i
                r = batcher.results.get((ri, ci, si, "R", i))
                if r is None:
                    break
                res, law = r, aw
                if r.score == prev or r.max_off < (aw >> 1) + (aw >> 2):
                    return r, aw
                prev = r.score
            return res, law

        # ---- replay mem_chain2aln's exact sequential control flow ---------
        out: List[List[AlnReg]] = []
        for ri, clist in enumerate(ctxs):
            q = qs[ri]
            l_query = len(q)
            regs: List[AlnReg] = []
            for ci, ctx in enumerate(clist):
                c = ctx.chain
                skipped = set()
                for order, si in enumerate(ctx.srt):
                    s = c.seeds[si]
                    hit = None
                    for p in regs:
                        if (s.rbeg < p.rb or s.rbeg + s.len > p.re
                                or s.qbeg < p.qb or s.qbeg + s.len > p.qe):
                            continue
                        if s.len - p.seedlen0 > 0.1 * l_query:
                            continue
                        qd = s.qbeg - p.qb
                        rd = s.rbeg - p.rb
                        ww = min(cal_max_gap(opt, min(qd, rd)), p.w)
                        if qd - rd < ww and rd - qd < ww:
                            hit = p
                            break
                        qd = p.qe - (s.qbeg + s.len)
                        rd = p.re - (s.rbeg + s.len)
                        ww = min(cal_max_gap(opt, min(qd, rd)), p.w)
                        if qd - rd < ww and rd - qd < ww:
                            hit = p
                            break
                    if hit is not None:
                        conflict = False
                        for so in range(order):
                            j = ctx.srt[so]
                            if j in skipped:
                                continue
                            t = c.seeds[j]
                            if t.len < s.len * 0.95:
                                continue
                            if (s.qbeg <= t.qbeg
                                    and s.qbeg + s.len - t.qbeg >= s.len // 4
                                    and t.qbeg - s.qbeg != t.rbeg - s.rbeg):
                                conflict = True
                                break
                            if (t.qbeg <= s.qbeg
                                    and t.qbeg + t.len - s.qbeg >= s.len // 4
                                    and s.qbeg - t.qbeg != s.rbeg - t.rbeg):
                                conflict = True
                                break
                        if not conflict:
                            skipped.add(si)
                            continue
                    a = AlnReg(w=opt.band_width, rid=c.rid,
                               frac_rep=c.frac_rep)
                    aw0 = aw1 = opt.band_width
                    if s.qbeg:
                        res, aw0 = left_result(ri, ci, si)
                        a.score = res.score
                        if (res.gscore <= 0
                                or res.gscore <= a.score - opt.pen_clip5):
                            a.qb = s.qbeg - res.qle
                            a.rb = s.rbeg - res.tle
                            a.truesc = a.score
                        else:
                            a.qb = 0
                            a.rb = s.rbeg - res.gtle
                            a.truesc = res.gscore
                    else:
                        a.score = a.truesc = s.len * opt.match_score
                        a.qb = 0
                        a.rb = s.rbeg
                    if s.qbeg + s.len != l_query:
                        sc0 = a.score
                        res, aw1 = right_result(ri, ci, si)
                        qe = s.qbeg + s.len
                        re_off = s.rbeg + s.len - ctx.rmax0
                        a.score = res.score
                        if (res.gscore <= 0
                                or res.gscore <= a.score - opt.pen_clip3):
                            a.qe = qe + res.qle
                            a.re = ctx.rmax0 + re_off + res.tle
                            a.truesc += a.score - sc0
                        else:
                            a.qe = l_query
                            a.re = ctx.rmax0 + re_off + res.gtle
                            a.truesc += res.gscore - sc0
                    else:
                        a.qe = l_query
                        a.re = s.rbeg + s.len
                    a.seedcov = 0
                    for t in c.seeds:
                        if (t.qbeg >= a.qb and t.qbeg + t.len <= a.qe
                                and t.rbeg >= a.rb and t.rbeg + t.len <= a.re):
                            a.seedcov += t.len
                    a.w = max(aw0, aw1)
                    a.seedlen0 = s.len
                    regs.append(a)
            regs = sort_dedup_patch(self.fm, q, opt, regs, self.mat)
            out.append(regs)
        return out

    def local_align_device(self, tasks):
        """Mate-rescue local SW for a whole batch as one two-pass K3 wave
        (a K3 call a block of the wave's split); bit-identical to per-task
        ksw.local_align."""
        self._check_abort()
        opt = self.opt
        t_dev = time.time()
        with spans.span("wave.loc", timed=WAVE_TRACE) as wave:
            out = ksw.local_align_batch(
                tasks, self.mat, opt.gap_open_del, opt.gap_extend_del,
                opt.gap_open_ins, opt.gap_extend_ins,
                opt.min_seed_len * opt.match_score, device=self.device,
                split_fn=self._split_wave, wave=wave)
        self._wave_done(time.time() - t_dev)
        with self._stats_lock:
            self.rescue_tasks += len(tasks)
        if WAVE_TRACE:     # no DP task: a line of zeros, as the reference
            _wtrace("loc", (len(tasks),), wave.kid_s("build"),
                    wave.kid_s("disp"), wave.kid_s("dl"),
                    wave.attrs.get("up_b", 0), wave.attrs.get("dn_b", 0))
        return out

    def _pairs_regions(self, recs):
        """(regs1, regs2) of every pair, from one ``align_batch`` over both
        mates of every record."""
        seqs = []
        for rec in recs:
            seqs.append(rec.read1)
            seqs.append(rec.read2)
        all_regs = self.align_batch(seqs)
        return [(all_regs[2 * i] if len(rec.read1) else [],
                 all_regs[2 * i + 1] if len(rec.read2) else [])
                for i, rec in enumerate(recs)]

    def prime_regions(self, recs, score_delta: Optional[int] = None
                      ) -> List[tuple]:
        """Candidate regions of many read pairs on the device.

        With ``score_delta``, mate rescue and the final global SW run here
        too and each pair gets (regs1, regs2, True, sras1, sras2): workers
        then interpret and walk without touching any DP. Without it, each
        pair gets (regs1, regs2) before rescue, and workers rescue and
        realign on the host."""
        with spans.span("prime.regions", pairs=len(recs)):
            per_pair = self._pairs_regions(recs)
        if score_delta is None:
            self._batch_done(len(recs))
            return per_pair
        with spans.span("prime.rescue"):
            pairs = [(encode_read(rec.read1), encode_read(rec.read2), r1,
                      r2) for rec, (r1, r2) in zip(recs, per_pair)]
            self.rescue_pairs_batch(pairs, score_delta,
                                    local_align_fn=self.local_align_device)
        with spans.span("prime.reg2aln") as sp:
            # final SW for every post-rescue candidate (the task list
            # get_alignments would build: one per region, in reg order)
            tasks = []
            counts = []
            for rec, (r1, r2) in zip(recs, per_pair):
                for reg in r1:
                    tasks.append((rec.read1, reg))
                for reg in r2:
                    tasks.append((rec.read2, reg))
                counts.append((len(r1), len(r2)))
            sp.set(tasks=len(tasks))
            sras = self.reg2aln_batch(tasks) if tasks else []
        out = []
        off = 0
        for (r1, r2), (n1, n2) in zip(per_pair, counts):
            out.append((r1, r2, True, sras[off:off + n1],
                        sras[off + n1:off + n1 + n2]))
            off += n1 + n2
        self._batch_done(len(recs))
        return out

    def prime_pairs(self, recs, score_delta: int) -> None:
        """Candidate regions and mate rescue of many pairs on the device;
        caches each record's finished pair (keyed by ``id(rec)``) in
        ``_pair_cache``, which ``rfa.candidates.get_chains`` consumes."""
        with spans.span("prime.regions", pairs=len(recs)):
            per_pair = self._pairs_regions(recs)
        with spans.span("prime.rescue"):
            pairs = [(encode_read(rec.read1), encode_read(rec.read2), r1,
                      r2) for rec, (r1, r2) in zip(recs, per_pair)]
            self.rescue_pairs_batch(pairs, score_delta,
                                    local_align_fn=self.local_align_device)
        cache = getattr(self, "_pair_cache", None)
        if cache is None:
            cache = self._pair_cache = {}
        for rec, (q1, q2, regs1, regs2) in zip(recs, pairs):
            cache[id(rec)] = self.finish_pair(q1, q2, regs1, regs2,
                                              score_delta, skip_rescue=True)
        self._batch_done(len(recs))

    def align1(self, q: np.ndarray, mems=None, rbegs=None) -> List[AlnReg]:
        """One read's candidate regions through ``align_batch``; with its
        seeds given (``mems`` and ``rbegs``), the host path of
        ``AlignmentEngine.align1``, which takes them."""
        if mems is not None and rbegs is not None:
            return super().align1(q, mems, rbegs)
        if len(q) == 0:
            return []
        return self.align_batch([bytes(b"ACGTN"[min(int(c), 4)]
                                       for c in q)])[0]

    # -------------------------------------------------- batched mem_reg2aln

    def reg2aln_batch(self, tasks) -> List[SingleReadAlignment]:
        """mem_reg2aln for many (read, region) tasks, bit-identical to
        ``reg2aln`` per task: through the C++ sessions, or without them
        ``_reg2aln_python``."""
        if native_engine.Reg2AlnSession.available():
            return self._reg2aln_session(tasks)
        return self._reg2aln_python(tasks)

    def _reg2aln_session(self, tasks) -> List[SingleReadAlignment]:
        """Chunked sessions (native/align1.cpp r2s_*) replay the w2 band
        ladder and the NM/clip finish while each wave runs as K2 + K2b.
        Every live chunk's wave is dispatched before any wave's results are
        downloaded."""
        CH = self.R2ALN_CHUNK
        states = [self._r2s_open(tasks[s:s + CH])
                  for s in range(0, len(tasks), CH)]
        try:
            while True:
                live = [st for st in states
                        if st["sess"] is not None and st["sess"].pending()]
                if not live:
                    break
                self._check_abort()
                t_dev = time.time()
                handles = [(st, self._r2s_dispatch(st)) for st in live]
                for st, h in handles:
                    self._r2s_feed(st, h)
                self._wave_done(time.time() - t_dev, len(handles))
        except PrimeAborted:
            # close without finish(): the sessions are mid-ladder and the
            # caller discards the batch
            for st in states:
                if st["sess"] is not None:
                    st["sess"].close()
                    st["sess"] = None
            raise
        finally:
            metas = []
            for st in states:
                sess = st["sess"]
                if sess is not None:
                    try:
                        metas.append(sess.finish())
                    finally:
                        sess.close()
                else:
                    metas.append(None)
        out_all: List[Optional[SingleReadAlignment]] = []
        for st, mc in zip(states, metas):
            if mc is not None:
                self._r2s_fill(st, *mc)
            out_all.extend(st["out"])
        return out_all

    def _r2s_open(self, tasks):
        """One reg2aln session state dict (a finished one when no task
        needs DP)."""
        out: List[Optional[SingleReadAlignment]] = [None] * len(tasks)
        reads = []
        read_key: Dict[int, int] = {}
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
            rows.append((k, reg.qb, reg.qe, reg.rb, reg.re, reg.truesc,
                         reg.w))
            live.append(idx)
        st = {"tasks": tasks, "out": out, "rows": rows, "live": live,
              "sess": None, "reads": reads, "reads_res": None}
        if rows:
            st["sess"] = native_engine.Reg2AlnSession(
                self.fm, self.opt, reads, rows)
        return st

    def _r2s_dispatch(self, st):
        """Launch one reg2aln wave (K2 + K2b a block of its split) for a
        session; returns the blocks' blobs, still on their devices, the
        split's ``inv`` and the op count S."""
        sess = st["sess"]
        with spans.span("wave.r2a.d", timed=WAVE_TRACE) as wave:
            step = wave.child("build")
            if st["reads_res"] is None:
                st["reads_res"] = self._replicas(
                    resident.put_reads(st["reads"], "cpu").codes)
            l_pac = int(self.fm.l_pac)
            (rid, qstart, qdir, qlen, tstart, tdir, tlen, wv,
             Lq, Lt) = sess.wave_descs()
            desc = resident.pack_desc(rid, qstart, qdir, qlen, tstart, tdir,
                                      tlen, np.zeros_like(wv), wv, l_pac)
            real = sess.pending()
            blocks, inv = self._split_wave(len(desc), real)
            S = Lq + Lt
            step.end()
            blobs = []
            for dev, idx in blocks:
                if not len(idx):
                    continue
                step = wave.child("build")
                desc_d = torch.from_numpy(
                    desc if inv is None else desc[idx]).to(dev)
                q, t = resident.build_qt(st["reads_res"][dev],
                                         self._pac_resident(dev)[0], l_pac,
                                         desc_d, Lq=Lq, Lt=Lt)
                qlen_d, tlen_d, w_d = (
                    desc_d[:, k].to(torch.int32).contiguous()
                    for k in (resident.D_QL, resident.D_TL, resident.D_W))
                step.end()
                with wave.child("disp"):
                    blobs.append(self._global_wave(q, qlen_d, t, tlen_d,
                                                   w_d, S))
            wave.set(tasks=int(real), rows=len(desc), up_b=desc.nbytes,
                     dn_b=0)
        if WAVE_TRACE:
            _wtrace("r2a.d", (len(desc), Lq, Lt), wave.kid_s("build"),
                    wave.kid_s("disp"), 0.0, desc.nbytes, 0)
        return blobs, inv, S

    def _global_wave(self, q, qlen, t, tlen, w, S: int) -> torch.Tensor:
        """K2 then K2b on one block's tensors -> its (B, S//4 + 12) blob,
        still on the device."""
        opt = self.opt
        score, z = sw_global.global_batch(
            q, qlen, t, tlen, w, o_del=opt.gap_open_del,
            e_del=opt.gap_extend_del, o_ins=opt.gap_open_ins,
            e_ins=opt.gap_extend_ins, match_sc=opt.match_score,
            mismatch_sc=-opt.mismatch_penalty)
        return sw_global.traceback_ops_fused(z, qlen, tlen, w, score, S=S)

    def _r2s_feed(self, st, handle) -> None:
        """Download a dispatched wave's blobs and feed the session."""
        blobs, inv, S = handle
        with spans.span("wave.r2a.f", timed=WAVE_TRACE) as wave:
            with wave.child("dl"):
                blob = ksw.download_blocks(blobs, inv, 0)
            wave.set(rows=len(blob), dn_b=blob.nbytes)
        if WAVE_TRACE:
            _wtrace("r2a.f", (len(blob),), 0.0, 0.0, wave.kid_s("dl"), 0,
                    blob.nbytes)
        packed, score, i_fin, k_fin = sw_global.split_traceback_blob(blob, S)
        cig_mat, nops = sw_global.cigars_from_ops_packed(packed, i_fin,
                                                         k_fin, S)
        st["sess"].feed(score, cig_mat, nops)

    def _r2s_fill(self, st, meta, cig) -> None:
        contigs = self.fm.contigs
        tasks, out = st["tasks"], st["out"]
        for idx, mrow in zip(st["live"], meta):
            pos, rid, is_rev, nm, n_pairs, coff = (int(v) for v in mrow)
            flatc = cig[2 * coff:2 * (coff + n_pairs)].tolist()
            cigar = tuple(zip(flatc[0::2], flatc[1::2]))
            reg = tasks[idx][1]
            out[idx] = SingleReadAlignment(
                pos=pos - contigs[rid].offset, rid=rid,
                chrom=contigs[rid].name, reversed_=bool(is_rev),
                edit_distance=nm, cigar=cigar, score=reg.score,
                sub=max(reg.sub, reg.csub), read_s=reg.qb, read_e=reg.qe)

    # ------------------------------------------- the Python reg2aln ladder

    def _reg2aln_python(self, tasks) -> List[SingleReadAlignment]:
        """mem_reg2aln without the native session: the w2 band ladder (at
        most 3 steps, the no-gap shortcut on the host) replayed over
        batched K2 + K2b waves, split over ``devices``; then
        ``_finish_reg2aln``."""
        opt, fm = self.opt, self.fm
        out: List[Optional[SingleReadAlignment]] = [None] * len(tasks)
        pend: List[_G] = []
        for idx, (seq, reg) in enumerate(tasks):
            if reg is None or reg.rb < 0 or reg.re < 0:
                out[idx] = SingleReadAlignment()
                continue
            query = encode_read(seq)
            qb, qe, rb, re = reg.qb, reg.qe, reg.rb, reg.re
            w2 = max(
                self._infer_bw(qe - qb, re - rb, reg.truesc, opt.match_score,
                               opt.gap_open_del, opt.gap_extend_del),
                self._infer_bw(qe - qb, re - rb, reg.truesc, opt.match_score,
                               opt.gap_open_ins, opt.gap_extend_ins))
            if w2 > opt.band_width:
                w2 = min(w2, reg.w)
            qseg = query[qb:qe].astype(np.int64)
            if len(qseg) <= 0 or rb >= re or (rb < fm.l_pac < re):
                out[idx] = self._finish_reg2aln(reg, len(query), None)
                continue
            rseq = fm.fetch_fmd(rb, re).astype(np.int64)
            if rb >= fm.l_pac:
                qseg = qseg[::-1].copy()
                rseq = rseq[::-1].copy()
            pend.append(_G(idx=idx, q=qseg, rseq=rseq, truesc=reg.truesc,
                           w2=w2, l_query=len(query)))

        while pend:
            # run one ladder step for every pending task, batched by shape
            wave = pend
            pend = []
            run_idx = []
            for g in wave:
                g.w2 = min(g.w2, opt.band_width << 2)
                if len(g.q) == len(g.rseq) and g.w2 == 0:
                    # no-gap shortcut: all-M cigar, summed score
                    g.cigar = [(OP_M, len(g.q))]
                    g.score = int(self.mat[g.rseq, g.q].sum())
                else:
                    run_idx.append(g)
            if run_idx:
                t_dev = time.time()
                scores, cigars = self._ladder_wave(run_idx)
                self._wave_done(time.time() - t_dev)
                for i, g in enumerate(run_idx):
                    g.score = int(scores[i])
                    g.cigar = cigars[i]
            # replay the ladder's break conditions
            for g in wave:
                if g.score == g.last_sc or g.w2 == opt.band_width << 2:
                    done = True
                else:
                    g.last_sc = g.score
                    g.w2 <<= 1
                    g.i += 1
                    done = not (g.i < 3
                                and g.score < g.truesc - opt.match_score)
                if done:
                    out[g.idx] = self._finish_reg2aln(tasks[g.idx][1],
                                                      g.l_query, g)
                else:
                    pend.append(g)
        return out

    def _ladder_wave(self, run_idx: List[_G]):
        """One ladder step of ``run_idx`` as a K2 + K2b wave (lengths
        padded to multiples of 64, the batch to a power of two of at least
        128), a block of its split on each device, one download a block:
        (scores, CIGARs) in task order."""
        B = len(run_idx)
        qa, qlen, ta, tlen = ksw.pad_tiles([g.q for g in run_idx],
                                           [g.rseq for g in run_idx])
        wv = np.zeros(len(qlen), np.int32)
        wv[:B] = [g.w2 for g in run_idx]
        S = qa.shape[1] + ta.shape[1]
        blocks, inv = self._split_wave(len(qlen), B)
        blobs = [self._global_wave(
            *(torch.from_numpy(a if inv is None else a[idx]).to(dev)
              for a in (qa, qlen, ta, tlen, wv)), S)
            for dev, idx in blocks if len(idx)]
        blob = ksw.download_blocks(blobs, inv, 0)
        packed, scores, i_fin, k_fin = sw_global.split_traceback_blob(blob,
                                                                      S)
        return scores, sw_global.cigars_from_ops(
            sw_global.unpack_ops(packed, S), i_fin, k_fin)

    def _finish_reg2aln(self, reg: AlnReg, l_query: int,
                        g: Optional[_G]) -> SingleReadAlignment:
        """mem_reg2aln's tail after the ladder: NM over the task's oriented
        codes (-1 without a ladder), then the position and clips
        (``_place``)."""
        if g is None:
            return self._place(reg, l_query, None, -1)
        return self._place(reg, l_query, g.cigar,
                           cigar_nm(g.cigar, g.q, g.rseq))
