"""The batch alignment engine on PyTorch: every DP wave of the priming pass
runs through the port's kernels.

``TorchBatchAlignmentEngine`` is the host control flow of lariat_tpu's
``BatchAlignmentEngine`` (``align_batch``, ``prime_regions`` and the
reg2aln session driver), copied without its JAX and Pallas branches.
The C++ sessions (native/align1.cpp ``a1s_*`` / ``r2s_*``) replay BWA-MEM's
sequential control flow between waves exactly as in the reference:

  seed extension  ``_align_batch_session``  resident gather + K1
  mate rescue     ``local_align_device``     two-pass K3
  reg2aln         ``_r2s_dispatch``/``_feed`` K2, then K2b's backtrack

The engine is the reference's drop-in: ``prime_regions(recs)`` without a
score delta returns the pairs' (regs1, regs2) before rescue,
``prime_pairs`` fills ``_pair_cache`` for ``rfa.candidates.get_chains``,
and ``align1`` runs one read through ``align_batch``. Setting
``abort_prime`` makes a priming pass raise ``PrimeAborted`` at its next
wave boundary (the seeding call, each seed-extension wave, the rescue wave,
each reg2aln wave); its sessions close without finishing. The CLI's router
sets it at the end of its input, after a grace, and host-routes the
batches whose passes it abandons.

The wave split (the reference's ``mesh`` and ``_shard_wave``): given
``devices``, a list with one entry a shard (the same card may appear more
than once), each wave's rows are dealt round-robin over them, block d
holding the tasks o with o % n == d; every block is dispatched on its own
device before any is downloaded, and the results are put back in task
order. The genome's pac words and a group's reads are replicated, one copy
a distinct device; seeding stays on ``devices[0]``. With one device (the
default) a wave is one block, as before.

The wave trace, read once at import as the reference reads it:
``LARIAT_WAVE_TRACE=1`` prints the reference's ``[wtrace]`` line, in its
format, for each wave at its four sites (``ext`` a seed-extension wave,
``loc`` a rescue wave, ``r2a.d`` a reg2aln dispatch, ``r2a.f`` its
download): build, dispatch and download ms and the MB sent each way. A
launch is asynchronous, as a JAX dispatch is, so the download time holds
the kernels' time. ``LARIAT_WAVE_DEBUG=1`` prints the reference's
``[wave]`` line after each seed-extension wave.

Seeding follows the reference's policy: ``LARIAT_DEVICE_SEED=1`` runs the
3-round SMEM seeding and its SA walks on the device (``_device_seed``,
kernels K4a-K4c and K5), ``=0`` keeps the host C++ seeder, and unset turns
device seeding on for a CUDA device at genomes of
``DEVICE_SEED_AUTO_MIN_LPAC`` (1 Gbp) and above. The index uploads once, at
first use; an upload or kernel error raises (no silent fallback to the host
seeder). The engine requires the native sessions and raises without them:
the reference's Python replay paths are not ported.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..device import get_device
from ..index import native_ops
from ..ops import _build, fm_batch, resident, smem_device, sw_global
from ..parallel import align_step
from . import ksw, native_engine
from .engine import AlignmentEngine, SingleReadAlignment, encode_read
from .extension import AlnReg

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

    # reg2aln tasks per session: every chunk's wave is dispatched before any
    # is downloaded
    R2ALN_CHUNK = 2048

    def __init__(self, fm, opt=None, pair=None, device=None, devices=None):
        super().__init__(fm, opt, pair)
        if devices is not None and (device is not None or not devices):
            raise ValueError("pass one device or a nonempty list of "
                             "devices")
        if not (native_engine.Align1Session.available()
                and native_engine.Reg2AlnSession.available()):
            raise RuntimeError(
                "lariat_tpu_torch needs the native sessions (a1s_*/r2s_*) of "
                "native/liblariat_native.so; build it with `make -C native`")
        lib = native_engine._lib()
        for sym in ("a1s_fill_desc", "r2s_fill_desc",
                    "ksw_cigar_from_ops_packed_batch"):
            if not hasattr(lib, sym):
                raise RuntimeError(f"native library lacks {sym}; rebuild it")
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
        self._seed_state = None     # (DeviceFMIndex, DeviceGenome)
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
        uploaded once a device and shared by every resident-fed wave."""
        dev = self.device if dev is None else dev
        with self._pac_lock:
            if dev not in self._pac_res:
                self._pac_res[dev] = resident.pac_words_from_fm(self.fm, dev)
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

    def _seed_index(self):
        """The device index for seeding, uploaded once, at first use, by
        the first batch that needs it; an upload error raises."""
        with self._seed_lock:
            if self._seed_state is None:
                fmd = fm_batch.DeviceFMIndex.from_host(self.fm, self.device)
                # the SA walk shares the seeding index and the waves' pac:
                # one copy of each on the device (its SA samples stay on the
                # host: sa_lookup_batch_host adds them there)
                dg = align_step.DeviceGenome.from_host(
                    self.fm, fmd, pac_words=self._pac_resident()[0])
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self._seed_state = (fmd, dg)
            return self._seed_state

    def sa_walks(self) -> list:
        """The SA lookups' K5 launches (``DeviceGenome.walks``); empty until
        a batch has seeded on the device."""
        return [] if self._seed_state is None else self._seed_state[1].walks

    def device_seeding(self) -> bool:
        """Whether batches seed on the device (the policy above)."""
        flag = os.environ.get("LARIAT_DEVICE_SEED")
        if flag:
            return flag != "0"
        return (self.device.type == "cuda"
                and self.fm.l_pac >= self.DEVICE_SEED_AUTO_MIN_LPAC)

    def _device_seed(self, nonempty):
        """Device 3-round SMEM seeding and SA walks, bit-identical to the
        native C++; None sends the batch to the host C++ seeder.

        LARIAT_DEVICE_SEED=1 forces it on, =0 off; unset, it is on for a
        CUDA device at l_pac >= DEVICE_SEED_AUTO_MIN_LPAC."""
        self._check_abort()
        if not (nonempty and self.device_seeding()):
            return None
        fmd, dg = self._seed_index()
        t_dev = time.time()
        out = smem_device.collect_seeds_rbegs_device(fmd, dg, self.fm,
                                                     nonempty, self.opt)
        self._wave_done(time.time() - t_dev)
        return out

    def _opt_key(self, bonus: int) -> tuple:
        opt = self.opt
        return (opt.gap_open_del, opt.gap_extend_del, opt.gap_open_ins,
                opt.gap_extend_ins, bonus, opt.zdrop, opt.match_score,
                -opt.mismatch_penalty)

    def align_batch(self, seqs: List[bytes]) -> List[List[AlnReg]]:
        """Candidate regions for a batch of reads (mem_align1_core xN),
        bit-identical to ``align1`` per read: the C++ session replays
        chain2aln while each wave of speculative extensions runs as K1 on
        resident inputs."""
        opt = self.opt
        qs = [encode_read(s) for s in seqs]
        nonempty = [q for q in qs if len(q)]
        seeded = self._device_seed(nonempty)
        if seeded is None:
            seeded = native_ops.collect_seeds_rbegs_batch(self.fm, nonempty,
                                                          opt)
        if seeded is None:
            raise RuntimeError("native seeding unavailable")
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
                t_wave = time.time()
                bonus = opt.pen_clip5 if sess.phase() == 0 else opt.pen_clip3
                (rid, qstart, qdir, qlen, tstart, tdir, tlen, h0, w,
                 Lq, Lt) = sess.wave_descs()
                desc = resident.pack_desc(rid, qstart, qdir, qlen, tstart,
                                          tdir, tlen, h0, w, l_pac)
                blocks, inv = self._split_wave(len(desc),
                                               np.count_nonzero(qlen))
                t_dev = time.time()
                outs = [resident.extend_wave_resident(
                    reads[dev], self._pac_resident(dev)[0], l_pac,
                    torch.from_numpy(desc if inv is None else desc[idx]).to(
                        dev), Lq=Lq, Lt=Lt, opt_key=self._opt_key(bonus))
                    for dev, idx in blocks if len(idx)]
                t_disp = time.time()
                rows = ksw.download_blocks(outs, inv, 1)   # (8, B)
                self._wave_done(time.time() - t_dev)
                if WAVE_TRACE:
                    _wtrace("ext", (len(qlen), Lq, Lt), t_dev - t_wave,
                            t_disp - t_dev, time.time() - t_disp,
                            desc.nbytes, rows.nbytes)
                sess.feed(rows[0], rows[1], rows[2], rows[3], rows[4],
                          rows[5])
                if WAVE_DEBUG:
                    _line(f"[wave] phase={sess.phase()} B={len(qlen)} "
                          f"q={Lq} t={Lt} {time.time() - t_wave:.2f}s")
            return sess.finish()
        finally:
            sess.close()

    def local_align_device(self, tasks):
        """Mate-rescue local SW for a whole batch as one two-pass K3 wave
        (a K3 call a block of the wave's split); bit-identical to per-task
        ksw.local_align."""
        self._check_abort()
        opt = self.opt
        t_dev = time.time()
        trace = {} if WAVE_TRACE else None
        out = ksw.local_align_batch(
            tasks, self.mat, opt.gap_open_del, opt.gap_extend_del,
            opt.gap_open_ins, opt.gap_extend_ins,
            opt.min_seed_len * opt.match_score, device=self.device,
            split_fn=self._split_wave, trace=trace)
        self._wave_done(time.time() - t_dev)
        if WAVE_TRACE:     # no DP task: a line of zeros, as the reference
            _wtrace("loc", (len(tasks),),
                    *(trace.get(k, 0) for k in ("build", "disp", "dl",
                                                "up", "dn")))
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
        per_pair = self._pairs_regions(recs)
        if score_delta is None:
            return per_pair
        pairs = [(encode_read(rec.read1), encode_read(rec.read2), r1, r2)
                 for rec, (r1, r2) in zip(recs, per_pair)]
        self.rescue_pairs_batch(pairs, score_delta,
                                local_align_fn=self.local_align_device)
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
        sras = self.reg2aln_batch(tasks) if tasks else []
        out = []
        off = 0
        for (r1, r2), (n1, n2) in zip(per_pair, counts):
            out.append((r1, r2, True, sras[off:off + n1],
                        sras[off + n1:off + n1 + n2]))
            off += n1 + n2
        return out

    def prime_pairs(self, recs, score_delta: int) -> None:
        """Candidate regions and mate rescue of many pairs on the device;
        caches each record's finished pair (keyed by ``id(rec)``) in
        ``_pair_cache``, which ``rfa.candidates.get_chains`` consumes."""
        per_pair = self._pairs_regions(recs)
        pairs = [(encode_read(rec.read1), encode_read(rec.read2), r1, r2)
                 for rec, (r1, r2) in zip(recs, per_pair)]
        self.rescue_pairs_batch(pairs, score_delta,
                                local_align_fn=self.local_align_device)
        cache = getattr(self, "_pair_cache", None)
        if cache is None:
            cache = self._pair_cache = {}
        for rec, (q1, q2, regs1, regs2) in zip(recs, pairs):
            cache[id(rec)] = self.finish_pair(q1, q2, regs1, regs2,
                                              score_delta, skip_rescue=True)

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
        ``reg2aln`` per task: chunked sessions (native/align1.cpp r2s_*)
        replay the w2 band ladder and the NM/clip finish while each wave
        runs as K2 + K2b. Every live chunk's wave is dispatched before any
        wave's results are downloaded."""
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
        opt = self.opt
        sess = st["sess"]
        t_fill = time.time()
        if st["reads_res"] is None:
            st["reads_res"] = self._replicas(
                resident.put_reads(st["reads"], "cpu").codes)
        l_pac = int(self.fm.l_pac)
        (rid, qstart, qdir, qlen, tstart, tdir, tlen, wv,
         Lq, Lt) = sess.wave_descs()
        desc = resident.pack_desc(rid, qstart, qdir, qlen, tstart, tdir,
                                  tlen, np.zeros_like(wv), wv, l_pac)
        blocks, inv = self._split_wave(len(desc), sess.pending())
        S = Lq + Lt
        t_build, t_disp = time.time() - t_fill, 0.0
        blobs = []
        for dev, idx in blocks:
            if not len(idx):
                continue
            t0 = time.time()
            desc_d = torch.from_numpy(
                desc if inv is None else desc[idx]).to(dev)
            q, t = resident.build_qt(st["reads_res"][dev],
                                     self._pac_resident(dev)[0], l_pac,
                                     desc_d, Lq=Lq, Lt=Lt)
            qlen_d, tlen_d, w_d = (desc_d[:, k].to(torch.int32).contiguous()
                                   for k in (resident.D_QL, resident.D_TL,
                                             resident.D_W))
            t1 = time.time()
            score, z = sw_global.global_batch(
                q, qlen_d, t, tlen_d, w_d, o_del=opt.gap_open_del,
                e_del=opt.gap_extend_del, o_ins=opt.gap_open_ins,
                e_ins=opt.gap_extend_ins, match_sc=opt.match_score,
                mismatch_sc=-opt.mismatch_penalty)
            blobs.append(sw_global.traceback_ops_fused(
                z, qlen_d, tlen_d, w_d, score, S=S))
            t_build += t1 - t0
            t_disp += time.time() - t1
        if WAVE_TRACE:
            _wtrace("r2a.d", (len(desc), Lq, Lt), t_build, t_disp, 0.0,
                    desc.nbytes, 0)
        return blobs, inv, S

    def _r2s_feed(self, st, handle) -> None:
        """Download a dispatched wave's blobs and feed the session."""
        blobs, inv, S = handle
        t_dl = time.time()
        blob = ksw.download_blocks(blobs, inv, 0)
        if WAVE_TRACE:
            _wtrace("r2a.f", (len(blob),), 0.0, 0.0, time.time() - t_dl, 0,
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
