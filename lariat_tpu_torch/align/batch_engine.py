"""The batch alignment engine on PyTorch: every DP wave of the priming pass
runs through the port's kernels.

``TorchBatchAlignmentEngine`` subclasses lariat_tpu's
``BatchAlignmentEngine`` and overrides each method that reaches JAX; the
C++ sessions (native/align1.cpp ``a1s_*`` / ``r2s_*``) replay BWA-MEM's
sequential control flow between waves exactly as in the reference:

  seed extension  ``_align_batch_session``  resident gather + K1
  mate rescue     ``local_align_device``     two-pass K3
  reg2aln         ``_r2s_dispatch``/``_feed`` K2, then K2b's backtrack

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
from typing import List, Optional

import numpy as np
import torch

from lariat_tpu.align import native_engine
from lariat_tpu.align.batch_engine import BatchAlignmentEngine
from lariat_tpu.align.engine import AlignmentEngine, encode_read
from lariat_tpu.align.extension import AlnReg
from lariat_tpu.index import native_ops

from ..device import get_device
from ..ops import _build, fm_batch, resident, smem_device, sw_global
from ..parallel import align_step
from . import ksw as tksw


class TorchBatchAlignmentEngine(BatchAlignmentEngine):
    """Drop-in engine whose DP waves run as the port's kernels on
    ``device`` (``lariat_tpu_torch.device.get_device`` picks it)."""

    def __init__(self, fm, opt=None, pair=None, device=None):
        # BatchAlignmentEngine.__init__ probes jax and starts a thread that
        # imports it: set its fields here instead
        AlignmentEngine.__init__(self, fm, opt, pair)
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
        self.device = get_device(device)
        if self.device.type == "cuda":
            _build.load()           # build the kernels now, not mid-wave
        self.use_pallas = False     # no Pallas here: the tensors' device
        self.mesh = None            # picks kernel or plain twin
        self.shard_waves = 0
        self.shard_log: list = []
        self.wave_stats = {"wall": 0.0, "n": 0}
        self._stats_lock = threading.Lock()
        self._pac_lock = threading.Lock()
        self._pac_res = None
        self.abort_prime = False
        self._warmup = None
        self._seed_lock = threading.Lock()
        self._seed_state = None     # (DeviceFMIndex, DeviceGenome)

    def wait_warmup(self) -> None:
        """No transfer warmup on this backend."""

    def _wave_done(self, seconds: float, n: int = 1) -> None:
        # the inherited reg2aln driver (_reg2aln_session) adds to
        # wave_stats without this lock, as the reference engine does
        with self._stats_lock:
            self.wave_stats["wall"] += seconds
            self.wave_stats["n"] += n

    def _pac_resident(self):
        """(pac_words tensor on the device, l_pac), uploaded once and shared
        by every resident-fed wave."""
        with self._pac_lock:
            if self._pac_res is None:
                self._pac_res = (
                    resident.pac_words_from_fm(self.fm, self.device),
                    int(self.fm.l_pac))
            return self._pac_res

    def _shard_wave(self, *arrays, real=None):
        if self.mesh is not None:
            raise NotImplementedError("multi-device waves are not ported")
        return arrays, None

    def _seed_index(self):
        """The device index for seeding, uploaded once, at first use, by
        the first batch that needs it; an upload error raises."""
        with self._seed_lock:
            if self._seed_state is None:
                fmd = fm_batch.DeviceFMIndex.from_host(self.fm, self.device)
                # the SA walk shares the seeding index: one copy on the device
                dg = align_step.DeviceGenome.from_host(self.fm, fmd)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                self._seed_state = (fmd, dg)
            return self._seed_state

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

    def _align_batch_session(self, seqs: List[bytes]
                             ) -> Optional[List[List[AlnReg]]]:
        """Seed extension: the C++ session replays chain2aln while each
        wave of speculative extensions runs as K1 on resident inputs."""
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
            reads = resident.put_reads(qs, self.device).codes
            pac_words, l_pac = self._pac_resident()
            while sess.pending():
                self._check_abort()
                bonus = opt.pen_clip5 if sess.phase() == 0 else opt.pen_clip3
                (rid, qstart, qdir, qlen, tstart, tdir, tlen, h0, w,
                 Lq, Lt) = sess.wave_descs()
                desc = resident.pack_desc(rid, qstart, qdir, qlen, tstart,
                                          tdir, tlen, h0, w, l_pac)
                t_dev = time.time()
                res = resident.extend_wave_resident(
                    reads, pac_words, l_pac,
                    torch.from_numpy(desc).to(self.device), Lq=Lq, Lt=Lt,
                    opt_key=self._opt_key(bonus))
                rows = res.cpu().numpy()     # one download per wave: (8, B)
                self._wave_done(time.time() - t_dev)
                sess.feed(rows[0], rows[1], rows[2], rows[3], rows[4],
                          rows[5])
            return sess.finish()
        finally:
            sess.close()

    def _align_batch_python(self, seqs):
        raise NotImplementedError(
            "lariat_tpu_torch runs the native Align1Session only")

    def _reg2aln_python(self, tasks):
        raise NotImplementedError(
            "lariat_tpu_torch runs the native Reg2AlnSession only")

    def local_align_device(self, tasks):
        """Mate-rescue local SW for a whole batch as one two-pass K3 wave;
        bit-identical to per-task ksw.local_align."""
        self._check_abort()
        opt = self.opt
        t_dev = time.time()
        out = tksw.local_align_batch(
            tasks, self.mat, opt.gap_open_del, opt.gap_extend_del,
            opt.gap_open_ins, opt.gap_extend_ins,
            opt.min_seed_len * opt.match_score, device=self.device)
        self._wave_done(time.time() - t_dev)
        return out

    def _r2s_dispatch(self, st):
        """Launch one reg2aln wave (K2 + K2b) for a session; returns the
        blob, still on the device, and its op count S."""
        opt = self.opt
        sess = st["sess"]
        if st["reads_res"] is None:
            st["reads_res"] = resident.put_reads(st["reads"], self.device)
        pac_words, l_pac = self._pac_resident()
        (rid, qstart, qdir, qlen, tstart, tdir, tlen, wv,
         Lq, Lt) = sess.wave_descs()
        desc = resident.pack_desc(rid, qstart, qdir, qlen, tstart, tdir,
                                  tlen, np.zeros_like(wv), wv, l_pac)
        desc_d = torch.from_numpy(desc).to(self.device)
        q, t = resident.build_qt(st["reads_res"].codes, pac_words, l_pac,
                                 desc_d, Lq=Lq, Lt=Lt)
        qlen_d, tlen_d, w_d = (desc_d[:, k].to(torch.int32).contiguous()
                               for k in (resident.D_QL, resident.D_TL,
                                         resident.D_W))
        score, z = sw_global.global_batch(
            q, qlen_d, t, tlen_d, w_d, o_del=opt.gap_open_del,
            e_del=opt.gap_extend_del, o_ins=opt.gap_open_ins,
            e_ins=opt.gap_extend_ins, match_sc=opt.match_score,
            mismatch_sc=-opt.mismatch_penalty)
        S = Lq + Lt
        blob = sw_global.traceback_ops_fused(z, qlen_d, tlen_d, w_d, score,
                                             S=S)
        return blob, S

    def _r2s_feed(self, st, handle) -> None:
        """Download a dispatched wave's blob and feed the session."""
        blob_d, S = handle
        blob = blob_d.cpu().numpy()
        packed, score, i_fin, k_fin = sw_global.split_traceback_blob(blob, S)
        cig_mat, nops = sw_global.cigars_from_ops_packed(packed, i_fin,
                                                         k_fin, S)
        st["sess"].feed(score, cig_mat, nops)
