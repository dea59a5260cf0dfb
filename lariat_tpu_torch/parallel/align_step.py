"""The suffix-array walk of device seeding -- the part of
lariat_tpu/parallel/align_step.py that ``collect_seeds_rbegs_device`` runs:
``DeviceGenome``, K5 ``sa_walk_chunk`` (``csrc/sa_walk.cu``) with its plain
twin, and the two-phase host driver ``sa_lookup_batch_host``.

The exact-match search, the window fetch and the one-call align steps
(``align_step``, ``align_step_smem``) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional
import numpy as np
import torch

from ..ops import _build
from ..ops.fm_batch import DeviceFMIndex, lf_batch, lf_row


@dataclasses.dataclass
class DeviceGenome:
    """The device FM index (shared with the engine's seeding, not a second
    upload) and the SA sampling; the samples themselves stay on the host,
    where ``sa_lookup_batch_host`` adds them."""
    fmd: DeviceFMIndex
    sa_intv: int

    @classmethod
    def from_host(cls, fm, fmd: DeviceFMIndex) -> "DeviceGenome":
        return cls(fmd=fmd, sa_intv=int(fm.sa_intv))


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
                  max_steps, out)
    return out


def sa_lookup_batch_host(g: DeviceGenome, fm, rows: np.ndarray,
                         phase_steps: int = 64) -> np.ndarray:
    """SA positions of BWT rows, walked in two phases: every lane for
    ``phase_steps`` LF steps, then the unfinished few at a narrow width
    for the rest of 512; the sample add happens on the host."""
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

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    out = sa_walk_chunk(g, put(karr), put(np.zeros(npad, dt)),
                        put(np.zeros(npad, bool)), phase_steps).cpu().numpy()
    k, steps, done = out[0].copy(), out[1].copy(), out[2] != 0
    if not done.all():
        idx = np.nonzero(~done)[0]
        ns = 128
        while ns < len(idx):
            ns <<= 1
        ksub = np.zeros(ns, dt)
        ssub = np.zeros(ns, dt)
        dsub = np.ones(ns, bool)
        ksub[:len(idx)] = k[idx]
        ssub[:len(idx)] = steps[idx]
        dsub[:len(idx)] = False
        out2 = sa_walk_chunk(g, put(ksub), put(ssub), put(dsub),
                             512 - phase_steps).cpu().numpy()
        k[idx] = out2[0][:len(idx)]
        steps[idx] = out2[1][:len(idx)]
    sa = np.asarray(fm.sa_samples)
    return (sa[(k[:n] // fm.sa_intv).astype(np.int64)]
            + steps[:n].astype(np.int64))
