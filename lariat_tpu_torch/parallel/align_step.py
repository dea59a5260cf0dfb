"""The suffix-array walk of device seeding -- the part of
lariat_tpu/parallel/align_step.py that ``collect_seeds_rbegs_device`` runs:
``DeviceGenome``, K5 ``sa_walk_chunk`` (``csrc/sa_walk.cu``) with its plain
twin, and the host function ``sa_lookup_batch_host``, which walks a lookup's
rows in one launch.

The exact-match search, the window fetch and the one-call align steps
(``align_step``, ``align_step_smem``) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional
import numpy as np
import torch

from ..ops import _build
from ..ops.fm_batch import DeviceFMIndex, lf_batch, lf_row


# LF steps a lookup allows a walk (the reference's 64 + 448); a walk of
# sa_intv 32 outlives it with odds (31/32)**512, about 1e-7
LOOKUP_STEPS = 512
# lookups a DeviceGenome logs; later ones go unlogged
WALK_LOG_CAP = 1024


@dataclasses.dataclass
class DeviceGenome:
    """The device FM index (shared with the engine's seeding, not a second
    upload) and the SA sampling; the samples themselves stay on the host,
    where ``sa_lookup_batch_host`` adds them. ``walks`` logs the first
    ``WALK_LOG_CAP`` lookups' K5 launches on the card: rows (padded),
    max_steps, the longest walk's steps and the walks longer than 64
    steps."""
    fmd: DeviceFMIndex
    sa_intv: int
    walks: List[dict] = dataclasses.field(default_factory=list)

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
