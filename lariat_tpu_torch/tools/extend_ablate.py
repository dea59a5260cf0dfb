"""Time the T1 ablation variants of the seed-extension kernel on the card.

    python -m lariat_tpu_torch.tools.extend_ablate            # the H100
    python -m lariat_tpu_torch.tools.extend_ablate --device cpu --B 256 \
        --Lq 32 --Lt 48                                        # tests only

The port of tools/extend_ablate.py ``main``: its inputs (seed 5, B 8192,
Lq 192, Lt 576; every lane qlen 151, tlen 400, w 100, h0 30; random
codes) and its variants baseline, no_cummax, no_trow, no_writeback,
minimal and rows_288 (Lt halved). Each variant's time is the median of
7 calls after one warm call, from CUDA events.

With these random inputs most lanes die under the z-drop test within a
few rows, so the times mostly measure how fast dead lanes exit;
``chip_smoke.py`` also times the variants on planted inputs.

T1 runs K1's wavefront body (a warp a task), so each variant also
reports its warp steps, summed over the tasks from the kernel's own count
(one more call with ``steps=``), and ns a warp step: ms x SMs / warp
steps, what one warp step costs an SM -- the figure to set beside K1's
(``chip_smoke.py`` phase 3). On the CPU (the twin, no schedule) both are
null.

Prints one JSON line per variant (ms, padded cells/s, warp steps, ns a
warp step), then a final JSON line with the device, its nvidia-smi name
and power limit, its SM count, and the T1 launches of the run (the step
counts' included).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..device import get_device
from ..ops import _build, extend_ablate
from . import card, device_name, median_ms


SEED, ITERS = 5, 7


def inputs(B: int, Lq: int, Lt: int, device: torch.device):
    """The JAX tool's inputs: random codes from seed 5, qlen 151 (capped at
    Lq), tlen 400, w 100, h0 30 -> (q, t, params) tensors on ``device``."""
    rng = np.random.default_rng(SEED)
    q = rng.integers(0, 4, (B, Lq)).astype(np.int32)
    t = rng.integers(0, 4, (B, Lt)).astype(np.int32)
    params = np.zeros((B, 8), np.int32)
    params[:, 0] = min(151, Lq)
    params[:, 1] = 400
    params[:, 2] = 100
    params[:, 3] = 30
    return [torch.from_numpy(a).to(device) for a in (q, t, params)]


def warp_steps(q, t, params, Lt: int, **kw) -> int:
    """The warp steps one call of T1 runs, summed over its tasks (the
    kernel's count; a CUDA device)."""
    st = torch.full((q.shape[0],), -1, dtype=torch.int32, device=q.device)
    extend_ablate.run_variant(q, t, params, Lt, steps=st, **kw)
    n = st.long()
    if int(n.min()) < 0:
        raise RuntimeError("T1 left a task's warp steps uncounted")
    return int(n.sum())


def ns_per_warp_step(ms: float, steps: int, sm_count: int) -> float:
    """ms x SMs / warp steps, in ns: what one warp step costs an SM."""
    return ms * 1e6 * sm_count / steps


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu (plain twins, tests)")
    p.add_argument("--B", type=int, default=8192)
    p.add_argument("--Lq", type=int, default=192)
    p.add_argument("--Lt", type=int, default=576)
    args = p.parse_args(argv)
    dev = get_device(args.device)
    q, t, params = inputs(args.B, args.Lq, args.Lt, dev)
    cuda = dev.type == "cuda"
    sms = torch.cuda.get_device_properties(dev).multi_processor_count \
        if cuda else None
    _build.reset_launches()
    for name, (half, kw) in extend_ablate.VARIANTS.items():
        Lt = args.Lt // 2 if half else args.Lt
        steps = warp_steps(q, t, params, Lt, **kw) if cuda else None
        ms = median_ms(lambda: extend_ablate.run_variant(q, t, params, Lt,
                                                         **kw),
                       dev, ITERS)
        print(json.dumps({"variant": name, "Lt": Lt, "ms": ms,
                          "padded_cells_per_s":
                              args.B * args.Lq * Lt / (ms * 1e-3),
                          "warp_steps": steps,
                          "ns_per_warp_step": ns_per_warp_step(ms, steps, sms)
                          if cuda else None}),
              flush=True)
    print(json.dumps({
        "device": device_name(dev), "card": card(dev), "sm_count": sms,
        "B": args.B, "Lq": args.Lq, "Lt": args.Lt, "seed": SEED,
        "timing": f"median of {ITERS} after one warm call",
        "launches": {"extend_ablate": _build.launches()["extend_ablate"]}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
