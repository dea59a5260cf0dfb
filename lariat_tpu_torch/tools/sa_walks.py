"""K5 (the SA walk) off the main path, for any tree of the port since device
seeding came in. Run by its path; it measures the ``lariat_tpu_torch`` that
PYTHONPATH puts first (``kernel_turns.py`` says how to unpack a parent):

    PYTHONPATH=<tree> python3 lariat_tpu_torch/tools/sa_walks.py \\
        profile <genome.fa> [rows,rows,...]
    PYTHONPATH=<tree> python3 lariat_tpu_torch/tools/sa_walks.py \\
        cli <lariat_tpu_torch.cli arguments>

- ``profile``: what sets K5's pace, from timed variants of its launch
  (``k5_profile``) on chip_smoke.py phase 5's 65,536 random rows, and,
  given the padded row counts of a CLI run's lookups, the one launch and
  the reference's two phases at those sizes (``lookup_shapes``).
- ``cli``: the CLI run with every ``align_step.sa_walk_chunk`` call logged
  as it ran: [rows, max_steps, longest walk (its steps output), walks
  past 64 steps] a launch. Trees that walk a lookup in two phases log two
  launches for it. The CLI picks the device (``LARIAT_TORCH_DEVICE=cpu``
  runs the twin).
Each prints, last, one JSON line; ``profile`` first prints the card.
"""

from __future__ import annotations

import json
import sys

import numpy as np

# the sibling script: this one is run by its path
from kernel_turns import events_ms, lookup_rows


def walk_shape(g, rows):
    """K5 on ``rows`` in device ms (``events_ms``): one launch of the whole
    budget (512 steps), and the reference's two phases (every row for 64
    steps; then the unfinished rows, padded to a power of two >= 128,
    resumed for 448) back to back, with the steps the walks took. Phase 1
    and phase 2 are also timed alone; phase 2 alone, repeated, finds its
    few rows in the L2, which it does not after phase 1."""
    import torch
    from lariat_tpu_torch.parallel import align_step
    dev, dt = g.fmd.device, g.fmd.idx_dtype
    k = torch.from_numpy(rows).to(dev, dt)
    z = torch.zeros_like(k)
    nd = torch.zeros(len(rows), dtype=torch.bool, device=dev)

    def walk(steps):
        return lambda: align_step.sa_walk_chunk(g, k, z, nd, steps)

    one = walk(64)()
    left = torch.nonzero(one[2] == 0)[:, 0]
    ns = 128
    while ns < len(left):
        ns <<= 1
    k2, s2 = (torch.zeros(ns, dtype=dt, device=dev) for _ in range(2))
    k2[:len(left)], s2[:len(left)] = one[0][left], one[1][left]
    d2 = torch.ones(ns, dtype=torch.bool, device=dev)
    d2[:len(left)] = False

    def phase2():
        return align_step.sa_walk_chunk(g, k2, s2, d2, 448)

    steps = walk(512)()[1].long()
    return {"rows": len(rows), "steps": int(steps.sum()),
            "longest": int(steps.max()),
            "one_launch_ms": events_ms(walk(512)),
            "two_phase_ms": events_ms(lambda: (walk(64)(), phase2())),
            "phase1_ms": events_ms(walk(64)), "phase2_rows": ns,
            "phase2_ms": events_ms(phase2)}


def lookup_shapes(g, fm, sizes):
    """``walk_shape`` at the lookup sizes a CLI run logged (rows padded),
    on random rows."""
    return [walk_shape(g, lookup_rows(fm.seq_len, n=m)) for m in sizes]


def k5_profile(g, fm, rows):
    """What sets K5's pace, from timed variants of its launch (no profiler
    reaches the card's counters), in device ms: ``walk_shape`` on ``rows``,
    and its phase-1 shape and whole budget again with a cold L2 (256 MB
    read between calls); 1,024 and 8,192 rows at 64 steps, warm and cold
    (a step's latency with few warps, and with half the card's; warm, their
    few rows stay in the L2); a launch of 0 steps;
    and, on the host clock, the whole call of a 0-step launch (the
    wrapper) and the lookup's host sample add. Returns a dict of ms and
    the walk lengths."""
    import time
    import torch
    from lariat_tpu_torch.parallel import align_step
    dev, dt = g.fmd.device, g.fmd.idx_dtype
    out = {f"k5_{k}": v for k, v in walk_shape(g, rows).items()}
    out["k5_us_per_step_longest"] = 1e3 * out["k5_one_launch_ms"] / max(
        out["k5_longest"], 1)
    k = torch.from_numpy(rows).to(dev, dt)
    z = torch.zeros_like(k)
    nd = torch.zeros(len(rows), dtype=torch.bool, device=dev)
    flush = torch.ones(1 << 26, dtype=torch.int32, device=dev)

    def walk(steps, m=len(rows)):
        return lambda: align_step.sa_walk_chunk(g, k[:m], z[:m], nd[:m],
                                                steps)

    for name, steps in (("phase1", 64), ("one_launch", 512)):
        out[f"k5_{name}_cold_ms"] = events_ms(walk(steps),
                                              prep=lambda: flush.max())
    for m in (1024, 8192):
        out[f"k5_rows{m}_ms"] = events_ms(walk(64, m))
        out[f"k5_rows{m}_cold_ms"] = events_ms(walk(64, m),
                                               prep=lambda: flush.max())
    out["k5_zero_ms"] = events_ms(walk(0))

    def host_ms(fn):
        t = []
        for _ in range(21):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            t.append((time.perf_counter() - t0) * 1e3)
        return sorted(t)[10]

    out["k5_zero_host_ms"] = host_ms(walk(0))
    full = walk(512)().cpu().numpy()
    sa = np.asarray(fm.sa_samples)
    out["sample_add_ms"] = host_ms(
        lambda: sa[(full[0] // fm.sa_intv).astype(np.int64)]
        + full[1].astype(np.int64))
    return out


def cli_launches(argv):
    """The CLI on ``argv`` with each K5 call logged -> (its exit code, the
    launches). The log's sync adds a little to each lookup."""
    from lariat_tpu_torch import cli
    from lariat_tpu_torch.parallel import align_step
    chunk = align_step.sa_walk_chunk
    log = []

    def logged(g, k, steps, done, max_steps):
        out = chunk(g, k, steps, done, max_steps)
        s = out[1]
        log.append([int(k.shape[0]), int(max_steps), int(s.max()),
                    int((s > 64).sum())])
        return out

    align_step.sa_walk_chunk = logged
    try:
        rc = cli.main(argv)
    finally:
        align_step.sa_walk_chunk = chunk
    return rc, log


def main(argv=None) -> int:
    import torch
    import lariat_tpu_torch
    from lariat_tpu_torch.tools import card
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in ("profile", "cli") or (
            argv[0] == "profile" and len(argv) not in (2, 3)):
        raise SystemExit("usage: sa_walks.py profile <genome.fa> "
                         "[rows,rows,...] | cli <CLI arguments>")
    if argv[0] == "cli":      # the CLI picks its device (and refuses)
        rc, log = cli_launches(argv[1:])
        print(json.dumps({"package": lariat_tpu_torch.__file__,
                          "sa_walk_launches": log}), flush=True)
        return rc
    if not torch.cuda.is_available():
        raise RuntimeError("sa_walks profile needs CUDA")
    from lariat_tpu_torch.cli import load_reference
    from lariat_tpu_torch.ops import fm_batch
    from lariat_tpu_torch.parallel import align_step
    dev = torch.device("cuda")
    out = {"package": lariat_tpu_torch.__file__, "card": card(dev)}
    print(out["card"], flush=True)
    fm = load_reference(argv[1])
    g = align_step.DeviceGenome.from_host(
        fm, fm_batch.DeviceFMIndex.from_host(fm, dev))
    out.update(k5_profile(g, fm, lookup_rows(fm.seq_len)))
    if len(argv) == 3:
        out["lookups"] = lookup_shapes(
            g, fm, [int(v) for v in argv[2].split(",")])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
