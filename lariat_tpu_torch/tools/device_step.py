"""Throughput of the device align step on an index given by path.

    python -m lariat_tpu_torch.tools.device_step <genome.fa>     # needs CUDA
    python -m lariat_tpu_torch.tools.device_step <genome.fa> --device cpu \\
        --B 64 --L 60                                             # tests only

The port of bench.py ``_device_step_detail``. Reads: B (8,192) x L (151)
bases of ``fm.get_seq_codes`` at starts drawn from ``default_rng(7)``,
odd reads reverse complemented, each with one mutated base (the
reference's generator). ``align_step_smem`` (the reference's measured
step: K4b, K5's lookup entry, K1's step entry) and then ``align_step``
(K7 in place of K4b): one warm call, then the mean of 5 calls, the last
closed by a synchronise, and one more call with a ``StepClock`` for each
part's time inside the step (CUDA events on the card: ``exact_match`` or
``lanes``, ``min_starts`` and ``anchor_pick``, then ``sa_lookup``,
``orient`` -- the hits' strands and forward starts -- and
``fetch_extend``). Prints one JSON line: ``device_step_pairs_s`` (B / dt
/ 2, as the reference reckons it), ``device_step_ms``,
``device_step_mapped_frac``, the share of reads placed at their planted
start, the parts' ms, the same under ``exact_step_*`` for
``align_step``, and the kernels' launches. The index loads (or is built)
as the CLI's ``load_reference`` does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..align.ksw import fill_score_matrix
from ..device import get_device
from ..ops import _build
from ..ops.fm_batch import DeviceFMIndex
from ..parallel.align_step import (DeviceGenome, StepClock, align_step,
                                   align_step_smem)
from . import card, device_name

ITERS = 5


def step_reads(fm, B: int, L: int, seed: int = 7):
    """(reads (B, L) uint8, planted starts (B,)): bench.py's generator."""
    rng = np.random.default_rng(seed)
    codes = fm.get_seq_codes(0, fm.l_pac).copy()
    starts = rng.integers(0, fm.l_pac - L, B)
    reads = np.zeros((B, L), np.uint8)
    for i, pos in enumerate(starts):
        seg = codes[pos:pos + L].copy()
        if i % 2:
            seg = (3 - seg)[::-1]
        p = int(rng.integers(0, L))
        seg[p] = (seg[p] + 1) % 4
        reads[i] = seg
    return reads, starts


def measure(step, g, reads, lens, mat, starts, dev, prefix: str) -> dict:
    """One warm call, the mean of ``ITERS`` calls, then one call with a
    clock around each part."""
    res = step(g, reads, lens, mat)
    mapped = res.mapped.cpu().numpy()
    at_truth = (res.pos.cpu().numpy() == starts) & mapped

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        step(g, reads, lens, mat)
    sync()
    dt = (time.perf_counter() - t0) / ITERS
    clock = StepClock(dev)
    step(g, reads, lens, mat, clock=clock)
    B = reads.shape[0]
    return {f"{prefix}_pairs_s": B / dt / 2.0, f"{prefix}_ms": dt * 1e3,
            f"{prefix}_mapped_frac": float(mapped.mean()),
            f"{prefix}_at_truth_frac": float(at_truth.mean()),
            f"{prefix}_parts_ms": clock.ms()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("genome", help="FASTA whose index the CLI would load")
    p.add_argument("--device", default="cuda",
                   help="cuda (default); cpu only for tests")
    p.add_argument("--B", type=int, default=8192)
    p.add_argument("--L", type=int, default=151)
    args = p.parse_args(argv)
    dev = get_device(args.device)
    from ..cli import load_reference
    fm = load_reference(args.genome)
    reads_np, starts = step_reads(fm, args.B, args.L)
    fmd = DeviceFMIndex.from_host(fm, dev)
    g = DeviceGenome.from_host(fm, fmd)
    reads = torch.from_numpy(reads_np).to(dev)
    lens = torch.full((args.B,), args.L, dtype=torch.int32, device=dev)
    mat = fill_score_matrix(1, 4)
    _build.reset_launches()
    out = {"device": device_name(dev), "card": card(dev), "B": args.B,
           "L": args.L, "genome_bp": int(fm.l_pac),
           "idx_dtype": str(fmd.idx_dtype).replace("torch.", "")}
    out.update(measure(align_step_smem, g, reads, lens, mat, starts, dev,
                       "device_step"))
    out.update(measure(align_step, g, reads, lens, mat, starts, dev,
                       "exact_step"))
    out["launches"] = _build.launches()
    out["entry_launches"] = _build.entry_launches()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
