"""Measurement entry points of the port, each run as a module:

    python -m lariat_tpu_torch.tools.extend_ablate     T1 ablation timings
    python -m lariat_tpu_torch.tools.kernel_roofline   shares of peak
    python -m lariat_tpu_torch.tools.prime_profile <genome.fa> <reads.fq.gz>
    python -m lariat_tpu_torch.tools.device_step <genome.fa>  the align step

Each needs CUDA and refuses to run without it. For the tests, the
ablation and the align step take ``--device cpu`` and the profile
``LARIAT_TORCH_DEVICE=cpu`` (the roofline has no CPU mode): they then run
the plain twins on the CPU, and their times are the CPU's, labelled so.

The helpers below are shared by the tools and ``chip_smoke.py``.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, Optional

import torch


def median_ms(fn: Callable[[], object], device: torch.device,
              n: int = 7) -> float:
    """Median milliseconds of ``n`` calls of ``fn`` after one warm call:
    CUDA events around each call on the card, the host clock on the
    CPU."""
    fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(n):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize(device)
            times.append(a.elapsed_time(b))
    else:
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return times[len(times) // 2]


def card(device: torch.device) -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` for the device's card
    (None on the CPU)."""
    if device.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[device.index or 0] if out else None


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
