"""Probe of the card's fixed costs: the port of tools/probe_device.py.

    python -m lariat_tpu_torch.tools.probe_device            # needs CUDA
    python -m lariat_tpu_torch.tools.probe_device --device cpu \\
        --kernel-B 8,16 --plain-B 8                          # tests only

Prints progressive JSON lines (flushed), one a probe:
  - ``device``: the device and the card's nvidia-smi name and power limit;
  - ``launch_trivial``: a trivial op (``x + 1`` on 1,024 int32) plus
    ``torch.cuda.synchronize()``, first call and per call;
  - ``download_8MB`` / ``upload_8MB``, pageable and pinned host memory
    (each the median of 5 copies, the first one also given);
  - ``k1_B<B>``: K1's hand-written kernel through ``ops/sw_extend.
    extend_batch`` at B = 128 and 1,024, Lq 192, Lt 576 (every task qlen
    151, tlen 400, w 100, h0 30, random codes of seed 5): per call and per
    row step of the target;
  - ``k1_plain_B<B>``: K1's plain twin (``ops/sw_batch.extend_batch``) at
    B = 1,024 and 8,192 on the same inputs, with useful cells/s (B x 151 x
    400 over the call).
Every call is synchronised before the next, so asynchronous launches
cannot pipeline the loop and understate a call's latency. On the CPU only
the K1 probes run (through the twin), at the sizes given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..device import get_device
from ..ops import _build, sw_batch, sw_extend
from . import card, device_name

LQ, LT = 192, 576
QLEN, TLEN, W, H0 = 151, 400, 100, 30
MB8 = 2 * 1024 * 1024   # int32 elements in 8 MB


def emit(name: str, **kw) -> None:
    print(json.dumps({"probe": name, **kw}), flush=True)


def timeit(fn, dev: torch.device, iters: int = 3):
    """(first call s, per call s), synchronising after every call."""
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    fn()
    sync()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        sync()
    return first, (time.perf_counter() - t0) / iters


def _copies(src_fn, dev: torch.device, n: int = 5):
    """(first copy s, median of n copies s)."""
    times = []
    for _ in range(n + 1):
        t0 = time.perf_counter()
        src_fn()
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    rest = sorted(times[1:])
    return times[0], rest[len(rest) // 2]


def transfers(dev: torch.device) -> None:
    big = torch.full((MB8,), 7, dtype=torch.int32, device=dev)
    for pinned in (False, True):
        kind = "pinned" if pinned else "pageable"
        host = torch.empty((MB8,), dtype=torch.int32, pin_memory=pinned)
        first, s = _copies(lambda: host.copy_(big, non_blocking=pinned),
                           dev)
        emit("download_8MB", memory=kind, first_s=round(first, 6),
             s=round(s, 6), MB_s=round(8 / max(s, 1e-9), 1))
        host.fill_(3)
        first, s = _copies(lambda: big.copy_(host, non_blocking=pinned), dev)
        emit("upload_8MB", memory=kind, first_s=round(first, 6),
             s=round(s, 6), MB_s=round(8 / max(s, 1e-9), 1))


def k1_inputs(B: int, dev: torch.device, seed: int = 5):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(0, 4, (B, LQ)).astype(np.int32))
    t = torch.from_numpy(rng.integers(0, 4, (B, LT)).astype(np.int32))
    full = [torch.full((B,), v, dtype=torch.int32)
            for v in (QLEN, TLEN, W, H0)]
    return [x.to(dev) for x in (q, t, *full)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu (the twins, tests)")
    p.add_argument("--kernel-B", default="128,1024")
    p.add_argument("--plain-B", default="1024,8192")
    args = p.parse_args(argv)
    dev = get_device(args.device)
    emit("device", dev=device_name(dev), card=card(dev))
    if dev.type == "cuda":
        _build.load()
        x = torch.arange(1024, dtype=torch.int32, device=dev)
        first, dt = timeit(lambda: x + 1, dev, iters=10)
        emit("launch_trivial", first_call_s=round(first, 4),
             per_call_ms=round(dt * 1e3, 4))
        transfers(dev)
    _build.reset_launches()
    for B in (int(v) for v in args.kernel_B.split(",")):
        q, t, qlen, tlen, w, h0 = k1_inputs(B, dev)
        first, dt = timeit(
            lambda: sw_extend.extend_batch(q, qlen, t, tlen, w, h0), dev)
        emit(f"k1_B{B}", first_call_s=round(first, 3),
             per_call_ms=round(dt * 1e3, 4),
             per_row_step_us=round(dt / LT * 1e6, 4))
    mat = sw_extend.score_matrix(1, -4, -1, device=dev)
    for B in (int(v) for v in args.plain_B.split(",")):
        q, t, qlen, tlen, w, h0 = k1_inputs(B, dev)
        first, dt = timeit(lambda: sw_batch.extend_batch(
            q, qlen, t, tlen, mat, w, h0, packed=True), dev)
        emit(f"k1_plain_B{B}", first_call_s=round(first, 3),
             per_call_ms=round(dt * 1e3, 3),
             useful_cells_per_s=round(B * QLEN * TLEN / dt))
    emit("launches", **_build.launches())
    return 0


if __name__ == "__main__":
    sys.exit(main())
