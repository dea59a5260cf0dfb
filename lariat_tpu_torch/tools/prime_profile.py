"""Profile the device-priming stages of the port over one group of pairs.

    python -m lariat_tpu_torch.tools.prime_profile <genome.fa> \
        <reads.fastq.gz> [n_pairs]

The port of tools/prime_profile.py: the stages the CLI's priming threads
run, each timed on the host clock and closed with
``torch.cuda.synchronize()`` so its wall includes its device work:
seeding by the seeder the engine picks (its ``_device_seed``, K4a-K4c and
K5, or host C++ when that declines: ``LARIAT_DEVICE_SEED`` and the
genome size decide, as in the CLI), ``align_batch`` (the Align1Session
and its K1 waves, seeding again inside it), and mate rescue through
``local_align_device`` (K3). A device seeder's index upload runs first
and is timed apart (``index_upload_s``). After the three stages, warm:
the seeding once more (``seed_warm_s``); for a device seeder on CUDA, one
more seeding call under ``torch.profiler`` (``seed_profile``: its wall,
the device time of its kernels and copies, by name, and the host share of
the wall); and the whole priming pass, ``prime_regions`` in this one
thread over the pairs in batches of 1,000, three times (``prime_s``,
each pass's wall; ``prime_pairs_per_s`` at their median; it runs the
reg2aln waves, K2 and K2b, too, which the three stages leave out as the
JAX tool's do). Prints the stage walls, pairs/s, the engine's wave counts
(a device seeding call is one wave, so ``extend_waves`` counts
``align_batch``'s own seeding too) and the kernel launch counts, then one
JSON line of the same figures, ``"seeder": "host"|"device"`` among them.

The device is ``$LARIAT_TORCH_DEVICE``, else cuda: the tool refuses to
run without CUDA unless the CPU is asked for (LARIAT_TORCH_DEVICE=cpu).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from ..align.batch_engine import TorchBatchAlignmentEngine
from ..align.engine import encode_read
from ..cli import load_reference
from ..config import RFAConfig
from ..device import describe, get_device
from ..index import native_ops
from ..io.fastq import FastQReader
from ..ops import _build
from . import card, device_name


PRIME_BATCH, PRIME_REPEATS = 1000, 3


def seed_profile(seed) -> dict:
    """One call of ``seed`` under torch.profiler: its wall (ms), the
    summed device time of the kernels and copies it ran (ms, in all and by
    name) and the share of the wall that is not device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from .kernel_turns import short_kernel_name
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = seed() * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = short_kernel_name(e.name)
            by_name[name] = by_name.get(name, 0.0) + \
                e.time_range.elapsed_us() / 1e3
    device_ms = sum(by_name.values())
    if device_ms <= 0:
        raise RuntimeError("torch.profiler saw no device time in a device "
                           "seeding call")
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "host_share": 1 - device_ms / wall_ms,
            "by_name": dict(sorted(by_name.items(), key=lambda kv: -kv[1]))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("genome")
    p.add_argument("reads")
    p.add_argument("n_pairs", nargs="?", type=int, default=2000)
    args = p.parse_args(argv)
    dev = get_device()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.time()
    fm = load_reference(args.genome)
    t_index = time.time() - t0
    print(f"index load: {t_index:.1f}s")
    reader = FastQReader(args.reads)
    recs = []
    while len(recs) < args.n_pairs:
        reads, _ = reader.read_barcode_set(0)
        if reads is None:
            break
        recs.extend(reads)
    print(f"pairs: {len(recs)}")
    config = RFAConfig()
    eng = TorchBatchAlignmentEngine(fm, device=dev)
    print(f"device: {describe(eng.device)}")
    seqs = [s for rec in recs for s in (rec.read1, rec.read2)]
    qs = [encode_read(s) for s in seqs]
    nonempty = [q for q in qs if len(q)]
    seeder = "device" if eng.device_seeding() else "host"
    t_upload = 0.0
    if seeder == "device":
        t0 = time.time()
        eng._seed_index()
        t_upload = time.time() - t0
        print(f"device seeding index upload: {t_upload:.2f}s")
    _build.reset_launches()

    def seed():
        t0 = time.time()
        if eng._device_seed(nonempty) is None:
            native_ops.collect_seeds_rbegs_batch(fm, nonempty, eng.opt)
        sync()
        return time.time() - t0

    t_seed = seed()
    seed_waves = eng.wave_stats["n"]
    print(f"seeding ({seeder}): {t_seed:.2f}s")

    t0 = time.time()
    regs = eng.align_batch(seqs)
    sync()
    t_align = time.time() - t0
    ext_waves = eng.wave_stats["n"] - seed_waves
    print(f"align_batch (session + device waves): {t_align:.2f}s, "
          f"{ext_waves} waves")

    pairs = [(qs[2 * i], qs[2 * i + 1], regs[2 * i], regs[2 * i + 1])
             for i in range(len(recs))]
    t0 = time.time()
    eng.rescue_pairs_batch(pairs, config.chain_score_delta,
                           local_align_fn=eng.local_align_device)
    sync()
    t_rescue = time.time() - t0
    rescue_waves = eng.wave_stats["n"] - seed_waves - ext_waves
    print(f"rescue (device local SW): {t_rescue:.2f}s, {rescue_waves} waves")

    total = t_seed + t_align + t_rescue
    rate = len(recs) / max(total, 1e-9)
    print(f"total: {total:.2f}s = {rate:.1f} pairs/s priming")
    # the stages above are first calls; seeding again shows its warm cost
    t_seed_warm = seed()
    print(f"seeding again ({seeder}, warm): {t_seed_warm:.2f}s")
    split = None
    if seeder == "device" and dev.type == "cuda":
        split = seed_profile(seed)
        print(f"device seeding under torch.profiler: {json.dumps(split)}")
    t_prime = []
    for _ in range(PRIME_REPEATS):
        t0 = time.time()
        for i in range(0, len(recs), PRIME_BATCH):
            eng.prime_regions(recs[i:i + PRIME_BATCH],
                              config.chain_score_delta)
        sync()
        t_prime.append(time.time() - t0)
    prime_rate = len(recs) / max(statistics.median(t_prime), 1e-9)
    print(f"prime_regions, one thread, batches of {PRIME_BATCH}: "
          f"{', '.join(f'{t:.3f}' for t in t_prime)} s; median "
          f"{prime_rate:.1f} pairs/s")
    launches = _build.launches()
    print(f"kernel launches: {json.dumps(launches)}")
    print(json.dumps({
        "device": device_name(dev), "card": card(dev), "pairs": len(recs),
        "seeder": seeder, "index_load_s": t_index,
        "index_upload_s": t_upload, "seed_s": t_seed,
        "seed_warm_s": t_seed_warm, "align_s": t_align,
        "rescue_s": t_rescue, "total_s": total, "pairs_per_s": rate,
        "seed_profile": split, "prime_s": t_prime,
        "prime_pairs_per_s": prime_rate,
        "extend_waves": ext_waves, "rescue_waves": rescue_waves,
        "wave_wall_s": eng.wave_stats["wall"], "launches": launches}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
