"""Profile the device-priming stages of the port over one group of pairs.

    python -m lariat_tpu_torch.tools.prime_profile <genome.fa> \
        <reads.fastq.gz> [n_pairs]

The port of tools/prime_profile.py: the stages the CLI's priming threads
run, each timed on the host clock and closed with
``torch.cuda.synchronize()`` so its wall includes its device work: host
C++ seeding, ``align_batch`` (the Align1Session and its K1 waves, seeding
again inside it), and mate rescue through ``local_align_device`` (K3). The
reg2aln waves (K2, K2b) run in ``prime_regions``, not here, as in the JAX
tool. Prints the stage walls, pairs/s, the engine's wave counts and the
kernel launch counts, then one JSON line of the same figures.

The device is ``$LARIAT_TORCH_DEVICE``, else cuda: the tool refuses to
run without CUDA unless the CPU is asked for (LARIAT_TORCH_DEVICE=cpu).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from lariat_tpu.align.engine import encode_read
from lariat_tpu.cli import load_reference
from lariat_tpu.config import RFAConfig
from lariat_tpu.index import native_ops
from lariat_tpu.io.fastq import FastQReader

from ..align.batch_engine import TorchBatchAlignmentEngine
from ..device import describe, get_device
from ..ops import _build
from . import card, device_name


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
    _build.reset_launches()

    t0 = time.time()
    native_ops.collect_seeds_rbegs_batch(fm, [q for q in qs if len(q)],
                                         eng.opt)
    t_seed = time.time() - t0
    print(f"seeding (host C++): {t_seed:.2f}s")

    t0 = time.time()
    regs = eng.align_batch(seqs)
    sync()
    t_align = time.time() - t0
    ext_waves = eng.wave_stats["n"]
    print(f"align_batch (session + device waves): {t_align:.2f}s, "
          f"{ext_waves} waves")

    pairs = [(qs[2 * i], qs[2 * i + 1], regs[2 * i], regs[2 * i + 1])
             for i in range(len(recs))]
    t0 = time.time()
    eng.rescue_pairs_batch(pairs, config.chain_score_delta,
                           local_align_fn=eng.local_align_device)
    sync()
    t_rescue = time.time() - t0
    print(f"rescue (device local SW): {t_rescue:.2f}s, "
          f"{eng.wave_stats['n'] - ext_waves} waves")

    total = t_seed + t_align + t_rescue
    rate = len(recs) / max(total, 1e-9)
    print(f"total: {total:.2f}s = {rate:.1f} pairs/s priming")
    launches = _build.launches()
    print(f"kernel launches: {json.dumps(launches)}")
    print(json.dumps({
        "device": device_name(dev), "card": card(dev), "pairs": len(recs),
        "index_load_s": t_index, "seed_s": t_seed, "align_s": t_align,
        "rescue_s": t_rescue, "total_s": total, "pairs_per_s": rate,
        "extend_waves": ext_waves,
        "rescue_waves": eng.wave_stats["n"] - ext_waves,
        "wave_wall_s": eng.wave_stats["wall"], "launches": launches}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
