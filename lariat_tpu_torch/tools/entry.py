"""The one-call device step with example arguments, and the multi-device
dry run: the port of ``__graft_entry__.py`` ``entry()`` and
``dryrun_multichip``.

    from lariat_tpu_torch.tools.entry import entry, dryrun_multichip
    fn, args = entry()            # the card; entry("cpu"): the plain twins
    result = fn(*args)            # an align_step.AlignStepResult
    dryrun_multichip(4)           # the first 4 cards; raises with fewer
    dryrun_multichip(4, ["cuda:0"] * 4)   # a 4-way split on one card
    dryrun_multichip(2, ["cpu"] * 2)      # the plain twins, as the tests

``entry`` builds a 20 kb synthetic genome's index with the port's own
``index.fmindex``, puts it on the device (``DeviceFMIndex``,
``DeviceGenome``) and returns ``align_step_smem`` -- round-1 SMEM seeding
by K4b, the SA lookup on the card (K5's lookup entry), then K1's step
entry: reads oriented in place, each window staged from the pac, banded
extension -- with 64 reads x 100 bp drawn from that genome (odd draws
reverse complemented, one substitution each), their lengths and bwa's
scoring matrix. On a CPU device every kernel wrapper runs its plain twin.

``dryrun_multichip`` runs the priming path (seeding, extension waves, mate
rescue, reg2aln waves, then RFA and BAM packing) twice over the
reference's inputs -- a 1.2 Mb toy genome, 64 barcodes x 32 pairs primed in
four groups -- once on one device and once with every wave split over the
given devices, and asserts the packed records bit-identical, at least 16
split waves and no device holding more than twice another's real tasks.
The reference's two-process distributed test, which its dry run also
runs, is covered by ``chip_smoke.py``'s multihost phase and
``tests/test_torch_multihost.py``.
"""

from __future__ import annotations

import os
import struct
import tempfile
import time

import numpy as np
import torch

from ..align.ksw import fill_score_matrix
from ..device import get_device
from ..index import fmindex
from ..io.fastq import FastQRecord
from ..ops import _build
from ..ops.fm_batch import DeviceFMIndex
from ..parallel.align_step import DeviceGenome, align_step_smem


def toy_genome(n: int = 20000, seed: int = 3):
    """(FMIndex, genome bytes): a random genome of ``n`` bases, its index
    built from a FASTA in a temporary directory that is removed after."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    g = bases[rng.integers(0, 4, n)]
    with tempfile.TemporaryDirectory(prefix="lariat_entry_") as d:
        path = os.path.join(d, "toy.fa")
        with open(path, "w") as f:
            s = g.tobytes().decode()
            f.write(">chrT\n")
            for i in range(0, len(s), 70):
                f.write(s[i:i + 70] + "\n")
        fm = fmindex.build_index(path)
    return fm, g.tobytes()


def make_reads(genome_codes: np.ndarray, batch: int, length: int,
               seed: int = 5):
    """(reads (batch, length) uint8 codes, lens): the reference's draws."""
    rng = np.random.default_rng(seed)
    reads = np.zeros((batch, length), np.uint8)
    lens = np.full(batch, length, np.int32)
    for i in range(batch):
        pos = int(rng.integers(0, len(genome_codes) - length))
        seg = genome_codes[pos:pos + length].copy()
        if rng.integers(0, 2):
            seg = (3 - seg)[::-1]
        p = int(rng.integers(0, length // 2))
        seg[p] = (seg[p] + 1) % 4
        reads[i] = seg
    return reads, lens


def entry(device=None):
    """(fn, example_args): ``align_step_smem`` and (genome, reads, lens,
    mat) on ``device`` (the card unless the caller asks for the CPU)."""
    dev = get_device(device)
    fm, g = toy_genome()
    codes = fmindex.NT4_TABLE[np.frombuffer(g, dtype=np.uint8)]
    dg = DeviceGenome.from_host(fm, DeviceFMIndex.from_host(fm, dev))
    reads, lens = make_reads(codes, batch=64, length=100)
    mat = fill_score_matrix(1, 4)

    def fn(genome, reads, lens, mat):
        return align_step_smem(genome, reads, lens, mat)

    return fn, (dg, torch.from_numpy(reads).to(dev),
                torch.from_numpy(lens).to(dev), mat)


def sim_pairs(genome: bytes, n_bcs: int = 64, pairs_per_bc: int = 32,
              seed: int = 11):
    """Barcode-grouped FastQRecords with proper-pair geometry (the
    reference's ``_sim_pairs``): a quarter of the read 1s carry a small
    deletion, so reg2aln's global waves run, and a quarter of the pairs
    have their mate far on the same strand, so rescue windows survive and
    the local waves run."""
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    sets = []
    for b in range(n_bcs):
        bc = bases[rng.integers(0, 4, 14)].tobytes().decode() + "-1"
        recs = []
        for i in range(pairs_per_bc):
            pos = int(rng.integers(100, len(genome) - 2000))
            ins = int(rng.integers(220, 320))
            r1 = bytearray(genome[pos:pos + 100])
            r1[int(rng.integers(0, 100))] = b"ACGT"[int(rng.integers(0, 4))]
            kind = int(rng.integers(0, 4))
            if kind == 0:
                cut = int(rng.integers(20, 80))
                dl = int(rng.integers(1, 5))
                r1 = bytearray(genome[pos:pos + cut]) + bytearray(
                    genome[pos + cut + dl:pos + 100 + dl])
            r2 = genome[pos + ins - 100:pos + ins].translate(comp)[::-1]
            if kind == 1:
                far = int(rng.integers(500, 1500))
                r2 = genome[pos + far:pos + far + 100]
            q = b"I" * 100
            recs.append(FastQRecord(
                read1=bytes(r1), read_qual1=q, read2=bytes(r2),
                read_qual2=q,
                barcode10x=bc.encode(), barcode10x_qual=b"J" * 14,
                raw_barcode10x=bc.split("-")[0].encode(),
                barcode=b"ACGTACGT", barcode_qual=b"IIIIIIII",
                read_info=f"dr:{b}:{i} x"))
        sets.append(recs)
    return sets


def prime_groups(engine, barcode_sets, cfg) -> list:
    """Prime the barcode sets through ``engine`` in four groups (the CLI's
    ``_prime_group``, so the wave schedule repeats as the CLI's batched
    feed makes it): one (reads, unique, primes) work item a barcode."""
    from ..cli import _prime_group
    step = max(1, len(barcode_sets) // 4)
    primed = []
    for s in range(0, len(barcode_sets), step):
        part = barcode_sets[s:s + step]
        primed.extend(_prime_group(engine, [(recs, True) for recs in part],
                                   cfg))
    return primed


def pack_primed(engine, fm, primed, cfg) -> list:
    """RFA and BAM packing of primed work items in this process
    (``host_pipeline._run_one``): one PackedBarcode each."""
    from ..parallel import host_pipeline as HP
    saved = dict(HP._G)
    HP._G.update(engine=engine, config=cfg, centromeres={},
                 tid={c.name: i for i, c in enumerate(fm.contigs)},
                 debug_tags=False, simulated=False)
    try:
        return [HP._run_one(w) for w in primed]
    finally:
        HP._G.clear()
        HP._G.update(saved)


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """The priming path on one device and split over ``devices``, the
    packed BAM records required bit-identical (the module docstring).

    ``devices=None`` takes the first ``n_devices`` cards and raises when
    there are fewer; it never substitutes the CPU or a repeated card. Each
    run's kernel launches are counted from 0 just before it and read just
    after. Prints the reference's summary line and returns what it
    measured."""
    from ..align.batch_engine import TorchBatchAlignmentEngine
    from ..config import RFAConfig

    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}): {have} CUDA "
                               f"devices; pass devices= to split over fewer "
                               f"cards or the CPU")
        devices = [f"cuda:{i}" for i in range(n_devices)]
    devices = [get_device(d) for d in devices]
    if len(devices) != n_devices:
        raise ValueError(f"{len(devices)} devices given for {n_devices}")
    fm, genome = toy_genome(n=1_200_000)
    cfg = RFAConfig()
    barcode_sets = sim_pairs(genome)

    def run(engine):
        cards = [d for d in dict.fromkeys(engine.devices)
                 if d.type == "cuda"]
        base = {}
        for d in cards:
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
            base[d] = torch.cuda.memory_allocated(d)
        _build.reset_launches()
        t0 = time.time()
        packed = pack_primed(engine, fm,
                             prime_groups(engine, barcode_sets, cfg), cfg)
        wall, launches = time.time() - t0, _build.launches()
        # the most this run held on each card above what it found there
        peak = {str(d): torch.cuda.max_memory_allocated(d) - base[d]
                for d in cards}
        return packed, wall, launches, peak

    single, wall_single, launches_single, _ = run(
        TorchBatchAlignmentEngine(fm, device=devices[0]))
    eng = TorchBatchAlignmentEngine(fm, devices=devices)
    split, wall_split, launches_split, peak_split = run(eng)

    if eng.shard_waves < 16:
        raise AssertionError(f"only {eng.shard_waves} split waves (need "
                             f">= 16)")
    if len(single) != len(split):
        raise AssertionError(f"{len(split)} barcodes packed, want "
                             f"{len(single)}")
    n_recs = 0
    for a, b in zip(single, split):
        if a.bc_sorted != b.bc_sorted or a.buckets != b.buckets:
            raise AssertionError("split BAM records differ from the "
                                 "single device's")
        off = 0
        while off < len(a.bc_sorted):
            off += 4 + struct.unpack_from("<I", a.bc_sorted, off)[0]
            n_recs += 1
    # block d of a split holds the tasks o % n == d, and a wave's real
    # tasks fill its first rows
    per_dev = np.zeros(n_devices, np.int64)
    for rec in eng.shard_log:
        base, extra = divmod(rec["real"], n_devices)
        per_dev += base
        per_dev[:extra] += 1
    lo, hi = int(per_dev.min()), int(per_dev.max())
    if not (lo > 0 and hi <= 2 * lo):
        raise AssertionError(f"wave split imbalance: per-device tasks "
                             f"{per_dev.tolist()}")
    distinct = list(dict.fromkeys(str(d) for d in devices))
    print(f"dryrun_multichip OK: {n_devices} devices, {eng.shard_waves} "
          f"sharded waves, {n_recs} records bit-identical to single-device, "
          f"per-device tasks {per_dev.tolist()} (max/min {hi}/{lo}); "
          f"{len(distinct)} distinct devices ran it: {', '.join(distinct)}",
          flush=True)
    return {"devices": [str(d) for d in devices], "distinct": distinct,
            "shard_waves": eng.shard_waves, "records": n_recs,
            "barcodes": len(single), "per_dev_tasks": per_dev.tolist(),
            "wall_single_s": wall_single, "wall_split_s": wall_split,
            "launches_single": launches_single,
            "launches_split": launches_split, "peak_split": peak_split}
