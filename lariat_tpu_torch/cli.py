"""Command-line entry point of the port, with lariat_tpu.cli's flags
(lariat/main.go:9-48; single- and double-dash).

Usage: python -m lariat_tpu_torch.cli -reads in.fastq.gz -genome ref.fa
       -output dir -threads 8 -use_device on

With ``-threads > 1`` the worker pool forks first; then, unless
``-use_device off``, the main process builds the PyTorch engine (on CUDA
by default: it raises without CUDA unless ``LARIAT_TORCH_DEVICE=cpu`` asks
for the CPU) and every barcode batch is primed on the device by a priming
thread (``LARIAT_PRIME_THREADS``, default 2): seed extension, mate rescue
and the final global alignment. Workers run RFA and BAM emission from the
primed regions and never touch CUDA. ``-use_device off`` runs the
host-native workers alone.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from . import __version__
from .align.engine import AlignmentEngine
from .config import RFAConfig
from .device import describe
from .index import fmindex
from .io.bamwriter import LariatBAMs
from .io.fastq import FastQReader
from .ops import _build
from .parallel.host_pipeline import ParallelRunner, write_packed
from .rfa.pipeline import (RFAStats, load_centromeres, process_barcode,
                           worth_running_rfa)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="lariat_tpu_torch", allow_abbrev=False)
    a = p.add_argument
    a("-reads", "--reads", required=True,
      help="fastq.gz input file containing reads")
    a("-improper_pair_penalty", "--improper_pair_penalty", type=float,
      default=-4.0, help="penalty for improper pair")
    a("-simulated", "--simulated", action="store_true", help="simulated data?")
    a("-output", "--output", required=True,
      help="directory at which to output bam files")
    a("-read_groups", "--read_groups",
      default="sample:library:gem_group:flowcell:lane",
      help="comma-separated list of read group IDs")
    a("-sample_id", "--sample_id", default="default_sample_id")
    a("-threads", "--threads", type=int, default=8)
    a("-max_bcs", "--max_bcs", type=int, default=-1,
      help="maximum number of barcodes to process")
    a("-debug", "--debug", action="store_true")
    a("-position_chunk_size", "--position_chunk_size", type=int,
      default=40000000)
    a("-debugBamTags", "--debugBamTags", action="store_true")
    a("-debugPrintMove", "--debugPrintMove", action="store_true")
    a("-genome", "--genome", required=True, help="genome FASTA path")
    a("-centromeres", "--centromeres", default="")
    a("-trim_length", "--trim_length", type=int, default=0)
    a("-first_chunk", "--first_chunk", action="store_true")
    a("-index", "--index", default="",
      help="optional prebuilt index prefix (.lariat.npz or bwa-format)")
    a("-profile", "--profile", default="",
      help="print per-stage wall times (single-process mode)")
    a("-use_device", "--use_device", choices=["auto", "on", "off"],
      default="auto",
      help="prime candidate-generation DP (seed-extend, mate rescue, "
           "final global SW) on the GPU (auto and on alike; the CPU only "
           "with LARIAT_TORCH_DEVICE=cpu); off runs host-native workers")
    return p


def _prime_group(device_engine, buf, config):
    """Run one device priming pass over a group of barcodes; attach the
    per-pair candidate regions to each work item."""
    all_reads = [rec for reads, _ in buf for rec in reads]
    primes = device_engine.prime_regions(all_reads,
                                         config.chain_score_delta)
    off = 0
    out = []
    for reads, unique in buf:
        out.append((reads, unique, primes[off:off + len(reads)]))
        off += len(reads)
    return out


def load_reference(genome: str, index_prefix: str = ""):
    """Load or build the genome index: prefers our .lariat.d / .lariat.npz,
    then a bwa-format index next to the FASTA, then builds from scratch."""
    prefix = index_prefix or genome
    if os.path.isdir(prefix + ".lariat.d"):
        return fmindex.FMIndex.load_dir(prefix)
    if os.path.exists(prefix + ".lariat.npz"):
        return fmindex.FMIndex.load(prefix)
    if os.path.exists(prefix + ".bwt"):
        return fmindex.load_bwa_index(prefix)
    fm = fmindex.build_index(genome)
    try:
        fm.save(genome)
    except OSError:
        pass
    return fm


def main(argv=None) -> int:
    rc, _ = run(argv)
    return rc


def _batch_target(pairs_s) -> int:
    """Prime batch size: ~2 s of device work at the measured rate (1024
    pairs until the first batch lands), clamped to [512, 16384]."""
    if pairs_s is None:
        return 1024
    return max(512, min(16384, int(pairs_s * 2.0)))


def _primed_iter(work_iter, device_engine, config, n_prime, feed_stats):
    """Tagged work feed (seq, work): every barcode batch is primed on the
    device by one of ``n_prime`` threads; results come back possibly out of
    order and the caller reorders by seq. A failed priming pass ends the
    feed and is re-raised by the caller (the pool's feeder thread must not
    see the exception)."""
    seq = itertools.count()
    rate = {"pairs_s": None}

    def prime(tagged):
        t0 = time.time()
        primed = _prime_group(device_engine, [it for _, it in tagged], config)
        n = sum(len(it[0]) for _, it in tagged)
        r = n / max(time.time() - t0, 1e-3)
        prev = rate["pairs_s"]
        rate["pairs_s"] = r if prev is None else 0.5 * prev + 0.5 * r
        return [(s, p) for (s, _), p in zip(tagged, primed)]

    futs = deque()

    def drain(keep: int):
        """Yield primed batches in submission order: every finished one,
        and the oldest (waiting for it) while more than ``keep`` are in
        flight -- the reader never runs more than a few batches ahead."""
        while futs and (futs[0].done() or len(futs) > keep):
            for t in futs.popleft().result():
                feed_stats["primed_pairs"] += len(t[1][0])
                yield t

    ex = ThreadPoolExecutor(max_workers=n_prime,
                            thread_name_prefix="lariat-prime")
    try:
        buf = []
        pending = 0
        for item in work_iter:
            buf.append((next(seq), item))
            pending += len(item[0])
            if pending >= _batch_target(rate["pairs_s"]):
                futs.append(ex.submit(prime, buf))
                buf, pending = [], 0
                yield from drain(keep=2 * n_prime)
        if buf:
            futs.append(ex.submit(prime, buf))
        yield from drain(keep=0)
    except Exception as e:  # noqa: BLE001 -- re-raised by run()
        feed_stats["error"] = e
    finally:
        ex.shutdown(wait=True, cancel_futures=True)


def run(argv=None):
    """Full pipeline; returns (exit_code, RFAStats)."""
    args = build_parser().parse_args(argv)
    if args.debugPrintMove or args.debug:
        # set before workers fork so every process inherits the switches
        from .rfa import debug as rfa_debug
        rfa_debug.PRINT_MOVE = rfa_debug.PRINT_MOVE or args.debugPrintMove
        rfa_debug.DEBUG = rfa_debug.DEBUG or args.debug
    print(f"Starting lariat_tpu_torch. Version: {__version__}")
    print(f"Loading reference genome: {args.genome}")
    fm = load_reference(args.genome, args.index)
    print("Reference loaded")
    if fm.l_pac > fmindex.FMIndex.CODES_CACHE_MAX:
        fm.ensure_codes_cache()
    fm.ensure_native_hot()
    engine = AlignmentEngine(fm)
    config = RFAConfig(improper_pair_penalty=args.improper_pair_penalty)
    centromeres = load_centromeres(args.centromeres or None)
    stats = RFAStats()
    bams = LariatBAMs(
        contigs=[(c.name, c.length) for c in fm.contigs],
        base_path=args.output, read_groups=args.read_groups,
        sample_id=args.sample_id,
        position_chunk_size=args.position_chunk_size,
        debug_tags=args.debugBamTags, first_chunk=args.first_chunk,
        version=__version__, cl=" ".join(sys.argv))
    reader = FastQReader(args.reads)
    t0 = time.time()

    def work_iter():
        barcode_num = 0
        while True:
            barcode_num += 1
            reads, unique = reader.read_barcode_set(args.trim_length)
            if reads is None:
                return
            if barcode_num == args.max_bcs:
                return
            if len(reads) > 2:
                print(f"working on barcode {reads[0].barcode10x.decode()}  "
                      f"num reads: {len(reads)}  doing RFA: "
                      f"{worth_running_rfa(reads, unique)}  "
                      f"unique_barcode {unique}")
            yield reads, unique

    n_pairs = 0
    n_bcs = 0
    device_engine = None
    feed_stats = {"primed_pairs": 0, "host_pairs": 0}
    if args.threads > 1:
        # fork the worker pool BEFORE any CUDA call: workers never touch it
        runner = ParallelRunner(engine, config, centromeres, bams.tid,
                                args.debugBamTags, args.simulated,
                                args.threads,
                                position_chunk_size=args.position_chunk_size)
        try:
            if args.use_device != "off":
                from .align.batch_engine import TorchBatchAlignmentEngine
                device_engine = TorchBatchAlignmentEngine(fm)
                print(f"device priming on {describe(device_engine.device)}")
            if device_engine is None:
                feed = ((s, it) for s, it in enumerate(work_iter()))
            else:
                _build.reset_launches()
                n_prime = max(1, int(os.environ.get("LARIAT_PRIME_THREADS",
                                                    "2")))
                feed = _primed_iter(work_iter(), device_engine, config,
                                    n_prime, feed_stats)
            reorder = {}
            next_seq = 0
            for seq_i, packed in runner.imap_seq(feed):
                reorder[seq_i] = packed
                while next_seq in reorder:
                    packed = reorder.pop(next_seq)
                    next_seq += 1
                    write_packed(bams, packed)
                    n_pairs += packed.n_reads
                    n_bcs += 1
                    stats.total += packed.stats[0]
                    stats.correct += packed.stats[1]
                    stats.total_mapq10 += packed.stats[2]
                    stats.correct_mapq10 += packed.stats[3]
                    stats.picks += packed.stats[4]
                    stats.tie_picks += packed.stats[5]
                    stats.rfa_wall += packed.stats[6]
        finally:
            runner.close()
        if "error" in feed_stats:
            raise RuntimeError("device priming failed") \
                from feed_stats["error"]
        if reorder:
            raise RuntimeError("reorder buffer not drained")
    else:
        t_align = t_dump = 0.0
        for reads, unique in work_iter():
            t1 = time.time()
            result = process_barcode(engine, reads, unique, config,
                                     centromeres, stats, args.simulated)
            t2 = time.time()
            bams.dump(result.alignments, result.attach_bx)
            t_align += t2 - t1
            t_dump += time.time() - t2
            n_pairs += len(reads)
            n_bcs += 1
        if args.profile:
            print(f"stage times: align+rfa {t_align:.2f}s, emit {t_dump:.2f}s")
    bams.close()
    dt = time.time() - t0
    if device_engine is not None:
        ws = device_engine.wave_stats
        print(f"device waves: {ws['n']}  wave wall {ws['wall']:.1f}s  "
              f"busy fraction {min(ws['wall'] / max(dt, 1e-9), 1.0):.2f}  "
              f"primed pairs {feed_stats['primed_pairs']}  "
              f"host pairs {feed_stats['host_pairs']}")
        print(f"kernel launches: {json.dumps(_build.launches())}")
        print(f"kernel entry launches: "
              f"{json.dumps(_build.entry_launches())}")
        print(f"sa walks: {json.dumps(device_engine.sa_walks())}")
    print(f"Processed {n_pairs} read pairs across {n_bcs} barcodes "
          f"in {dt:.1f}s ({n_pairs / max(dt, 1e-9):.1f} pairs/s)")
    if stats.picks:
        print(f"tie-sensitive picks: {stats.tie_picks}/{stats.picks} "
              f"({stats.tie_picks / stats.picks:.4f})")
    if stats.rfa_wall:
        print(f"rfa wall: {stats.rfa_wall:.2f}s across workers "
              f"(rows: numpy)")
    if args.simulated and stats.total:
        print(f"simulated: total={stats.total} correct={stats.correct} "
              f"mapq10 total={stats.total_mapq10} "
              f"correct={stats.correct_mapq10}")
    print("Lariat completed successfully")
    return 0, stats


if __name__ == "__main__":
    sys.exit(main())
