"""Command-line entry point of the port, with lariat_tpu.cli's flags
(lariat/main.go:9-48; single- and double-dash).

Usage: python -m lariat_tpu_torch.cli -reads in.fastq.gz -genome ref.fa
       -output dir -threads 8 -use_device on

With ``-threads > 1`` the worker pool forks first. Then, unless
``-use_device off``, priming starts: through a resident device server when
one answers on ``LARIAT_DEVICE_SOCKET`` (or the genome's default socket,
``parallel/device_server.py``; a server on the CPU only with
``LARIAT_DEVICE_SERVER_CPU_OK=1``), else through a PyTorch engine of this
process (on CUDA by default: it raises without CUDA unless
``LARIAT_TORCH_DEVICE=cpu`` asks for the CPU). The hybrid router
(``_primed_iter``, the reference's) sends each batch of barcodes to a
priming thread (``LARIAT_PRIME_THREADS``, default 2) when one is free, and
straight to the host workers when every thread is busy, when the device
went dormant (``LARIAT_PRIME_MIN_FRAC``), or at the end of the input after
a grace (``LARIAT_PRIME_TAIL_GRACE``). A primed batch carries seed
extension, mate rescue and the final global alignment; workers run RFA and
BAM emission and never touch CUDA. Every host-routed pair is counted in the
summary. A priming error ends the run nonzero: only a deliberate abort
(``PrimeAborted``) host-routes. ``-use_device off`` runs the host-native
workers alone.
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
from concurrent.futures import wait as wait_futures

import torch

from . import __version__
from .align.batch_engine import PrimeAborted, TorchBatchAlignmentEngine
from .align.engine import AlignmentEngine
from .config import RFAConfig
from .device import describe
from .index import fmindex
from .io.bamwriter import LariatBAMs
from .io.fastq import FastQReader
from .ops import _build
from .parallel.device_server import DeviceServerClient
from .parallel.host_pipeline import ParallelRunner, write_packed
from .rfa.pipeline import (RFAStats, load_centromeres, process_barcode,
                           worth_running_rfa)
from .rfa.tensor_rfa import rows_jit
from .utils import spans

# why a batch went to the host workers (``feed_stats["host_by"]``): every
# priming thread busy, the device dormant, a server batch at or under half
# of ``LARIAT_PRIME_BATCH``, one barcode group over it, queued at the end
# of the input and cancelled, still priming past the tail grace, or its
# pass aborted
HOST_REASONS = ("busy", "dormant", "half", "oversize", "tail_cancel",
                "abandoned", "aborted")


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


def _device_engine(genome: str, fm):
    """The priming engine: a resident server's client when one answers
    (``LARIAT_DEVICE_SOCKET``, else the genome's default socket; a server
    on the CPU only with ``LARIAT_DEVICE_SERVER_CPU_OK=1``), else a
    ``TorchBatchAlignmentEngine`` of this process."""
    srv = DeviceServerClient.connect(
        genome, path=os.environ.get("LARIAT_DEVICE_SOCKET") or None)
    if srv is not None and (
            srv.device_type != "cpu"
            or os.environ.get("LARIAT_DEVICE_SERVER_CPU_OK") == "1"):
        print(f"device priming via server ({srv.path}, device "
              f"{srv.device_name})")
        return srv
    eng = TorchBatchAlignmentEngine(fm)
    print(f"device priming on {describe(eng.device)}")
    return eng


def main(argv=None) -> int:
    spans.set_role("cli")
    rc, _ = run(argv)
    return rc


def _batch_target(pairs_s, fixed_batch=None) -> int:
    """Prime batch size: the server's fixed batch when priming goes
    through one; else ~2 s of device work at the measured rate (1024 pairs
    until the first batch lands), clamped to [512, 16384]."""
    if fixed_batch:
        return fixed_batch
    if pairs_s is None:
        return 1024
    return max(512, min(16384, int(pairs_s * 2.0)))


def _tail_grace(pairs_s, batch, elapsed) -> float:
    """Seconds the router waits at the end of the input for batches still
    priming: ``LARIAT_PRIME_TAIL_GRACE`` when set, else the reference's
    formula -- 1.5 batch times at the measured rate (5 s while no batch
    has landed), at least 2 s, at most 30 s or 15% of the elapsed run (at
    least 2 s)."""
    auto = (1.5 * batch / pairs_s) if pairs_s else 5.0
    return float(os.environ.get("LARIAT_PRIME_TAIL_GRACE", "0")) \
        or min(max(2.0, auto), max(2.0, 0.15 * elapsed), 30.0)


def _primed_iter(work_iter, device_engine, config, n_prime, feed_stats,
                 t0=None):
    """Tagged work feed (seq, work), possibly out of reader order (the
    caller reorders by seq): the reference's hybrid router.

    Barcode groups batch up to ``_batch_target`` pairs. A batch goes to one
    of ``n_prime`` priming threads when one is free, and straight to the
    host workers (who run the native DP themselves) when all are busy or
    the device is dormant (``dormant``). Through a server
    (``device_engine.path``) batches are of the fixed size
    ``LARIAT_PRIME_BATCH`` (default 1024): a batch that would overshoot it
    is sent as it stands when it holds more than half of it, and
    host-routed otherwise. At the end of the input the remainder is primed
    only when a thread is free, queued batches are cancelled and
    host-routed, and batches still priming get a grace (``_tail_grace``);
    then ``device_engine.abort_prime`` is set, they are host-routed and
    their results, whenever they land, are discarded. Every item is yielded
    exactly once; ``feed_stats`` counts primed and host-routed pairs, and
    in ``feed_stats["host_by"]`` the host-routed ones by reason
    (``HOST_REASONS``). Recorded spans (``utils/spans.py``): each batch's
    ``router.batch`` (from its first barcode to its results yielded;
    ``pairs``, ``route``: ``prime`` or the host reason) and each submitted
    one's ``router.queue`` (until a priming thread starts it).

    A pass that raises ``PrimeAborted`` host-routes its batch. Any other
    error of a priming pass ends the feed and is left in
    ``feed_stats["error"]``, which the caller re-raises (the pool's feeder
    thread must not see it): a failure never becomes host routing."""
    seq = itertools.count()
    t0 = time.time() if t0 is None else t0
    rate = {"pairs_s": None}
    fixed = (int(os.environ.get("LARIAT_PRIME_BATCH", "1024"))
             if getattr(device_engine, "path", None) else None)
    by = feed_stats.setdefault("host_by", dict.fromkeys(HOST_REASONS, 0))

    def prime(tagged, batch, queue):
        queue.end()
        t = time.time()
        try:
            with spans.under(batch):
                primed = _prime_group(device_engine,
                                      [it for _, it in tagged], config)
        except PrimeAborted:
            return None
        r = pairs(tagged) / max(time.time() - t, 1e-3)
        prev = rate["pairs_s"]
        rate["pairs_s"] = r if prev is None else 0.5 * prev + 0.5 * r
        return [(s, p) for (s, _), p in zip(tagged, primed)]

    futs = deque()       # (future, tagged batch, its span), in order
    abandoned = []       # futures left running past the tail grace
    queued = set()       # futures submitted while every thread was busy
    dorm = {"first_submit": None, "off": False}

    def busy() -> int:
        return sum(1 for f, _, _ in futs if not f.done())

    def dormant() -> bool:
        """Give up on priming for the rest of the run when the device
        cannot pull its weight: it must add at least LARIAT_PRIME_MIN_FRAC
        (default 0.15) of the host pool's concurrent rate, and complete a
        batch within 45 s of the first submission."""
        if dorm["off"]:
            return True
        r = rate["pairs_s"]
        if r is None:
            fs = dorm["first_submit"]
            if fs is not None and time.time() - fs > 45.0:
                dorm["off"] = True
        else:
            host_rate = feed_stats["host_pairs"] / max(time.time() - t0,
                                                       1e-3)
            frac = float(os.environ.get("LARIAT_PRIME_MIN_FRAC", "0.15"))
            if r < frac * host_rate:
                dorm["off"] = True
        if dorm["off"]:
            print(f"device priming dormant (measured {r or 0:.0f} "
                  f"pairs/s) after {time.time() - t0:.1f}s, "
                  f"{feed_stats['primed_pairs']} pairs primed", flush=True)
        return dorm["off"]

    def pairs(tagged) -> int:
        return sum(len(it[0]) for _, it in tagged)

    def host(tagged, reason, batch):
        batch.end(route=reason, pairs=pairs(tagged))
        for s, it in tagged:
            feed_stats["host_pairs"] += len(it[0])
            by[reason] += len(it[0])
            yield (s, it)

    def submit(tagged, batch):
        if dorm["first_submit"] is None:
            dorm["first_submit"] = time.time()
        # a batch submitted with fewer passes in flight than the pool has
        # threads has a thread of its own, idle or about to be: it starts
        # whatever the scheduler does, and is never cancelled
        behind = busy() >= ex._max_workers
        batch.set(route="prime", pairs=pairs(tagged))
        f = ex.submit(prime, tagged, batch,
                      spans.span("router.queue", parent=batch))
        if behind:
            queued.add(f)
        futs.append((f, tagged, batch))

    def drain(block: bool):
        while futs and (block or futs[0][0].done()):
            f, tagged, batch = futs.popleft()
            res = f.result()
            if res is None:                 # the pass was aborted
                yield from host(tagged, "aborted", batch)
                continue
            batch.end()
            for t in res:
                feed_stats["primed_pairs"] += len(t[1][0])
                yield t

    ex = ThreadPoolExecutor(max_workers=n_prime,
                            thread_name_prefix="lariat-prime")
    try:
        buf = []
        pending = 0
        batch = spans.OFF
        for item in work_iter:
            t = (next(seq), item)
            npairs = len(item[0])
            if fixed and pending and pending + npairs > fixed:
                # never overshoot the server's batch: send what is there
                # when it is over half of it, else host-route it
                reason = ("half" if pending <= fixed // 2 else
                          "dormant" if dormant() else
                          "busy" if busy() >= n_prime else None)
                if reason:
                    yield from host(buf, reason, batch)
                else:
                    submit(buf, batch)
                buf, pending = [], 0
                yield from drain(block=False)
            if not buf:
                batch = spans.span("router.batch")
            buf.append(t)
            pending += npairs
            if pending >= _batch_target(rate["pairs_s"], fixed):
                # one oversized barcode group, or priming dormant or
                # saturated: host route now
                reason = ("oversize" if fixed and pending > fixed else
                          "dormant" if dormant() else
                          "busy" if busy() >= n_prime else None)
                if reason:
                    yield from host(buf, reason, batch)
                else:
                    submit(buf, batch)
                buf, pending = [], 0
                yield from drain(block=False)
        # end of input: the remainder only to a free thread (and, with a
        # server, only past half its batch); queued batches host-route
        if buf:
            if fixed and pending <= fixed // 2:
                yield from host(buf, "half", batch)
            elif busy() >= n_prime:
                yield from host(buf, "busy", batch)
            else:
                submit(buf, batch)
        # only batches queued behind busy threads are cancelled; one handed
        # to a free thread runs (the reference cancels whatever its threads
        # have not picked up yet, the remainder submitted a line above
        # included)
        keep = deque()
        while futs:
            f, tagged, batch = futs.popleft()
            if f in queued and f.cancel():
                yield from host(tagged, "tail_cancel", batch)
            else:
                keep.append((f, tagged, batch))
        futs.extend(keep)
        if futs:
            r = rate["pairs_s"]
            grace = _tail_grace(r, _batch_target(r, fixed),
                                time.time() - t0)
            wait_futures([f for f, _, _ in futs], timeout=grace)
            if any(not f.done() for f, _, _ in futs):
                device_engine.abort_prime = True
                keep = deque()
                while futs:
                    f, tagged, batch = futs.popleft()
                    if f.done():
                        keep.append((f, tagged, batch))
                    else:
                        abandoned.append(f)
                        yield from host(tagged, "abandoned", batch)
                futs.extend(keep)
        yield from drain(block=True)
        # an abandoned pass ends at its next wave boundary; its result is
        # discarded, but an error other than the abort still fails the run
        for f in abandoned:
            f.result()
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
    t_load = time.time()
    fm = load_reference(args.genome, args.index)
    print("Reference loaded")
    if fm.l_pac > fmindex.FMIndex.CODES_CACHE_MAX:
        fm.ensure_codes_cache()
    fm.ensure_native_hot()
    print(f"index load: {time.time() - t_load:.2f}s")
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
                device_engine = _device_engine(args.genome, fm)
            if device_engine is None:
                feed = ((s, it) for s, it in enumerate(work_iter()))
            else:
                _build.reset_launches()
                n_prime = max(1, int(os.environ.get("LARIAT_PRIME_THREADS",
                                                    "2")))
                feed = _primed_iter(work_iter(), device_engine, config,
                                    n_prime, feed_stats, t0=t0)
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
                    stats.cand_wall_host += packed.stats[7]
                    stats.cand_wall_primed += packed.stats[8]
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
        routes = {"primed": feed_stats["primed_pairs"],
                  **feed_stats.get("host_by", {})}
        print(f"router routes: {json.dumps(routes)}")
        if getattr(device_engine, "path", None):
            print(f"priming ran in the server {device_engine.path} on "
                  f"{device_engine.device_name} (its kernel launches are in "
                  f"its log)")
        else:
            print(f"priming ran in this process on "
                  f"{describe(device_engine.device)}")
            print(f"kernel launches: {json.dumps(_build.launches())}")
            print(f"kernel entry launches: "
                  f"{json.dumps(_build.entry_launches())}")
            print(f"sa walks: {json.dumps(device_engine.sa_walks())}")
            print(f"device path: {json.dumps(device_engine.path_log())}")
        print(f"cuda initialized in the CLI process: "
              f"{torch.cuda.is_initialized()}")
    print(f"Processed {n_pairs} read pairs across {n_bcs} barcodes "
          f"in {dt:.1f}s ({n_pairs / max(dt, 1e-9):.1f} pairs/s)")
    if stats.picks:
        print(f"tie-sensitive picks: {stats.tie_picks}/{stats.picks} "
              f"({stats.tie_picks / stats.picks:.4f})")
    if stats.rfa_wall:
        print(f"rfa wall: {stats.rfa_wall:.2f}s across workers "
              f"(rows: {'jit' if rows_jit() else 'numpy'})")
    if stats.cand_wall_host or stats.cand_wall_primed:
        print(f"candidates wall: {stats.cand_wall_host:.2f}s host-routed, "
              f"{stats.cand_wall_primed:.2f}s primed across workers")
    if args.simulated and stats.total:
        print(f"simulated: total={stats.total} correct={stats.correct} "
              f"mapq10 total={stats.total_mapq10} "
              f"correct={stats.correct_mapq10}")
    print("Lariat completed successfully")
    return 0, stats


if __name__ == "__main__":
    sys.exit(main())
