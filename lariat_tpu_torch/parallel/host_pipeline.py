"""Multiprocess host pipeline: data-parallel workers over barcode groups.

Equivalent of the reference's worker pool (lariat.go:333-390,426-440): the
reader streams barcode sets in the main process, ``-threads`` forked workers
run the per-barcode RFA pipeline independently (barcode atomicity is the unit
of independence, SURVEY.md section 2.3), and finished barcodes return as
pre-packed BAM record bytes which the main process appends to the writers in
input order (the reference's single BamThread).

The genome index is shared with workers by fork copy-on-write — the analog of
the reference's single in-RAM bwa index shared across goroutines.
"""

from __future__ import annotations

import dataclasses
import multiprocessing as mp
from typing import Dict, List, Optional, Tuple

from ..align.engine import AlignmentEngine
from ..config import RFAConfig
from ..io.bamwriter import build_record
from ..io.fastq import FastQRecord
from ..rfa.pipeline import RFAStats, process_barcode
from ..rfa.types import Region

# worker globals installed by the pool initializer (fork inherits the index)
_G: dict = {}

# Pre-fork state read by ``_init_worker`` from the forked address space.
# Passing the engine through Pool ``initargs`` would PICKLE it through a
# pipe per worker (multiprocessing pickles initargs even under the fork
# start method) — at hg38 scale that is ~8.5 GB per worker and dominates
# startup. Stashing it in a module global before ``Pool()`` forks makes the
# hand-off a true copy-on-write share, which is the design stated above.
_FORK_STATE: dict = {}


@dataclasses.dataclass
class PackedBarcode:
    """One barcode's output: packed records for each destination.

    Bucket records are pre-grouped and concatenated per destination in the
    worker, so the (serial) writer does one append per touched bucket
    instead of one per record."""
    bc_sorted: bytes                       # concatenated record bytes
    buckets: List[Tuple[str, int, bytes]]  # (contig|'unmapped', chunk, blob)
    n_reads: int
    stats: Tuple[int, int, int, int, int, int, float]


def _init_worker() -> None:
    _G.update(_FORK_STATE)
    # the pool already process-parallelizes across cores; per-worker native
    # thread fan-out would oversubscribe (workers x N_THREADS threads)
    from ..index import native_ops
    native_ops.N_THREADS = 1
    # workers are the bulk CPU consumers; the main process (reader/feeder/
    # writer pump) and the resident device server are latency-sensitive and
    # tiny — let them preempt (a starved server turned ~30 ms device waves
    # into multi-second ones under a full worker pool)
    try:
        import os as _os
        _os.nice(5)
    except OSError:
        pass


def _run_one(work) -> PackedBarcode:
    reads, unique, primed = (work if len(work) == 3 else (*work, None))
    stats = RFAStats()
    result = process_barcode(_G["engine"], reads, unique, _G["config"],
                             _G["centromeres"], stats, _G["simulated"],
                             primed_regions=primed)
    tid = _G["tid"]
    debug_tags = _G["debug_tags"]
    chunk_size = _G.get("position_chunk_size", 40000000)
    bc_parts: List[bytes] = []
    by_bucket: Dict[Tuple[str, int], List[bytes]] = {}
    for arr in result.alignments:
        if not arr:
            raise RuntimeError("not all read_ids are spoken for")
        read_output = False
        for aln in arr:
            if not aln.active:
                continue
            for out_aln in ([aln, aln.secondary] if aln.secondary is not None
                            else [aln]):
                rec = build_record(out_aln, aln, result.attach_bx, tid,
                                   debug_tags).pack()
                bc_parts.append(rec)
                if out_aln.is_unmapped():
                    key = ("unmapped", 0)
                else:
                    key = (out_aln.contig, int(out_aln.pos) // chunk_size)
                by_bucket.setdefault(key, []).append(rec)
            read_output = True
        if not read_output:
            raise RuntimeError("read_id has no active alignment")
    return PackedBarcode(
        bc_sorted=b"".join(bc_parts),
        buckets=[(c, i, b"".join(parts))
                 for (c, i), parts in by_bucket.items()],
        n_reads=len(reads),
        stats=(stats.total, stats.correct, stats.total_mapq10,
               stats.correct_mapq10, stats.picks, stats.tie_picks,
               stats.rfa_wall))


def _run_one_seq(tagged) -> Tuple[int, PackedBarcode]:
    seq, work = tagged
    return seq, _run_one(work)


class ParallelRunner:
    """Ordered fan-out of barcode sets over a fork pool."""

    def __init__(self, engine: AlignmentEngine, config: RFAConfig,
                 centromeres: Dict[str, Region], tid: Dict[str, int],
                 debug_tags: bool, simulated: bool, threads: int,
                 position_chunk_size: int = 40000000):
        _FORK_STATE.update(
            engine=engine, config=config, centromeres=centromeres, tid=tid,
            debug_tags=debug_tags, simulated=simulated,
            position_chunk_size=position_chunk_size)
        ctx = mp.get_context("fork")
        self.pool = ctx.Pool(
            processes=max(threads, 1), initializer=_init_worker)

    def imap(self, work_iter, chunksize: int = 1):
        """Yield PackedBarcode results in input order."""
        return self.pool.imap(_run_one, work_iter, chunksize)

    def imap_seq(self, tagged_iter, chunksize: int = 1):
        """Yield (seq, PackedBarcode) for (seq, work) inputs.

        Results come back in *submission* order; the caller reorders by
        ``seq`` before writing so the hybrid device/host feed (cli.py
        primed_iter, which yields host-routed work ahead of in-flight
        device-primed work) still produces byte-identical output."""
        return self.pool.imap(_run_one_seq, tagged_iter, chunksize)

    def close(self) -> None:
        self.pool.close()
        self.pool.join()


def write_packed(bams, packed: PackedBarcode) -> None:
    """Append a finished barcode's records to the dual outputs."""
    bams.barcode_sorted._bgzf.write(packed.bc_sorted)
    for contig, chunk, blob in packed.buckets:
        if contig == "unmapped":
            w = bams.position_bucketed["unmapped"][0]
        else:
            w = bams.position_bucketed[contig][chunk]
        w._bgzf.write(blob)
