"""Multi-host scale-out driver on ``torch.distributed``: the port of
lariat_tpu/parallel/multihost.py.

The design is the reference's (its chunked invocation, ``-max_bcs`` /
``-first_chunk`` and position-bucketed BAMs merged downstream,
lariat/main.go:16,18,24):

 - INPUT: each host takes its own barcode-complete FASTQ shard; no read
   crosses hosts.
 - INDEX: replicated on every host, so aligning needs no communication
   between hosts.
 - COMPUTE: the port's CLI on the host's shard; within the host its device
   waves run on the host's card (``TorchBatchAlignmentEngine``'s
   ``devices`` split them over several, see ``tools/entry.py``
   ``dryrun_multichip``), RFA and emission on the host's workers.
 - OUTPUT: each host writes its own BAM set (only host 0 writes the
   first-chunk headers); ``python -m lariat_tpu_torch.tools.cat_bams --auto
   host000 host001 ...`` merges them.
 - STATS: summed over the hosts with one ``all_reduce`` at the end.

The CLI runs first, with its workers forked before any CUDA call; only then
does the process group come up (gloo), its one collective on a CPU tensor,
and the group is destroyed before the process returns. Unlike the
reference, a process group that does not come up is an error: ``main``
exits nonzero and prints no result line (the reference reports its local
stats instead). A single process needs no group. A process that finishes
its shard waits for the others at the rendezvous: ``-init_timeout``
defaults to a week (``INIT_TIMEOUT_S``), so shards that end hours apart
still meet.

``-use_device`` is passed to the CLI only when given, so each host runs the
CLI's own default (``auto``: priming on the card); ``-use_device off``
asks for the host path.

    python -m lariat_tpu_torch.parallel.multihost \\
        -coordinator host0:29500 -num_processes N -process_id i \\
        -reads shard_i.fastq.gz -genome ref.fa -output_base out ...

``-coordinator host:port`` becomes ``tcp://host:port`` (process 0 listens
there); a value holding ``://`` is passed as it is, so ``file:///shared/f``
coordinates through a file on a filesystem every process sees. Flags the
driver does not know go to the CLI.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import sys
from typing import List, Optional

import torch

# how long a process waits at the rendezvous and in the collective for the
# others: the slowest shard's run, which at genome scale can be hours
INIT_TIMEOUT_S = 7 * 24 * 3600.0


@dataclasses.dataclass
class HostShardPlan:
    """Which inputs/outputs this host owns."""
    host_id: int
    num_hosts: int
    reads_path: str
    output_dir: str
    first_chunk: bool     # only host 0 of chunk 0 writes the @CO headers


def init_method(coordinator: str) -> str:
    """The process group's init method for ``-coordinator``: ``host:port``
    becomes ``tcp://host:port``; a URL (``tcp://``, ``file://``) stays."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: int = 1, process_id: int = 0,
                     timeout_s: float = INIT_TIMEOUT_S) -> bool:
    """Bring up the gloo process group; a no-op (False) for one process.

    Returns True once the group is up. Raises when it cannot come up (no
    coordinator, an init method that fails or times out): the caller's
    stats would otherwise be only its own."""
    if num_processes <= 1:
        return False
    if not coordinator_address:
        raise ValueError("-coordinator is required with -num_processes > 1")
    torch.distributed.init_process_group(
        "gloo", init_method=init_method(coordinator_address),
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def plan_host_shards(reads_paths: List[str], output_base: str,
                     num_hosts: int) -> List[HostShardPlan]:
    """Round-robin barcode-complete FASTQ shards over hosts.

    ``reads_paths`` must each be barcode-complete (produced by an upstream
    barcode-aware splitter, as in the reference's pipeline contract).
    """
    plans = []
    for h in range(num_hosts):
        mine = [p for i, p in enumerate(reads_paths) if i % num_hosts == h]
        if not mine:
            continue
        plans.append(HostShardPlan(
            host_id=h, num_hosts=num_hosts, reads_path=mine[0],
            output_dir=f"{output_base}/host{h:03d}",
            first_chunk=(h == 0)))
    return plans


def global_stats_psum(local_stats) -> list:
    """Sum RFAStats (total, correct, total_mapq10, correct_mapq10) over the
    process group with one ``all_reduce`` of a CPU int64 tensor; the local
    values when no group is up."""
    vals = torch.tensor([local_stats.total, local_stats.correct,
                         local_stats.total_mapq10,
                         local_stats.correct_mapq10], dtype=torch.int64)
    if torch.distributed.is_initialized():
        torch.distributed.all_reduce(vals)
    return [int(v) for v in vals]


def run_host(plan: HostShardPlan, genome: str, threads: int = 8,
             use_device: Optional[str] = None,
             extra_args: Optional[List[str]] = None):
    """Run this host's shard through the port's CLI; ``use_device`` None
    leaves the CLI's default (``auto``).

    Returns (exit_code, RFAStats) so the caller can sum stats globally."""
    from ..cli import run as cli_run
    argv = ["-reads", plan.reads_path, "-genome", genome,
            "-output", plan.output_dir, "-threads", str(threads)]
    if use_device is not None:
        argv += ["-use_device", use_device]
    if plan.first_chunk:
        argv.append("-first_chunk")
    if extra_args:
        argv.extend(extra_args)
    return cli_run(argv)


def main(argv=None) -> int:
    """Per-process entry point: this host's shard through the CLI, then the
    process group and the stats' sum; prints one JSON line (host, rc,
    output_dir, local_stats, global_stats)."""
    p = argparse.ArgumentParser(prog="lariat_tpu_torch.multihost")
    p.add_argument("-coordinator", "--coordinator", default=None,
                   help="host:port (process 0 listens) or an init method "
                        "URL such as file:///shared/path")
    p.add_argument("-num_processes", "--num_processes", type=int, default=1)
    p.add_argument("-process_id", "--process_id", type=int, default=0)
    p.add_argument("-reads", "--reads", required=True,
                   help="this host's barcode-complete FASTQ shard")
    p.add_argument("-genome", "--genome", required=True)
    p.add_argument("-output_base", "--output_base", required=True)
    p.add_argument("-threads", "--threads", type=int, default=8)
    p.add_argument("-use_device", "--use_device", default=None,
                   choices=["auto", "on", "off"],
                   help="the CLI's -use_device (its default when not given)")
    p.add_argument("-init_timeout", "--init_timeout", type=float,
                   default=INIT_TIMEOUT_S,
                   help="seconds to wait for every process to join")
    args, extra = p.parse_known_args(argv)

    plan = HostShardPlan(
        host_id=args.process_id, num_hosts=args.num_processes,
        reads_path=args.reads,
        output_dir=f"{args.output_base}/host{args.process_id:03d}",
        first_chunk=(args.process_id == 0))
    rc, stats = run_host(plan, args.genome, threads=args.threads,
                         use_device=args.use_device, extra_args=extra)
    local = [stats.total, stats.correct, stats.total_mapq10,
             stats.correct_mapq10]
    up = init_distributed(args.coordinator, args.num_processes,
                          args.process_id, timeout_s=args.init_timeout)
    try:
        summed = global_stats_psum(stats)
    finally:
        if up:
            torch.distributed.destroy_process_group()
    # one write, so no other thread's output lands inside the line
    print(json.dumps({"host": args.process_id, "rc": rc,
                      "output_dir": plan.output_dir,
                      "local_stats": local,
                      "global_stats": summed}) + "\n", end="", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
