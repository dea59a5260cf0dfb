"""The control of a cell's comparison, at the cell's own size: the reads a
run with each seed makes, aligned by the control (``reference/control.py``)
in the program's place, and judged as a run's BAMs are. Prints each
seed's numbers beside the cell's limits; the comparison must call every
seed not correct.

    python benchmark/control.py --workload hg38sim_cut08.server_devseed \\
        --seeds 11,12,13 [--seconds 30]

No program runs, so it needs no card: its numbers are the upper readings
the limits are set below.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from core import manifest  # noqa: E402
from gen import genome, sim_reads  # noqa: E402
from reference import control, judge  # noqa: E402


def readings(man, workload: str, seed: int, seconds: int,
             cache_root: str | None = None) -> dict:
    wl = man.workload(workload)
    cfg, tr = man.config(wl["config"]), man.traffic(wl["traffic"])
    cache_dir = os.path.join(cache_root or os.path.join(HERE, ".cache"),
                             cfg["name"])
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE))
    genome.ensure(cfg, cache_dir, env=env)
    codes, contigs = genome.load_codes(cache_dir)
    n_bc = max(int(wl["chips"]), round(tr["pairs_per_s_hint"] * seconds
                                       / tr["pairs_per_bc"]))
    reads = sim_reads.simulate(codes, contigs, n_bc, tr, seed)
    work = tempfile.mkdtemp(prefix="lariat_control_")
    try:
        t0 = time.time()
        placed = control.align(reads, codes, contigs)
        control.write(work, reads, codes, contigs, placed)
        counts = judge.Judge(reads, codes, contigs, seed).judge(
            [work], processed=reads.n)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    limits = dict(tr["limits"])
    checks = {k: {"value": counts[k], "limit": limits.get(k, 0)}
              for k in judge.COMPARED}
    return {"seed": seed, "pairs": reads.n, "seconds": time.time() - t0,
            "checks": checks, "wrong_pct": counts["wrong_pct"],
            "off_origin_equal_pct": counts["off_origin_equal_pct"],
            "correct": all(c["value"] <= c["limit"]
                           for c in checks.values())}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=int, default=None)
    a = p.parse_args(argv)
    man = manifest.Manifest(os.path.dirname(HERE))
    seconds = a.seconds or int(man.data["run_seconds"])
    worst = True
    for s in a.seeds.split(","):
        r = readings(man, a.workload, int(s), seconds)
        print(json.dumps(r), flush=True)
        worst = worst and not r["correct"]
    return 0 if worst else 1


if __name__ == "__main__":
    sys.exit(main())
