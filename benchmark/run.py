"""The benchmark of ``lariat_tpu_torch``: one run of one cell.

    python benchmark/run.py --workload hg38sim_cut08.server_devseed --seed 7 \\
        --seconds 30 --trace 0

Prints, as the last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and with
``--trace 1`` ``breakdown``), then ``checks`` last: each number the
comparison with the reference judged, with its limit. The same numbers
close standard error. Exits nonzero, with no result line, when there is no
CUDA device or fewer than the cell asks for, when a run fails, and when a
process of the port loaded ``jax``, ``jaxlib``, ``flax`` or
``lariat_tpu``.

Everything is found by name in ``BENCHMARK.json``: the cell's
configuration file, ``benchmark/traffic/<mix>.json`` and
``benchmark/metrics/<metric>.py``. ``--keep DIR`` copies the run's logs
and side files to DIR.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from core import cell, manifest  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "lariat_tpu")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--keep", default=None)
    a = p.parse_args(argv)
    root = os.path.dirname(HERE)
    cell.stop_on_term()
    try:
        man = manifest.Manifest(root)
        out = cell.run(man, a.workload, a.seed, a.seconds, bool(a.trace),
                       T_START, keep=a.keep)
    except (manifest.ManifestError, cell.RunError, OSError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    loaded = sorted({m.split(".")[0] for m in list(sys.modules)}
                    & set(FORBIDDEN))
    if loaded:
        print(f"benchmark: this process loaded {loaded}", file=sys.stderr)
        return 3
    res = out["result"]
    print("run: " + json.dumps(out["info"]), flush=True)
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(f"correct: {res['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
