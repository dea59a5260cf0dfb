"""One traced run of one cell with the port's span recorder on, and the
card's idle time put down to what the host was doing.

    python benchmark/spanrun.py --workload hg38sim_cut08.server_devseed \\
        --seed 7 --seconds 30 [--spans 0] [--keep DIR]

The run is ``run.py --trace 1``'s (``core/cell.py``), with
``LARIAT_SPANS`` set in every process of the port, so each writes its
spans (``lariat_tpu_torch/utils/spans.py``) at its exit; ``--spans 0``
leaves it unset (the same traced run without the recorder, for its cost).
Prints the result line, then one JSON line: the run's seconds and pairs/s,
the idle shares of ``core/idle.py`` (% of the window; they sum to
``device_idle_pct``) and their seconds, the server threads' seconds by
cause, the spans by name, and the K1-K5 device intervals that lie inside
the ``wave.*`` or ``seed.*`` span that launched them. ``--keep DIR`` keeps
the logs, side files and span files.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from core import cell, idle, kernels, manifest  # noqa: E402

# K1-K3 and K4a-K5 by their trace names
LAUNCHED = kernels.DP + kernels.SEED


class _Capture(manifest.Manifest):
    """The manifest, keeping the context its readers were given."""

    ctx = None

    def reader(self, metric):
        mod = super().reader(metric)
        owner = self

        class Reader:
            UNIT = mod.UNIT

            @staticmethod
            def read(ctx):
                owner.ctx = ctx
                return mod.read(ctx)
        return Reader


def run(root, workload, seed, seconds, spans_on, t_start, keep=None,
        **cell_kw) -> dict:
    """One traced run; returns {"result", "info", "spans"}."""
    spans_dir = (os.path.join(keep, "spans") if keep
                 else tempfile.mkdtemp(prefix="lariat_spans_"))
    os.makedirs(spans_dir, exist_ok=True)
    env_of = cell._env

    def env_with_spans(*a, **k):
        env = env_of(*a, **k)
        if spans_on:
            env["LARIAT_SPANS"] = os.path.abspath(spans_dir)
        return env
    cell._env = env_with_spans
    try:
        man = _Capture(root)
        out = cell.run(man, workload, seed, seconds, True, t_start,
                       keep=keep, **cell_kw)
        procs = idle.load(spans_dir)
    finally:
        cell._env = env_of
        if not keep:
            shutil.rmtree(spans_dir, ignore_errors=True)
    out["spans"] = summary(man.ctx or {}, procs, out["result"])
    return out


def summary(ctx, procs, result) -> dict:
    ctx = dict(ctx, spans=procs)
    out = {"span_files": [[p["role"], len(p["spans"])] for p in procs]}
    if not procs or "t_open" not in ctx:
        return out
    t0, t1, w = ctx["t_open"], ctx["t_close"], ctx["window_s"]
    names = {}
    for p in procs:
        for r in p["spans"]:
            if t0 <= r["t0"] <= t1:
                key = f"{p['role']}:{r['name']}"
                n = names.setdefault(key, [0, 0.0])
                n[0] += 1
                n[1] += min(r["t1"], t1) - r["t0"]
    out["in_window"] = {k: [n, round(s, 6)] for k, (n, s) in
                        sorted(names.items())}
    sh = idle.shares(ctx)
    if sh is not None:
        out["idle_pct"] = sh
        out["idle_s"] = {k: v * w / 100.0 for k, v in sh.items()}
        m = result.get("metrics", {}).get("device_idle_pct")
        out["idle_sum_minus_device_idle_pct"] = (
            sum(sh.values()) - m["value"] if m else None)
    threads = idle.thread_seconds(procs, "server", t0, t1)
    out["server_threads"] = threads
    kinds = {}
    for th, row in threads.items():
        kind = "prime" if th.startswith("lariat-serve-prime") else "conn"
        agg = kinds.setdefault(kind, {"threads": 0})
        agg["threads"] += 1
        for k, v in row.items():
            agg[k] = agg.get(k, 0.0) + v
    out["server_thread_kinds"] = kinds
    inside, total = [], 0
    for pr in ctx.get("profiles") or []:
        names_p = pr.get("names", [])
        total += sum(1 for s, e, i in pr.get("intervals", [])
                     if t0 <= s <= t1 and any(
                         k in names_p[i] for k in LAUNCHED))
        inside += [x for x in idle.launched_inside(pr, procs, LAUNCHED)
                   if t0 <= x[2] <= t1]
    out["kernel_intervals"] = total
    out["kernel_intervals_inside_spans"] = len(inside)
    out["inside_examples"] = [[cell.short(k), s, a, b]
                              for k, s, a, b in inside[:5]]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--spans", type=int, choices=(0, 1), default=1)
    p.add_argument("--keep", default=None)
    a = p.parse_args(argv)
    cell.stop_on_term()
    try:
        out = run(os.path.dirname(HERE), a.workload, a.seed, a.seconds,
                  bool(a.spans), T_START, keep=a.keep)
    except (manifest.ManifestError, cell.RunError, OSError) as e:
        print(f"spanrun: {e}", file=sys.stderr)
        return 2
    print(json.dumps(out["result"]), flush=True)
    print(json.dumps({"spans_on": bool(a.spans), "seed": a.seed,
                      "info": out["info"], **out["spans"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
