"""The port's CLI timed on the card in turns across trees of the port (a
parent and a change), in one call, with the host-native CLI beside each
turn as the control for the host's own speed:

    mkdir -p build/parent
    git archive <parent> lariat_tpu_torch native | tar -x -C build/parent
    python3 lariat_tpu_torch/tools/cli_turns.py <genome.fa> \\
        <reads.fastq.gz> build/parent . . build/parent

First each distinct tree builds its kernels and the index cache is made,
so no timed run pays for either. Then for each tree, in the order given,
three runs, each a subprocess with the tree on PYTHONPATH, all with
``-threads 8 -first_chunk``:
- ``host``: the port's CLI on its host path (``-use_device off``, the
  host-native workers; no kernel, no launch), the control: where the trees'
  host paths are the same, what moves it is the host;
- ``primed``: the port's CLI, ``-use_device on``, all primed (chip_smoke.py's
  router knobs: a priming thread for every 512 pairs, a tail grace of
  600 s, no dormancy);
- ``default``: the port's CLI, ``-use_device on``, at the router's defaults.

``--configs host,primed`` runs only those (``host`` always among them).

Prints one JSON line a run (tree, configuration, pairs, pairs/s, primed and
host-routed pairs, wall) and, last, one JSON line with every rate by tree
and configuration and each port run's rate over the host-native run of its
turn. Exits nonzero when a run fails or a port run's pair count differs
from host-native's.
"""

from __future__ import annotations

import gzip
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
THREADS = 8
CONFIGS = ("host", "primed", "default")


def count_pairs(reads: str) -> int:
    """Read pairs in a 9-line-record FASTQ (gzip)."""
    with gzip.open(reads, "rb") as f:
        return sum(1 for _ in f) // 9


def warm(tree: str, fasta: str) -> None:
    """Build ``tree``'s kernels and native library and load the index (its
    cache written next to the FASTA on first use)."""
    subprocess.run([sys.executable, "-c",
                    "import sys; from lariat_tpu_torch.ops import _build; "
                    "_build.load(); from lariat_tpu_torch.cli import "
                    "load_reference; load_reference(sys.argv[1])", fasta],
                   check=True, env={**os.environ,
                                    "PYTHONPATH": os.path.abspath(tree)},
                   timeout=900)


def run_cli(tree: str, config: str, fasta: str, reads: str, out_dir: str,
            n_pairs: int) -> dict:
    """One CLI run of ``config`` with ``tree``'s package; what its summary
    lines say."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("LARIAT_PRIME")
           and k not in ("LARIAT_TORCH_DEVICE", "LARIAT_DEVICE_SEED",
                         "LARIAT_DEVICE_SOCKET")}
    env["PYTHONPATH"] = os.path.abspath(tree)
    mode = "off" if config == "host" else "on"
    if config == "primed":
        env.update(LARIAT_PRIME_THREADS=str(-(-n_pairs // 512)),
                   LARIAT_PRIME_TAIL_GRACE="600", LARIAT_PRIME_MIN_FRAC="0")
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "lariat_tpu_torch.cli",
                        "-reads", reads, "-genome", fasta, "-output", out_dir,
                        "-threads", str(THREADS), "-use_device", mode,
                        "-first_chunk"],
                       capture_output=True, text=True, env=env, timeout=900)
    wall = time.time() - t0
    if r.returncode != 0:
        raise RuntimeError(f"{tree} {config}: exit {r.returncode}\n"
                           f"{r.stderr[-3000:]}")
    m = re.search(r"Processed (\d+) read pairs across \d+ barcodes in "
                  r"[\d.]+s \(([\d.]+) pairs/s\)", r.stdout)
    if not m:
        raise RuntimeError(f"{tree} {config}: no 'Processed' line")
    res = {"tree": tree, "config": config, "pairs": int(m.group(1)),
           "pairs_s": float(m.group(2)), "wall_s": round(wall, 3)}
    d = re.search(r"primed pairs (\d+)\s+host pairs (\d+)", r.stdout)
    if d:
        res.update(primed=int(d.group(1)), host_pairs=int(d.group(2)))
    return res


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    configs = CONFIGS
    if argv[:1] == ["--configs"] and len(argv) > 1:
        configs = ("host", *(c for c in CONFIGS[1:]
                             if c in argv[1].split(",")))
        if set(argv[1].split(",")) - set(CONFIGS):
            raise SystemExit(f"configs: {argv[1]}? ({','.join(CONFIGS)})")
        argv = argv[2:]
    if len(argv) < 3:
        raise SystemExit("usage: cli_turns.py [--configs host,primed,"
                         "default] <genome.fa> <reads.fastq.gz> <tree> "
                         "[<tree> ...]")
    fasta, reads, trees = argv[0], argv[1], argv[2:]
    n_pairs = count_pairs(reads)
    for tree in dict.fromkeys(os.path.abspath(t) for t in trees):
        warm(tree, fasta)
    out_base = os.path.join(REPO, "build", "cli_turns")
    runs, ratios = [], []
    for turn, tree in enumerate(trees):
        got = {}
        for config in configs:
            res = run_cli(tree, config, fasta, reads,
                          os.path.join(out_base, f"{turn}_{config}"),
                          n_pairs)
            print(json.dumps(res), flush=True)
            runs.append(res)
            got[config] = res
        for config in configs[1:]:
            if got[config]["pairs"] != got["host"]["pairs"]:
                raise RuntimeError(f"{tree} {config}: {got[config]['pairs']} "
                                   f"pairs, host-native "
                                   f"{got['host']['pairs']}")
            ratios.append({"tree": tree, "turn": turn, "config": config,
                           "over_host": got[config]["pairs_s"]
                           / got["host"]["pairs_s"]})
    print(json.dumps({"pairs": n_pairs, "runs": [
        {k: r[k] for k in ("tree", "config", "pairs_s")} for r in runs],
        "over_host": ratios}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
