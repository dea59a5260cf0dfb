"""A tiny copy of the benchmark for its CPU tests: a manifest of the same
shape over a 6 Mb genome and a few barcodes, whose runs drive the port on
the CPU (``LARIAT_TORCH_DEVICE=cpu``: the kernels' plain twins) through
the harness's own code, with the look for a card skipped."""

from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CPU_ENV = {"LARIAT_TORCH_DEVICE": "cpu", "LARIAT_DEVICE_SERVER_CPU_OK": "1",
           "LARIAT_PRIME_BATCH": "8"}

TINY_CONFIG = {"scale": 0.002, "genome_seed": 7, "centromeres": True,
               "sa_intv": 32, "env": {}, "reduced": ["scale"]}
MIX = {"pairs_per_bc": 20, "molecules_per_bc": 4, "molecule_len": 50000,
       "read_len": 151, "insert": 200, "insert_sd": 100, "insert_max": 500,
       "indel_rate": 0.0002, "indel_len_p": 0.5, "indel_len_max": 8,
       "error_rate": 0.003,
       "workers": 2, "cli_args": ["-simulated"], "pairs_per_s_hint": 20,
       "limits": {"below_origin_pct": 0.15, "wrong_q30_pct": 0.005}}


def make(tmp: str) -> str:
    """A checkout-shaped tree under ``tmp`` with cells ``tiny.cli``,
    ``tiny.server`` and ``tiny.multihost`` (2 processes); returns its
    root."""
    root = os.path.join(tmp, "tree")
    b = os.path.join(root, "benchmark")
    os.makedirs(os.path.join(b, "configs"), exist_ok=True)
    os.makedirs(os.path.join(b, "traffic"), exist_ok=True)
    shutil.rmtree(os.path.join(b, "metrics"), ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "metrics"), os.path.join(b, "metrics"))
    with open(os.path.join(b, "configs", "tiny.json"), "w") as f:
        json.dump(TINY_CONFIG, f)
    primed = {"LARIAT_PRIME_MIN_FRAC": "0", "LARIAT_PRIME_TAIL_GRACE": "600"}
    mixes = {"cli": dict(MIX, entry="cli", env=primed),
             "server": dict(MIX, entry="server", pairs_per_bc=6, env=primed),
             "multihost": dict(MIX, entry="multihost", env=primed)}
    for name, mix in mixes.items():
        with open(os.path.join(b, "traffic", name + ".json"), "w") as f:
            json.dump(mix, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        real = json.load(f)
    cells = [("cli", 1), ("server", 1), ("multihost", 2)]
    man = dict(real)
    man["configs"] = [{"name": "tiny", "source": "test",
                       "file": "benchmark/configs/tiny.json",
                       "reduced": ["scale"], "why": "test"}]
    man["workloads"] = [{"name": f"tiny.{t}", "config": "tiny",
                         "traffic": t, "chips": n, "why": "test"}
                        for t, n in cells]
    names = [w["name"] for w in man["workloads"]]
    man["per_layer"] = [dict(m, workloads=names) for m in real["per_layer"]]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    return root
