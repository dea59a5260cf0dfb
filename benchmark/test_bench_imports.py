"""CPU tests of what the benchmark loads and of its refusals:

- the harness, the reference, the control and the launcher load no module
  whose top-level name (the part before the first dot, compared whole) is
  ``jax``, ``jaxlib``, ``flax`` or ``lariat_tpu``;
- neither does a tiny ``-use_device off`` CLI run under the launcher, by
  its ``-X importtime`` lines and by the launcher's own look at
  ``sys.modules``;
- a run where there is no card, or in a directory holding only
  ``BENCHMARK.json`` and ``benchmark/``, exits nonzero and prints no
  result line.

    python -m pytest benchmark/test_bench_imports.py -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)

import tinycell  # noqa: E402
from gen import genome, sim_reads  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "lariat_tpu"}


def _py(code: str, **kw) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=HERE, env=env,
                          capture_output=True, text=True, **kw)


def test_harness_reference_launcher_load_no_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "import run, control, launch, tinycell;"
            "from core import cell, manifest, lines, kernels, counts;"
            "from reference import bam, bamwrite, judge, control as c2;"
            "from gen import genome, sim_reads, shards;"
            "import glob, importlib.util as u;"
            "[u.spec_from_file_location('m', p).loader.exec_module("
            "u.module_from_spec(u.spec_from_file_location('m', p)))"
            " for p in glob.glob('metrics/*.py')];"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    r = _py(code)
    assert r.returncode == 0, r.stderr
    loaded = set(eval(r.stdout.strip().splitlines()[-1]))
    assert not loaded & FORBIDDEN
    assert "lariat_tpu_torch" not in loaded


def test_cli_run_loads_no_jax(tmp_path):
    cache = str(tmp_path / "g")
    genome.ensure({"scale": 0.002, "genome_seed": 7, "centromeres": True,
                   "sa_intv": 32}, cache,
                  env=dict(os.environ, PYTHONPATH=ROOT))
    codes, contigs = genome.load_codes(cache)
    reads = sim_reads.simulate(codes, contigs, 3, dict(
        tinycell.MIX, pairs_per_bc=8), 1)
    fq = str(tmp_path / "r.fastq")
    sim_reads.write_fastq(fq, reads)
    side = str(tmp_path / "side.json")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, "-X", "importtime", os.path.join(HERE, "launch.py"),
         "--side", side, "--module", "lariat_tpu_torch.cli", "--",
         "-reads", fq, "-genome", os.path.join(cache, "genome.fa"),
         "-output", str(tmp_path / "out"), "-threads", "2",
         "-use_device", "off"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "Processed 24 read pairs" in r.stdout
    names = set(re.findall(r"^import time:\s+\d+ \|\s+\d+ \|\s+(\S+)",
                           r.stderr, re.M))
    tops = {n.strip().split(".")[0] for n in names}
    assert "lariat_tpu_torch" in tops and "torch" in tops
    assert not tops & FORBIDDEN
    with open(side) as f:
        s = json.load(f)
    assert s["rc"] == 0 and s["forbidden"] == []


def _no_result(r):
    assert r.returncode != 0
    assert not [ln for ln in r.stdout.splitlines() if ln.startswith("{")]


def test_no_card_no_result():
    import torch
    assert not torch.cuda.is_available()   # a CPU-only host
    r = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         "hg38sim_cut08.server_devseed", "--seed", "1", "--seconds", "1",
         "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    _no_result(r)
    assert "CUDA" in r.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "hg38sim_cut08.server_devseed", "--seed", "1", "--seconds", "1",
         "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    _no_result(r)
