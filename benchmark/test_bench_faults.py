"""The comparison fails what it must. CPU tests that drive whole runs of the
tiny cells through the harness (the look for a card skipped, the port on
its CPU twins) and see ``correct``:

- true for the port as it is, in each entry (CLI, server, multihost);
- false with the port broken underneath, one fault at a time, in a copy of
  the port: an answer altered where it is produced (the BAM writer moves
  each record a base), half of the batch left out (the CLI writes every
  other barcode group but counts them all), a wave that hands back its
  state unchanged (the seed-extension wave's rows as allocated, as if it
  had not run), and the exchange between processes left out (multihost's
  ``all_reduce`` skipped);
- false for the control (``reference/control.py``: the reference in the
  program's place, seeding each read once), on three seeds;
- and a run ended by SIGTERM leaves none of its processes behind.

    python -m pytest benchmark/test_bench_faults.py -q -p no:cacheprovider
"""

from __future__ import annotations

import os
import shutil
import signal
import subprocess
import sys
import time

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import control  # noqa: E402
import tinycell  # noqa: E402
from core import cell, manifest  # noqa: E402

ROOT = os.path.dirname(HERE)

FAULTS = {
    "answer_altered": ("io/bamwriter.py", "        rec.pos = pos\n",
                       "        rec.pos = pos + (pos >= 0)\n"),
    "half_the_batch_left_out": (
        "cli.py", "                    write_packed(bams, packed)\n",
        "                    if next_seq % 2:\n"
        "                        write_packed(bams, packed)\n"),
    "state_unchanged": (
        "ops/sw_extend.py",
        "    return torch.cat([rows, torch.zeros((2, qlen.shape[0]),",
        "    rows = torch.zeros_like(rows)\n"
        "    return torch.cat([rows, torch.zeros((2, qlen.shape[0]),"),
    "exchange_left_out": ("parallel/multihost.py",
                          "        torch.distributed.all_reduce(vals)\n",
                          "        pass\n"),
}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tinycell.make(str(tmp_path_factory.mktemp("bench")))
    return root, manifest.Manifest(root)


def broken_port(tmp, fault) -> str:
    """A copy of the port (package and native library) with ``fault``
    planted; returns the directory to put on the path."""
    path, old, new = FAULTS[fault]
    dst = os.path.join(tmp, "port_" + fault)
    shutil.copytree(os.path.join(ROOT, "lariat_tpu_torch"),
                    os.path.join(dst, "lariat_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(os.path.join(ROOT, "native"), os.path.join(dst, "native"))
    f = os.path.join(dst, "lariat_tpu_torch", path)
    with open(f) as fh:
        src = fh.read()
    assert src.count(old) == 1, (fault, old)
    with open(f, "w") as fh:
        fh.write(src.replace(old, new))
    return dst


def _run(tree, workload, seed, port_root=None):
    root, man = tree
    return cell.run(man, workload, seed, 2, False, time.time(),
                    port_root=port_root or ROOT,
                    device_env=tinycell.CPU_ENV, check_device=False)


@pytest.mark.parametrize("workload", ["tiny.cli", "tiny.server",
                                      "tiny.multihost"])
def test_sound_port_is_correct(tree, workload):
    out = _run(tree, workload, 31)
    res = out["result"]
    assert res["correct"], res["checks"]
    assert res["attempted"] == out["info"]["delivered"] > 0
    assert res["metrics"]["pairs_per_s"]["value"] > 0
    assert res["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("fault,workload,number", [
    ("answer_altered", "tiny.cli", "records_inconsistent"),
    ("half_the_batch_left_out", "tiny.cli", "pairs_lost"),
    ("state_unchanged", "tiny.cli", "below_origin_pct"),
    ("exchange_left_out", "tiny.multihost", "stats_exchange_off"),
])
def test_fault_is_not_correct(tree, tmp_path, fault, workload, number):
    out = _run(tree, workload, 32, port_root=broken_port(str(tmp_path),
                                                         fault))
    res = out["result"]
    assert not res["correct"]
    c = res["checks"][number]
    assert c["value"] > c["limit"], res["checks"]


def _procs_naming(text):
    """Live processes whose command line holds ``text``."""
    out = []
    for d in os.listdir("/proc"):
        try:
            with open(f"/proc/{d}/cmdline", "rb") as f:
                if text.encode() in f.read():
                    out.append(int(d))
        except (OSError, ValueError):
            continue
    return out


def test_terminated_run_leaves_no_process(tree, tmp_path):
    root, _ = tree
    script = (
        "import sys, time\n"
        f"sys.path.insert(0, {HERE!r})\n"
        "import tinycell\n"
        "from core import cell, manifest\n"
        "cell.stop_on_term()\n"
        f"man = manifest.Manifest({root!r})\n"
        "cell.run(man, 'tiny.server', 33, 2, False, time.time(), "
        f"port_root={ROOT!r}, device_env=tinycell.CPU_ENV, "
        "check_device=False)\n")
    work = str(tmp_path / "runs")
    os.makedirs(work)
    child = subprocess.Popen([sys.executable, "-c", script],
                             env=dict(os.environ, TMPDIR=work))
    try:
        deadline = time.time() + 300
        while not _procs_naming(work) or child.pid in _procs_naming(work):
            assert child.poll() is None and time.time() < deadline
            time.sleep(0.2)
        child.send_signal(signal.SIGTERM)
        assert child.wait(timeout=120) == 128 + signal.SIGTERM
    finally:
        child.kill()
        child.wait()
    assert _procs_naming(work) == []


@pytest.mark.parametrize("seed", [41, 42, 43])
def test_control_is_not_correct(tree, seed):
    root, man = tree
    r = control.readings(man, "tiny.cli", seed, 30,
                         cache_root=os.path.join(root, "benchmark", ".cache"))
    assert not r["correct"]
    c = r["checks"]["below_origin_pct"]
    assert c["value"] > 3 * c["limit"]
