"""CPU tests of the per-layer readers on lines the port printed on the card
(``testdata/``, from earlier chip runs: the CLI's summary, the resident
server's log, four multihost processes), and of the manifest: every cell's
configuration, mix and readers are found by name; a name, a unit or a cell
that the manifest lacks is refused.

    python -m pytest benchmark/test_bench_metrics.py -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from core import lines, manifest  # noqa: E402

DATA = os.path.join(HERE, "testdata")
ROOT = os.path.dirname(HERE)


def _text(name):
    with open(os.path.join(DATA, name)) as f:
        return f.read()


def _ctx(texts, server=None, **kw):
    ctx = {"entry": "server" if server else "cli", "texts": texts,
           "summaries": [lines.summary(t) for t in texts], "server": server,
           "window_s": 10.0, "finishes": [0.0] * len(texts),
           "profiles": []}
    ctx.update(kw)
    return ctx


@pytest.fixture(scope="module")
def man():
    return manifest.Manifest(ROOT)


def test_summary_of_a_cli_run():
    s = lines.summary(_text("port_chr20_10k.log"))
    assert s == {"pairs": 10000, "steady_s": 6.2, "pairs_s": 1622.9,
                 "waves": 51, "wave_wall_s": 19.4, "primed_pairs": 10000,
                 "host_pairs": 0, "rfa_wall_s": 0.70, "index_load_s": 1.98}


def test_readers_on_a_cli_run(man):
    ctx = _ctx([_text("port_chr20_10k.log")])
    assert man.reader("primed_share").read(ctx) == 100.0
    assert man.reader("prime_wave_s_per_kpair").read(ctx) == \
        pytest.approx(1.94)
    assert man.reader("rfa_s_per_kpair").read(ctx) == pytest.approx(0.07)
    assert man.reader("index_load_s").read(ctx) == 1.98
    ctx.update(delivered=10000, cpu_s=250.0)
    assert man.reader("host_cpu_s_per_kpair").read(ctx) == 25.0
    for name in ("server_ready_s", "seed_collect_ms_per_kpair",
                 "kernel_ms_per_kpair.dp",
                 "kernel_ms_per_kpair.seed", "device_idle_pct"):
        assert man.reader(name).read(ctx) is None, name


def test_readers_on_four_multihost_processes(man):
    texts = [_text(f"four_chr20_1m_c_{h}.log") for h in range(4)]
    ctx = _ctx(texts)
    sums = [lines.summary(t) for t in texts]
    primed = sum(s["primed_pairs"] for s in sums)
    host = sum(s["host_pairs"] for s in sums)
    assert man.reader("primed_share").read(ctx) == pytest.approx(
        100.0 * primed / (primed + host))
    assert man.reader("rfa_s_per_kpair").read(ctx) == pytest.approx(
        sum(s["rfa_wall_s"] for s in sums) / 1000.0)
    mh = lines.multihost(texts[0])
    assert mh["local_stats"][0] == 500000 and mh["global_stats"][0] == \
        2000000


def test_readers_on_a_server_run(man):
    srv = _text("four_hg38_200k_d_server_0.log")
    s = lines.server(srv)
    assert (s["imports_s"], s["load_s"], s["upload_s"], s["prewarm_s"]) == \
        (8.105, 0.797, 1.403, 2.160)
    assert s["path"]["seed_device_batches"] == 17
    ctx = _ctx([_text("four_hg38_200k_d_0.log")], server=srv)
    primed = ctx["summaries"][0]["primed_pairs"]
    assert man.reader("server_ready_s").read(ctx) == pytest.approx(12.465)
    assert man.reader("prime_wave_s_per_kpair").read(ctx) == \
        pytest.approx(3.029 / (primed / 1000.0))
    # no [seedtrace] lines in that log: nothing to read
    assert man.reader("seed_collect_ms_per_kpair").read(ctx) is None
    # the prewarm's own collect prints before the prewarm line: left out
    head, tail = srv.split("[device_server] prewarm", 1)
    traced = head + "[seedtrace] merge+sort       400.0ms\n" + \
        "[device_server] prewarm" + tail + "".join(
            f"[seedtrace] {tag:14s} {ms:7.1f}ms\n" for tag, ms in
            (("r1+r3 dispatch", 3.5), ("r1 pack dl", 10.25),
             ("merge+sort", 9.1), ("sa walk", 2.0)))
    ctx = _ctx([_text("four_hg38_200k_d_0.log")], server=traced)
    assert man.reader("seed_collect_ms_per_kpair").read(ctx) == \
        pytest.approx(24.8 / (primed / 1000.0), rel=1e-3)


def test_device_readers_on_a_profile(man):
    prof = {"kernels": {"void sw_extend_kernel<1>(...)": [0.002, 4],
                        "sw_global_kernel": [0.001, 2],
                        "twoptr_kernel": [0.004, 2],
                        "Memcpy HtoD": [0.5, 9]}}
    ctx = _ctx([_text("port_chr20_10k.log")], profiles=[prof], busy_s=0.25)
    assert man.reader("kernel_ms_per_kpair.dp").read(ctx) == \
        pytest.approx(3.0 / 10.0)
    assert man.reader("device_idle_pct").read(ctx) == pytest.approx(97.5)


def test_every_cell_found_by_name(man):
    for name, wl in man.workloads.items():
        man.config(wl["config"])
        tr = man.traffic(wl["traffic"])
        assert tr["entry"] in ("cli", "server", "multihost")
        assert set(tr["limits"]) == {"below_origin_pct", "wrong_q30_pct"}
        for kind in ("end_to_end", "per_layer"):
            assert man.metric_names(name, kind)
        for m in man.metric_names(name, "per_layer"):
            assert callable(man.reader(m).read)


def test_refuses_what_the_manifest_lacks(man, tmp_path):
    with pytest.raises(manifest.ManifestError):
        man.workload("chr20sim.nosuch")
    with pytest.raises(manifest.ManifestError):
        man.reader("nosuch_metric")
    with pytest.raises(manifest.ManifestError):
        man.traffic("no/such")
    root = tmp_path / "tree"
    shutil.copytree(os.path.join(HERE, "metrics"),
                    root / "benchmark" / "metrics")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        d = json.load(f)
    d["per_layer"][0]["unit"] = "pairs"
    (root / "BENCHMARK.json").write_text(json.dumps(d))
    other = manifest.Manifest(str(root))
    with pytest.raises(manifest.ManifestError):
        other.reader(d["per_layer"][0]["name"])
    d["workloads"][0]["name"] = "bad name"
    (root / "BENCHMARK.json").write_text(json.dumps(d))
    with pytest.raises(manifest.ManifestError):
        manifest.Manifest(str(root))


def test_cpu_of_a_process_tree():
    """A child's CPU counts in its parent's tree while it lives, and the
    same seconds stay there, as reaped time, once it has been waited on."""
    import subprocess
    import time
    from core import cpu
    burn = "import time\nt = time.process_time()\n" \
        "while time.process_time() - t < 0.6: pass\ntime.sleep(30)"
    before = cpu.tree_cpu_s(os.getpid())
    child = subprocess.Popen([sys.executable, "-c", burn])
    try:
        deadline = time.time() + 20
        while cpu.tree_cpu_s(child.pid) < 0.6 and time.time() < deadline:
            time.sleep(0.05)
        live = cpu.tree_cpu_s(os.getpid()) - before
    finally:
        child.kill()
        child.wait()
    reaped = cpu.tree_cpu_s(os.getpid()) - before
    assert 0.55 <= live <= reaped
    assert cpu.tree_cpu_s(2 ** 22 + 1) is None


def test_busy_and_gaps_inside_the_window():
    from core.cell import busy_in, gaps_in, short
    iv = [[0.5, 1.5, 0], [2.0, 3.0, 1], [3.5, 5.0, 0]]
    assert busy_in(iv, 1.0, 4.0) == pytest.approx(0.5 + 1.0 + 0.5)
    assert gaps_in(iv, ["a", "b"], 1.0, 4.0) == [
        ("idle after a", pytest.approx(0.5)),
        ("idle after b", pytest.approx(0.5))]
    assert gaps_in(iv, ["a", "b"], 0.0, 6.0)[-1] == (
        "idle after a, to the window's close", pytest.approx(1.0))
    assert short("void (anonymous namespace)::sw_extend_kernel<(anonymous "
                 "namespace)::DescFeed<int> >(int)") == "sw_extend_kernel"
    assert short("Memcpy DtoH (Device -> Pageable)") == "Memcpy DtoH"
