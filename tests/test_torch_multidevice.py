"""The wave split over devices (the reference's mesh and ``_shard_wave``),
on the CPU: ``_split_wave``'s blocks and inverse, the split engine against
the single-device engine and the JAX package's engine, the dry run, the
launch's device rule and the wave trace. The ``cuda`` cases run only on
a card."""

import dataclasses
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from lariat_tpu.align import batch_engine as jbe
from lariat_tpu.cli import _prime_group as jax_prime_group
from lariat_tpu.config import RFAConfig
from lariat_tpu.index import fmindex as jfmindex
from lariat_tpu.io.fastq import FastQRecord as JaxRecord
from lariat_tpu.parallel import host_pipeline as JHP
from lariat_tpu_torch.align import batch_engine as tbe
from lariat_tpu_torch.index import fmindex as tfmindex
from lariat_tpu_torch.ops import _build
from lariat_tpu_torch.tools import entry

from test_torch_sw_extend import cuda_device  # noqa: F401

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """A 200 kb random genome with a 2 kb segdup, its FASTA, and both
    packages' indexes of it."""
    rng = np.random.default_rng(21)
    g = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 200_000)].copy()
    g[120_000:122_000] = g[30_000:32_000]
    fasta = tmp_path_factory.mktemp("mdev") / "g.fa"
    s = g.tobytes().decode()
    with open(fasta, "w") as f:
        f.write(">chrT\n")
        for i in range(0, len(s), 70):
            f.write(s[i:i + 70] + "\n")
    return (g.tobytes(), str(fasta), tfmindex.build_index(str(fasta)),
            jfmindex.build_index(str(fasta)))


@pytest.fixture(scope="module")
def engine_runs(genome):
    """16 barcodes x 16 pairs primed in four groups and packed, by the
    single-device port engine, the port engine split over 2 and 3 CPU
    devices and the JAX package's engine on its XLA path, no mesh."""
    g, _, tfm, jfm = genome
    sets = entry.sim_pairs(g, n_bcs=16, pairs_per_bc=16, seed=5)
    cfg = RFAConfig()
    out = {}
    for key, devices in (("single", None), ("split2", ["cpu"] * 2),
                         ("split3", ["cpu"] * 3)):
        eng = (tbe.TorchBatchAlignmentEngine(tfm, device="cpu")
               if devices is None
               else tbe.TorchBatchAlignmentEngine(tfm, devices=devices))
        primed = entry.prime_groups(eng, sets, cfg)
        out[key] = (eng, primed, entry.pack_primed(eng, tfm, primed, cfg))
    jsets = [[JaxRecord(**dataclasses.asdict(r)) for r in recs]
             for recs in sets]
    jeng = jbe.BatchAlignmentEngine(jfm, use_pallas=False)
    step = len(jsets) // 4
    jprimed = []
    for s in range(0, len(jsets), step):
        jprimed.extend(jax_prime_group(
            jeng, [(recs, True) for recs in jsets[s:s + step]], cfg))
    saved = dict(JHP._G)
    JHP._G.update(engine=jeng, config=cfg, centromeres={},
                  tid={c.name: i for i, c in enumerate(jfm.contigs)},
                  debug_tags=False, simulated=False)
    try:
        out["jax"] = (jeng, jprimed, [JHP._run_one(w) for w in jprimed])
    finally:
        JHP._G.clear()
        JHP._G.update(saved)
    return out


def _flat_primes(primed):
    """Work items -> plain values: each pair's (regs1, regs2, flag, sras1,
    sras2) as tuples of dataclass fields (the packages' classes differ)."""
    rows = lambda objs: [dataclasses.astuple(o) for o in objs]  # noqa: E731
    return [[(rows(r1), rows(r2), flag, rows(s1), rows(s2))
             for r1, r2, flag, s1, s2 in primes]
            for _, _, primes in primed]


def _packed(packed):
    return [(p.bc_sorted, p.buckets, p.n_reads) for p in packed]


class _Splitter:
    """The engine's ``_split_wave`` without an index behind it."""
    _split_wave = tbe.TorchBatchAlignmentEngine._split_wave

    def __init__(self, n):
        import threading
        self.devices = [torch.device("cpu")] * n
        self.device = self.devices[0]
        self._stats_lock = threading.Lock()
        self.shard_waves = 0
        self.shard_log = []


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("which", ["0", "1", "n-1", "n", "127", "1000"])
def test_split_wave_covers_every_task_once(n, which):
    B = {"n-1": n - 1, "n": n}.get(which) if which[0] == "n" else int(which)
    sp = _Splitter(n)
    blocks, inv = sp._split_wave(B, real=min(B, 5))
    assert [dev for dev, _ in blocks] == sp.devices
    rows = [np.asarray(idx) for _, idx in blocks]
    cat = np.concatenate(rows) if rows else np.zeros(0, np.int64)
    assert sorted(cat.tolist()) == list(range(B))      # every task once
    for d, r in enumerate(rows):
        assert (r % n == d).all() and (np.diff(r) > 0).all()
    sizes = [len(r) for r in rows]
    assert max(sizes) - min(sizes) <= 1
    if n == 1:
        assert inv is None and sp.shard_waves == 0 and not sp.shard_log
    else:
        assert (cat[inv] == np.arange(B)).all()         # back to task order
        assert sp.shard_waves == 1
        assert sp.shard_log == [{"Bp": B, "n_dev": n, "real": min(B, 5)}]


@pytest.mark.parametrize("split", ["split2", "split3"])
def test_split_engine_matches_single_and_jax(engine_runs, split):
    eng, primed, packed = engine_runs[split]
    single = engine_runs["single"]
    jax_run = engine_runs["jax"]
    assert eng.shard_waves >= 4 and len(eng.shard_log) == eng.shard_waves
    assert all(r["n_dev"] == len(eng.devices) and 0 < r["real"] <= r["Bp"]
               for r in eng.shard_log)
    assert single[0].shard_waves == 0
    assert _flat_primes(primed) == _flat_primes(single[1])
    assert _flat_primes(primed) == _flat_primes(jax_run[1])
    assert _packed(packed) == _packed(single[2]) == _packed(jax_run[2])
    assert sum(p.n_reads for p in packed) == 16 * 16
    # one copy of the pac a distinct device
    assert list(eng._pac_res) == [torch.device("cpu")]


def test_dryrun_multichip_on_two_cpu_devices(capsys):
    got = entry.dryrun_multichip(2, devices=["cpu"] * 2)
    assert got["shard_waves"] >= 16 and got["records"] == 4096
    assert got["distinct"] == ["cpu"] and got["barcodes"] == 64
    assert got["peak_split"] == {}          # card memory: no card here
    lo, hi = min(got["per_dev_tasks"]), max(got["per_dev_tasks"])
    assert 0 < lo and hi <= 2 * lo
    assert "dryrun_multichip OK: 2 devices" in capsys.readouterr().out


def test_dryrun_multichip_takes_no_substitute():
    """Without CUDA (or with fewer cards) the dry run raises before it
    builds anything; it never falls back to the CPU or a repeated card."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= 64:
        pytest.skip("64 cards")
    with pytest.raises(RuntimeError, match="CUDA devices"):
        entry.dryrun_multichip(64)
    with pytest.raises(ValueError, match="devices given"):
        entry.dryrun_multichip(3, devices=["cpu"] * 2)


def test_engine_takes_device_or_devices(genome):
    tfm = genome[2]
    with pytest.raises(ValueError):
        tbe.TorchBatchAlignmentEngine(tfm, device="cpu", devices=["cpu"])
    with pytest.raises(ValueError):
        tbe.TorchBatchAlignmentEngine(tfm, devices=[])
    eng = tbe.TorchBatchAlignmentEngine(tfm, devices=["cpu"])
    assert eng.devices == [torch.device("cpu")] == [eng.device]


def test_launch_refuses_cpu_tensors():
    """A launch takes its device from its tensors: CPU tensors, or none,
    raise before anything is built or loaded."""
    with pytest.raises(ValueError, match="one CUDA device"):
        _build.launch("sw_local", torch.zeros(4, dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="none"):
        _build.launch("sw_local", 4, 5)


def test_wtrace_line_is_the_reference_format(capsys):
    args = ("r2a.d", (2048, 192, 384), 0.0123, 0.4567, 1.5, 98304, 2621)
    jbe._wtrace(*args)
    want = capsys.readouterr().out
    tbe._wtrace(*args)
    assert capsys.readouterr().out == want


_TRACE_RUN = textwrap.dedent("""
    import sys, torch
    torch.set_num_threads(1)
    from lariat_tpu_torch.align.batch_engine import TorchBatchAlignmentEngine
    from lariat_tpu_torch.config import RFAConfig
    from lariat_tpu_torch.index import fmindex
    from lariat_tpu_torch.tools import entry
    fm = fmindex.build_index(sys.argv[1])
    sets = entry.sim_pairs(open(sys.argv[2], "rb").read(), n_bcs=4,
                           pairs_per_bc=16, seed=3)
    eng = TorchBatchAlignmentEngine(fm, devices=["cpu"] * 2)
    entry.prime_groups(eng, sets, RFAConfig())
    print("waves", eng.wave_stats["n"], "split", eng.shard_waves)
    """)


def _trace_run(genome, tmp_path, **env):
    g, fasta = genome[0], genome[1]
    raw = tmp_path / "g.raw"
    raw.write_bytes(g)
    e = {k: v for k, v in os.environ.items()
         if k not in ("LARIAT_WAVE_TRACE", "LARIAT_WAVE_DEBUG")}
    r = subprocess.run([sys.executable, "-c", _TRACE_RUN, fasta, str(raw)],
                       capture_output=True, text=True, cwd=REPO,
                       env={**e, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
                            **env}, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    m = re.search(r"waves (\d+) split (\d+)", r.stdout)
    return r.stdout.splitlines(), int(m.group(1)), int(m.group(2))


def test_wave_trace_lines(genome, tmp_path):
    """LARIAT_WAVE_TRACE=1: one [wtrace] line a wave at each site, in the
    reference's format; LARIAT_WAVE_DEBUG=1: one [wave] line an extension
    wave. Unset: neither."""
    lines, waves, split = _trace_run(genome, tmp_path,
                                     LARIAT_WAVE_TRACE="1",
                                     LARIAT_WAVE_DEBUG="1")
    pat = re.compile(r"^\[wtrace\] (ext  |loc  |r2a\.d|r2a\.f) (.{18}) "
                     r"build +\d+ms disp +\d+ms dl +\d+ms "
                     r"up +\d+\.\d\dMB dn +\d+\.\d\dMB$")
    tr = [pat.match(s) for s in lines if s.startswith("[wtrace]")]
    assert tr and all(tr), [s for s in lines if s.startswith("[wtrace]")]
    sites = [m.group(1).strip() for m in tr]
    n = {k: sites.count(k) for k in ("ext", "loc", "r2a.d", "r2a.f")}
    # every wave the engine counts has its line: extension and rescue
    # waves, and each reg2aln dispatch with its download
    assert n["ext"] and n["loc"] and n["r2a.d"]
    assert n["ext"] + n["loc"] + n["r2a.d"] == waves
    assert n["r2a.f"] == n["r2a.d"]
    # every extension and reg2aln wave split, rescue waves with a DP task
    assert n["ext"] + n["r2a.d"] <= split <= waves
    dbg = [s for s in lines if s.startswith("[wave] ")]
    assert len(dbg) == n["ext"]
    assert all(re.match(r"^\[wave\] phase=\d B=\d+ q=\d+ t=\d+ \d+\.\d\ds$",
                        s) for s in dbg)
    lines, waves, _ = _trace_run(genome, tmp_path)
    assert waves > 0
    assert not [s for s in lines if s.startswith(("[wtrace]", "[wave]"))]


@pytest.mark.cuda
def test_launch_refuses_tensors_on_two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    a = torch.zeros(4, dtype=torch.int32, device="cuda:0")
    b = torch.zeros(4, dtype=torch.int32, device="cuda:1")
    with pytest.raises(ValueError, match="one CUDA device"):
        _build.launch("sw_local", a, b, 4)


@pytest.mark.cuda
def test_split_engine_on_one_card_matches_single(genome, cuda_device):  # noqa: F811
    g, _, tfm, _ = genome
    sets = entry.sim_pairs(g, n_bcs=16, pairs_per_bc=16, seed=5)
    cfg = RFAConfig()
    runs = []
    for devices in ([cuda_device], [cuda_device] * 3):
        eng = tbe.TorchBatchAlignmentEngine(tfm, devices=devices)
        primed = entry.prime_groups(eng, sets, cfg)
        runs.append((eng, primed, entry.pack_primed(eng, tfm, primed, cfg)))
    assert runs[1][0].shard_waves >= 4
    assert _flat_primes(runs[0][1]) == _flat_primes(runs[1][1])
    assert _packed(runs[0][2]) == _packed(runs[1][2])
