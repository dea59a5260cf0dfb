"""The port's CLI end to end on the explicit CPU device against host-native
lariat_tpu (BAM records equal), the port's freedom from JAX and from the
JAX package, and its refusal to run without CUDA unless the CPU was asked
for."""

import ast
import glob
import gzip
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import torch

from lariat_tpu.io.bamread import BamFile

torch.set_num_threads(1)

BASES = np.frombuffer(b"ACGT", np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(tmp_path):
    """60 kb genome and 5 barcodes x 7 pairs (tests/test_cli.py's
    device-primed fixture)."""
    rng = np.random.default_rng(9)
    genome = BASES[rng.integers(0, 4, 60000)].tobytes()
    fasta = tmp_path / "g.fa"
    with open(fasta, "w") as f:
        f.write(">chr1\n")
        s = genome.decode()
        for i in range(0, len(s), 70):
            f.write(s[i:i + 70] + "\n")
    fq = tmp_path / "r.fastq.gz"
    qual = "I" * 100
    with gzip.open(fq, "wt") as f:
        for b in range(5):
            bc = f"AAACAGAGAAAG{'ACGT'[b % 4]}{'ACGT'[b // 4]}-1"
            for i in range(7):
                pos = 1500 + b * 9000 + i * 310
                r1 = bytearray(genome[pos:pos + 100])
                r1[int(rng.integers(0, 100))] = BASES[int(rng.integers(0, 4))]
                r2 = genome[pos + 200:pos + 300].translate(COMP)[::-1]
                f.write(f"@p{b}:r{i} x\n{r1.decode()}\n{qual}\n"
                        f"{r2.decode()}\n{qual}\n"
                        f"{bc},{bc.split('-')[0]}\nJJJJJJJJJJJJJJ\n"
                        f"ACGTACGT\nIIIIIIII\n")
    return fasta, fq


def _env(**extra):
    # a long tail grace: the end-of-input batch is primed, never host-routed
    # on a slow CPU, so every pair of these runs is primed
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1",
           "LARIAT_PRIME_TAIL_GRACE": "600"}
    env.pop("LARIAT_TORCH_DEVICE", None)
    env.pop("LARIAT_DEVICE_SEED", None)
    env.update(extra)
    return env


def test_port_cli_cpu_matches_host_native(tmp_path):
    fasta, fq = _inputs(tmp_path)
    runs = {"host": ("lariat_tpu.cli", "off", {}),
            # the port's host path: chip_smoke.py's host-native reference
            "port_off": ("lariat_tpu_torch.cli", "off", {}),
            "port": ("lariat_tpu_torch.cli", "on",
                     {"LARIAT_TORCH_DEVICE": "cpu"}),
            "port_seed": ("lariat_tpu_torch.cli", "on",
                          {"LARIAT_TORCH_DEVICE": "cpu",
                           "LARIAT_DEVICE_SEED": "1"})}
    logs = {}
    for name, (mod, mode, extra) in runs.items():
        r = subprocess.run(
            [sys.executable, "-m", mod, "-reads", str(fq), "-genome",
             str(fasta), "-output", str(tmp_path / name), "-threads", "2",
             "-use_device", mode, "-first_chunk"],
            capture_output=True, text=True, cwd=REPO, env=_env(**extra),
            timeout=600)
        assert r.returncode == 0, r.stderr[-2000:]
        logs[name] = r.stdout
    for port in ("port", "port_seed"):
        assert "primed pairs 35  host pairs 0" in logs[port], logs[port]
        assert "kernel launches: " in logs[port]
        assert '"smem_twoptr": 0' in logs[port]       # twins on the CPU
    bams = sorted(p.split("/")[-1]
                  for p in glob.glob(str(tmp_path / "host" / "*.bam")))
    assert "primed pairs" not in logs["port_off"]
    for port in ("port_off", "port", "port_seed"):
        assert bams and bams == sorted(
            p.split("/")[-1]
            for p in glob.glob(str(tmp_path / port / "*.bam")))
        for k in bams:   # @PG CL differs: compare records past the header
            assert list(BamFile(str(tmp_path / "host" / k))) == \
                list(BamFile(str(tmp_path / port / k))), (port, k)


def test_port_imports_no_jax(tmp_path):
    """The package, its engine, its CLI and its tools import and prime
    without JAX and without any module of the JAX package, with host
    seeding and with device seeding."""
    fasta, _ = _inputs(tmp_path)
    code = textwrap.dedent(f"""
        import sys
        import lariat_tpu_torch, lariat_tpu_torch.cli
        import lariat_tpu_torch.tools.extend_ablate
        import lariat_tpu_torch.tools.kernel_roofline
        import lariat_tpu_torch.tools.prime_profile
        import lariat_tpu_torch.tools.device_step
        import lariat_tpu_torch.parallel.align_step
        import lariat_tpu_torch.parallel.device_server
        from lariat_tpu_torch.align.batch_engine import \\
            TorchBatchAlignmentEngine
        from lariat_tpu_torch.cli import load_reference
        from lariat_tpu_torch.io.fastq import FastQRecord
        fm = load_reference({str(fasta)!r})
        g = fm.fetch_fmd(1000, 1400).tobytes().translate(
            bytes.maketrans(bytes([0, 1, 2, 3]), b"ACGT"))
        comp = bytes.maketrans(b"ACGT", b"TGCA")
        rec = FastQRecord(read1=g[:100], read_qual1=b"I" * 100,
                          read2=g[250:350].translate(comp)[::-1],
                          read_qual2=b"I" * 100,
                          barcode10x=b"AAACAGAGAAAGAT-1",
                          barcode10x_qual=b"J" * 14,
                          raw_barcode10x=b"AAACAGAGAAAGAT",
                          barcode=b"ACGTACGT", barcode_qual=b"IIIIIIII",
                          read_info="x")
        eng = TorchBatchAlignmentEngine(fm, device="cpu")
        (p,) = eng.prime_regions([rec], 30)
        assert p[2] and p[0] and p[1], p
        import os
        os.environ["LARIAT_DEVICE_SEED"] = "1"
        eng = TorchBatchAlignmentEngine(fm, device="cpu")
        assert eng.prime_regions([rec], 30) == [p]
        assert eng._seed_state is not None
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "lariat_tpu")]
        assert not bad, bad
        print("ok")
        """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=_env(), timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


def _imported_modules(path):
    """Every module name an import statement of ``path`` names (relative
    imports excluded)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module


def test_port_sources_import_no_jax_package():
    """No module of lariat_tpu_torch, and not chip_smoke.py, has an import
    of lariat_tpu or jax, at top level or inside a function (chip_smoke
    runs the reference CLI only as a subprocess)."""
    paths = glob.glob(os.path.join(REPO, "lariat_tpu_torch", "**", "*.py"),
                      recursive=True)
    paths.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(paths) > 40
    # the device align step's modules are scanned too
    rel = {os.path.relpath(p, REPO) for p in paths}
    assert {"lariat_tpu_torch/parallel/align_step.py",
            "lariat_tpu_torch/ops/fm_batch.py",
            "lariat_tpu_torch/tools/device_step.py"} <= rel
    bad = [(os.path.relpath(p, REPO), m) for p in paths
           for m in _imported_modules(p)
           if m.split(".")[0] in ("lariat_tpu", "jax")]
    assert not bad, bad


def test_port_cli_cpu_loads_no_jax_package(tmp_path):
    """A whole CPU run of the port's CLI, workers included, with stand-ins
    for jax and lariat_tpu that fail on import ahead of the real ones on
    the path: it completes and its process ends with neither loaded."""
    fasta, fq = _inputs(tmp_path)
    fake = tmp_path / "fake"
    for name in ("jax", "lariat_tpu"):
        (fake / name).mkdir(parents=True)
        (fake / name / "__init__.py").write_text(
            f"raise ImportError('the port imported {name}')\n")
    code = textwrap.dedent(f"""
        import sys
        from lariat_tpu_torch import cli
        rc = cli.main(["-reads", {str(fq)!r}, "-genome", {str(fasta)!r},
                       "-output", {str(tmp_path / "o")!r}, "-threads", "2",
                       "-use_device", "on", "-first_chunk"])
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "lariat_tpu")]
        assert rc == 0 and not bad, (rc, bad)
        print("ok")
        """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=tmp_path,
                       env=_env(LARIAT_TORCH_DEVICE="cpu",
                                PYTHONPATH=f"{fake}{os.pathsep}{REPO}"),
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().endswith("ok"), r.stdout[-2000:]
    assert "primed pairs 35  host pairs 0" in r.stdout
    assert glob.glob(str(tmp_path / "o" / "*.bam"))


class _FakeEngine:
    """prime_regions stand-in: one marker per read pair, or a failure; it
    keeps the most passes it ever ran at once."""

    def __init__(self, fail_at=None):
        self.calls = 0
        self.fail_at = fail_at
        self.abort_prime = False
        self.running = self.most = 0
        self._lock = threading.Lock()

    def prime_regions(self, recs, score_delta):
        with self._lock:
            self.calls += 1
            call = self.calls
            self.running += 1
            self.most = max(self.most, self.running)
        try:
            time.sleep(0.002)
            if call == self.fail_at:
                raise ValueError("wave failed")
            return [("primed", r) for r in recs]
        finally:
            with self._lock:
                self.running -= 1


def test_primed_iter_primes_every_batch_in_bounded_flight(monkeypatch):
    """Every item comes back once, a primed one with one prime per pair;
    never more passes run at once than there are priming threads, and the
    batches they cannot take go to the host."""
    from lariat_tpu.config import RFAConfig
    from lariat_tpu_torch import cli
    monkeypatch.setattr(cli, "_batch_target", lambda rate, fixed=None: 3)

    def work():
        for i in range(40):
            yield [f"r{i}a", f"r{i}b"], True

    stats = {"primed_pairs": 0, "host_pairs": 0}
    eng = _FakeEngine()
    out, primed = [], 0
    for seq, item in cli._primed_iter(work(), eng, RFAConfig(), 2, stats):
        out.append(seq)
        if len(item) == 3:
            reads, unique, primes = item
            assert unique and primes == [("primed", r) for r in reads]
            primed += len(reads)
    assert sorted(out) == list(range(40))
    assert stats["primed_pairs"] == primed > 0
    assert stats["primed_pairs"] + stats["host_pairs"] == 80
    assert eng.most <= 2


def test_primed_iter_stops_and_reports_a_failed_wave(monkeypatch):
    """A pass that raises ends the feed after the batches before it (in
    submission order), and the error is kept for run() to re-raise: it is
    never host-routed."""
    from lariat_tpu.config import RFAConfig
    from lariat_tpu_torch import cli
    monkeypatch.setattr(cli, "_batch_target", lambda rate, fixed=None: 2)
    work = (([f"r{i}"], True) for i in range(20))
    stats = {"primed_pairs": 0, "host_pairs": 0}
    out = list(cli._primed_iter(work, _FakeEngine(fail_at=3), RFAConfig(),
                                16, stats))
    assert len(out) == 4                        # the two batches before it
    assert all(len(item) == 3 for _, item in out)
    assert isinstance(stats["error"], ValueError)
    assert stats["host_pairs"] == 0


def test_port_cli_refuses_without_cuda(tmp_path):
    """-use_device on with the default device (cuda) and no CUDA: the run
    fails instead of dropping to the CPU."""
    if torch.cuda.is_available():
        import pytest
        pytest.skip("a CUDA device is present")
    fasta, fq = _inputs(tmp_path)
    r = subprocess.run(
        [sys.executable, "-m", "lariat_tpu_torch.cli", "-reads", str(fq),
         "-genome", str(fasta), "-output", str(tmp_path / "o"), "-threads",
         "2", "-use_device", "auto", "-first_chunk"],
        capture_output=True, text=True, cwd=REPO, env=_env(), timeout=300)
    assert r.returncode != 0
    assert "CUDA" in r.stderr and "primed pairs" not in r.stdout
