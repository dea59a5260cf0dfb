"""The port's hg38 data tools on the CPU against the JAX package's:
build_big_index, npz_to_dir and the generator's index build write the
same files on a tiny FASTA; the generator's lock makes a second generator
wait and then build nothing; align_repl prints the reference REPL's
candidates; the bench regenerates data_big/ unless told not to."""

import filecmp
import importlib.util
import os
import re
import subprocess
import sys
import time

import numpy as np

from lariat_tpu_torch.tools import bench
from lariat_tpu_torch.tools import build_big_index as t_bbi
from lariat_tpu_torch.tools import gen_data_big as t_gen
from lariat_tpu_torch.tools import npz_to_dir as t_n2d

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN_OUTPUTS = ("chr20sim.fa.lariat.d", "sim1m_chr20.fastq.gz",
               "hg38sim.fa.lariat.d", "sim200k.fastq.gz", "sim50k.fastq.gz",
               "sim10k.fastq.gz")


def _reference_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _fasta(path, seed=4):
    """Two contigs, one with a run of N (an ambiguity region)."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    a = bases[rng.integers(0, 4, 9000)].tobytes()
    b = bases[rng.integers(0, 4, 7000)].tobytes()
    b = b[:3000] + b"N" * 40 + b[3040:]
    with open(path, "w") as f:
        for name, s in (("chrA", a), ("chrB", b)):
            f.write(f">{name}\n")
            for i in range(0, len(s), 60):
                f.write(s[i:i + 60].decode() + "\n")
    return str(path)


def _two_fastas(tmp_path):
    """The same FASTA in two directories: one for each package."""
    out = []
    for d in ("port", "ref"):
        (tmp_path / d).mkdir()
        out.append(_fasta(tmp_path / d / "g.fa"))
    return out


def _same_npz(a, b):
    za, zb = np.load(a), np.load(b)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        assert za[k].dtype == zb[k].dtype, k
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def _same_dir(a, b):
    """Two .lariat.d directories: the same files, the .npy byte for byte,
    meta.npz member by member (zip entries carry their write time)."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and "meta.npz" in names
    for n in names:
        if n.endswith(".npz"):
            _same_npz(os.path.join(a, n), os.path.join(b, n))
        else:
            assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                               shallow=False), n


def test_build_big_index_and_npz_to_dir_match_reference(tmp_path):
    port_fa, ref_fa = _two_fastas(tmp_path)
    assert t_bbi.main([port_fa, "--sa-intv", "16"]) == 0
    assert _reference_tool("build_big_index").main(
        [ref_fa, "--sa-intv", "16"]) == 0
    _same_npz(port_fa + ".lariat.npz", ref_fa + ".lariat.npz")
    assert t_n2d.main([port_fa]) == 0
    assert _reference_tool("npz_to_dir").main([ref_fa]) == 0
    _same_dir(port_fa + ".lariat.d", ref_fa + ".lariat.d")


BUILD_LINE = re.compile(r"build (\S+): [0-9.]+ s, peak RSS [0-9.]+ GiB, "
                        r"l_pac=[0-9,]+$", re.M)


def test_generator_build_matches_reference(tmp_path, capsys):
    port_fa, ref_fa = _two_fastas(tmp_path)
    t_gen.build(port_fa)
    assert BUILD_LINE.findall(capsys.readouterr().out) == [port_fa]
    _reference_tool("gen_data_big").build(ref_fa)
    _same_dir(port_fa + ".lariat.d", ref_fa + ".lariat.d")
    assert not os.path.exists(port_fa + ".part.lariat.d")


def test_generator_cut_builds_the_hg38_phase_inputs(tmp_path, capsys):
    """``--cut``: the hg38 step's genome at that scale with its
    centromeres, its index (its build line printed) and the 10k read set;
    nothing of chr20 and no other read set."""
    db = tmp_path / "cut"
    assert t_gen.main([str(db), "--cut", "0.0005"]) == 0
    out = capsys.readouterr().out
    assert BUILD_LINE.findall(out) == [str(db / "hg38sim.fa")]
    assert sorted(p.name for p in db.iterdir()) == [
        ".gen.lock", "hg38sim.centromeres.tsv", "hg38sim.fa",
        "hg38sim.fa.lariat.d", "sim10k.fastq.gz"]
    from lariat_tpu_torch.index.fmindex import FMIndex
    assert 1_400_000 < FMIndex.load_dir(str(db / "hg38sim.fa")).l_pac \
        < 1_700_000


def test_generator_chr20_builds_only_the_chr20_step(tmp_path, capsys):
    """``--chr20`` (here ``generate``'s arguments at a tiny scale and read
    count): the chr20 genome, its index (its build line printed) and the
    1M read set's file, each step's seconds on a line of its own; nothing
    of hg38. Run again, it builds nothing."""
    import gzip
    db = tmp_path / "c20"
    small = dict(chr20=True, chr20_scale=0.0003, chr20_reads=(8, 10))
    t_gen.generate(str(db), **small)
    out = capsys.readouterr().out
    assert BUILD_LINE.findall(out) == [str(db / "chr20sim.fa")]
    assert re.findall(r"^(\w+)\.py: [0-9.]+ s$", out, re.M) == [
        "synth_genome", "sim_reads"]
    names = ["chr20sim.fa", "chr20sim.fa.lariat.d", "sim1m_chr20.fastq.gz"]
    assert sorted(p.name for p in db.iterdir()) == names
    from lariat_tpu_torch.index.fmindex import FMIndex
    assert 800_000 < FMIndex.load_dir(str(db / "chr20sim.fa")).l_pac \
        < 1_100_000
    with gzip.open(db / "sim1m_chr20.fastq.gz", "rt") as f:
        assert sum(1 for _ in f) == 9 * 80
    before = {n: os.stat(db / n).st_mtime_ns for n in names}
    t_gen.generate(str(db), **small)
    out = capsys.readouterr().out
    assert "+ " not in out and "build " not in out
    assert out.strip() == "chr20 step complete"
    assert {n: os.stat(db / n).st_mtime_ns for n in names} == before


def test_generator_hg38_builds_only_the_hg38_step(tmp_path, capsys):
    """``--hg38`` with ``--cut``'s scale (here ``generate``'s arguments at a
    tiny scale and read counts): the hg38 genome, its centromeres, its
    index (its build line printed) and the 200k, 50k and 10k read sets'
    files; nothing of chr20. Run again, it builds nothing."""
    import gzip
    db = tmp_path / "hg"
    small = dict(cut=0.0005, hg38=True,
                 hg38_reads=(("sim200k.fastq.gz", 6, 10),
                             ("sim50k.fastq.gz", 3, 10),
                             ("sim10k.fastq.gz", 2, 10)))
    t_gen.generate(str(db), **small)
    out = capsys.readouterr().out
    assert BUILD_LINE.findall(out) == [str(db / "hg38sim.fa")]
    assert re.findall(r"^(\w+)\.py: [0-9.]+ s$", out, re.M) == [
        "synth_genome", "sim_reads", "sim_reads", "sim_reads"]
    names = ["hg38sim.centromeres.tsv", "hg38sim.fa", "hg38sim.fa.lariat.d",
             "sim10k.fastq.gz", "sim200k.fastq.gz", "sim50k.fastq.gz"]
    assert sorted(p.name for p in db.iterdir()) == names
    from lariat_tpu_torch.index.fmindex import FMIndex
    assert 1_400_000 < FMIndex.load_dir(str(db / "hg38sim.fa")).l_pac \
        < 1_700_000
    for name, bcs, ppb in small["hg38_reads"]:
        with gzip.open(db / name, "rt") as f:
            assert sum(1 for _ in f) == 9 * bcs * ppb, name
    before = {n: os.stat(db / n).st_mtime_ns for n in names}
    t_gen.generate(str(db), **small)
    out = capsys.readouterr().out
    assert "+ " not in out and "build " not in out
    assert out.strip() == "data_big complete"
    assert {n: os.stat(db / n).st_mtime_ns for n in names} == before


def test_generator_hg38_flag_reaches_generate(tmp_path, monkeypatch):
    """``main``: ``--hg38`` (with and without ``--cut``) asks ``generate``
    for the hg38 step alone, under the lock; ``--chr20`` with it is
    refused."""
    import pytest
    got = []
    monkeypatch.setattr(t_gen, "generate",
                        lambda db, cut, chr20, hg38: got.append(
                            (cut, chr20, hg38)))
    assert t_gen.main([str(tmp_path / "a"), "--hg38"]) == 0
    assert t_gen.main([str(tmp_path / "b"), "--hg38", "--cut", "0.36"]) == 0
    assert got == [(0.0, False, True), (0.36, False, True)]
    with pytest.raises(SystemExit):
        t_gen.main([str(tmp_path / "c"), "--chr20", "--hg38"])
    assert not (tmp_path / "c").exists()


def test_generator_refuses_chr20_with_cut(tmp_path):
    import pytest
    with pytest.raises(SystemExit):
        t_gen.main([str(tmp_path / "x"), "--chr20", "--cut", "0.36"])
    assert not (tmp_path / "x").exists()


def test_second_generator_waits_then_builds_nothing(tmp_path):
    """While one generator holds DIR/.gen.lock a second one blocks; once
    the lock is free it finds every output present and runs no step."""
    import fcntl
    db = tmp_path / "data_big"
    db.mkdir()
    for name in GEN_OUTPUTS:
        if name.endswith(".lariat.d"):
            (db / name).mkdir()
        else:
            (db / name).write_bytes(b"present")
    before = {n: os.stat(db / n).st_mtime_ns for n in GEN_OUTPUTS}
    with open(db / ".gen.lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        proc = subprocess.Popen(
            [sys.executable, "-m", "lariat_tpu_torch.tools.gen_data_big",
             str(db)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=REPO, env={**os.environ, "PYTHONPATH": REPO})
        try:
            first = proc.stdout.readline()
            time.sleep(0.5)
            assert "waiting" in first and proc.poll() is None
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    rest, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0, rest
    assert "data_big complete" in rest
    assert "+ " not in first + rest          # no generator step ran
    assert {n: os.stat(db / n).st_mtime_ns for n in GEN_OUTPUTS} == before


def test_align_repl_prints_the_reference_candidates(tmp_path):
    port_fa, ref_fa = _two_fastas(tmp_path)
    g = open(port_fa).read().split(">chrB\n")[0].split("\n", 1)[1]
    g = g.replace("\n", "")
    comp = str.maketrans("ACGT", "TGCA")
    r1 = g[1000:1100]
    r2 = g[1250:1350].translate(comp)[::-1]
    r3 = g[5000:5100]
    stdin = f"{r1}\n{r2}\n{r3.lower()}\n{r1[:60]}\n\n"
    outs = []
    for cmd, fa in (([sys.executable, "-m",
                      "lariat_tpu_torch.tools.align_repl"], port_fa),
                    ([sys.executable, "tools/align_repl.py"], ref_fa)):
        r = subprocess.run(cmd + [fa], input=stdin, capture_output=True,
                           text=True, cwd=REPO, timeout=300,
                           env={**os.environ, "PYTHONPATH": REPO,
                                "JAX_PLATFORMS": "cpu"})
        assert r.returncode == 0, r.stderr[-2000:]
        outs.append(r.stdout.split("Ready.", 1)[1])
    assert outs[0] == outs[1]
    assert outs[0].count("candidates") == 4
    assert "chrA:1000+" in outs[0] and "chrA:1349-" in outs[0]


def test_bench_skips_hg38_with_no_gen(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "HG38_DIR", str(tmp_path / "data_big"))
    monkeypatch.setenv("LARIAT_BENCH_NO_GEN", "1")
    called = []
    monkeypatch.setattr(bench, "_generate_data_big",
                        lambda: called.append(1))
    assert bench._hg38_runs(str(tmp_path)) == {
        "hg38_skipped": "data_big/ missing and LARIAT_BENCH_NO_GEN=1"}
    assert not called


def test_bench_regenerates_missing_data_big(tmp_path, monkeypatch):
    """Without data_big/'s inputs the bench runs the generator, then its
    hg38 runs on what the generator wrote."""
    db = tmp_path / "data_big"
    monkeypatch.setattr(bench, "HG38_DIR", str(db))
    monkeypatch.delenv("LARIAT_BENCH_NO_GEN", raising=False)

    def generate():
        db.mkdir()
        (db / "hg38sim.fa.lariat.d").mkdir()
        (db / "sim10k.fastq.gz").write_bytes(b"reads")

    runs = []
    monkeypatch.setattr(bench, "_generate_data_big", generate)
    monkeypatch.setattr(
        bench, "_mode_runs",
        lambda fa, reads, *a, **kw: (runs.append((fa, reads, a[1]))
                                     or ({"pairs_s": 1.0}, [], None)))
    got = bench._hg38_runs(str(tmp_path))
    assert got == {"hg38_host_8w": {"pairs_s": 1.0},
                   "hg38_device_8w": {"pairs_s": 1.0}}
    assert runs == [(str(db / "hg38sim.fa"), str(db / "sim10k.fastq.gz"),
                     m) for m in ("off", "on")]


def test_bench_generator_failure_and_timeout(tmp_path, monkeypatch):
    """The real generator as the bench starts it: a failure and a timeout
    each become an hg38_skipped reason, and a timeout leaves no process
    of the generator's session running."""
    import fcntl
    monkeypatch.setattr(bench, "HG38_DIR", str(tmp_path / "not_a_dir"))
    (tmp_path / "not_a_dir").write_text("a file where the directory goes")
    why = bench._generate_data_big()
    assert why.startswith("data_big regeneration failed (rc ")
    db = tmp_path / "data_big"
    db.mkdir()
    monkeypatch.setattr(bench, "HG38_DIR", str(db))
    monkeypatch.setenv("LARIAT_BENCH_GEN_TIMEOUT", "3")
    with open(db / ".gen.lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # the generator waits on it
        assert bench._generate_data_big() == (
            "data_big regeneration timed out after 3s")
    r = subprocess.run(["pgrep", "-f", f"gen_data_big {db}"],
                       capture_output=True, text=True)
    assert not r.stdout.strip()
    assert not [n for n in os.listdir(db) if n != ".gen.lock"]
