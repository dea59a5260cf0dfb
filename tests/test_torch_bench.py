"""The port's bench (lariat_tpu_torch/tools/bench.py) and the torch RFA
rows on the CPU: the rows bit-identical to the numpy rows and to the JAX
package's jit rows, a CLI run with the torch rows in forked workers, the
bench's parsing of the CLI's real summary lines, its median and record
diff rate against bench.py's, and its refusal to run without a card."""

import glob
import gzip
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from test_rfa import dup_genome  # noqa: F401
from test_tensor_rfa import _build as ref_build
from test_torch_cli import REPO, _env, _inputs

import bench as ref_bench
from lariat_tpu.align.engine import AlignmentEngine as RefEngine
from lariat_tpu.config import RFAConfig as RefConfig
from lariat_tpu.rfa import optimizer as ref_opt
from lariat_tpu.rfa.tensor_rfa import RFATensors as RefTensors
from lariat_tpu_torch.align.engine import AlignmentEngine
from lariat_tpu_torch.config import RFAConfig
from lariat_tpu_torch.index import fmindex
from lariat_tpu_torch.io import bamcompare
from lariat_tpu_torch.io.bgzf import BGZFWriter
from lariat_tpu_torch.rfa import candidates, molecules as mol_mod
from lariat_tpu_torch.rfa import optimizer as port_opt
from lariat_tpu_torch.rfa.tensor_rfa import RFATensors
from lariat_tpu_torch.tools import bench

torch.set_num_threads(1)

BASES = np.frombuffer(b"ACGT", np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")


def _port_build(engine, reads, cfg, chain_fns=None):
    """tests/test_tensor_rfa.py ``_build`` on given reads: the port's
    modules, or the JAX package's where ``chain_fns`` (its get_chains and
    get_alignments) is given -- the molecule steps then come from it too."""
    if chain_fns is None:
        get_chains, get_alignments = (candidates.get_chains,
                                      candidates.get_alignments)
        tag, mm = candidates.tag_best_alignments, mol_mod
    else:
        from lariat_tpu.rfa import candidates as ref_cand
        from lariat_tpu.rfa import molecules as ref_mm
        get_chains, get_alignments = chain_fns
        tag, mm = ref_cand.tag_best_alignments, ref_mm
    chains, _ = get_chains(engine, reads, cfg.chain_score_delta)
    alignments, _ = get_alignments(engine, chains, cfg.alignment_score_delta,
                                   cfg.improper_pair_penalty)
    positions = tag(alignments, -17)
    mols = mm.infer_molecules(positions)
    mm.mark_best_alignment_for_read_in_molecule(mols,
                                                cfg.improper_pair_penalty)
    mols = mm.scrap_molecules(mols)
    mm.set_molecule_differences(mols, False)
    return mols, alignments


def _reads(FastQRecord, genome, starts, seed=23):
    """The reads of test_tensor_rfa's ``_build`` (8 pairs a molecule, one
    molecule at each of ``starts``) as records of a package."""
    rng = np.random.default_rng(seed)
    reads = []
    for m, start in enumerate(starts):
        for i in range(8):
            pos = start + int(rng.integers(0, 900))
            r1 = genome[pos:pos + 100]
            r2 = genome[pos + 200:pos + 300].translate(COMP)[::-1]
            reads.append(FastQRecord(
                read1=r1, read_qual1=b"I" * 100, read2=r2,
                read_qual2=b"I" * 100, barcode10x=b"AAACAGAGAAAGAT-1",
                barcode10x_qual=b"J" * 14, raw_barcode10x=b"AAACAGAGAAAGAT",
                barcode=b"ACGTACGT", barcode_qual=b"IIIIIIII",
                read_info=f"t:{m}:{i}"))
    rng.shuffle(reads)
    return reads


def _write_fasta(path, genome: bytes):
    with open(path, "w") as f:
        f.write(">chrT\n")
        s = genome.decode()
        for i in range(0, len(s), 70):
            f.write(s[i:i + 70] + "\n")


@pytest.fixture(scope="module")
def far_genome(tmp_path_factory):
    """300 kb with [2000:3000] copied to [152000:153000]: molecules at 1800,
    151800 and 250000 stay apart, and the first two share reads."""
    from lariat_tpu.index import fmindex as ref_fmindex
    rng = np.random.default_rng(7)
    g = BASES[rng.integers(0, 4, 300000)]
    g[152000:153000] = g[2000:3000]
    fa = tmp_path_factory.mktemp("far") / "far.fa"
    _write_fasta(fa, g.tobytes())
    return ref_fmindex.build_index(str(fa)), g.tobytes()


@pytest.mark.parametrize("case", ["dup_genome", "far_genome"])
def test_torch_rows_bit_identical(case, request, tmp_path, monkeypatch):
    """The torch rows equal the port's numpy rows, the JAX package's numpy
    rows and its jit rows (run as tests/test_tensor_rfa.py runs them),
    every source against every other molecule, before and after three
    sweeps of accepted moves: on the dup_genome fixture with
    test_tensor_rfa's molecules (which merge into one) and on a genome
    where three stay apart."""
    from lariat_tpu.io.fastq import FastQRecord as RefRecord
    from lariat_tpu.rfa.candidates import get_alignments, get_chains
    from lariat_tpu_torch.io.fastq import FastQRecord
    fm_ref, genome = request.getfixturevalue(case)
    starts = ((1800, 41800, 60000) if case == "dup_genome"
              else (1800, 151800, 250000))
    fa = tmp_path / "g.fa"
    _write_fasta(fa, genome)
    ref_cfg, cfg = RefConfig(), RFAConfig()
    lup = cfg.improper_pair_penalty
    mols_r, alns_r = _port_build(RefEngine(fm_ref),
                                 _reads(RefRecord, genome, starts), ref_cfg,
                                 (get_chains, get_alignments))
    mols_p, alns_p = _port_build(AlignmentEngine(fmindex.build_index(str(fa))),
                                 _reads(FastQRecord, genome, starts), cfg)
    assert len(mols_p) == len(mols_r) >= (1 if case == "dup_genome" else 3)
    if case == "dup_genome":   # test_tensor_rfa's own molecules, too
        assert len(ref_build(RefEngine(fm_ref), genome, ref_cfg)[0]) == \
            len(mols_r)
    t_r = RefTensors.build(mols_r, alns_r)
    t_p = RFATensors.build(mols_p, alns_p)
    n_rows = 0

    def check_all():
        nonlocal n_rows
        M = len(mols_p)
        for s in range(M):
            if len(mols_p[s].active_alignments) == 0:
                continue
            K = np.array([k for k in range(M) if k != s], np.int64)
            monkeypatch.delenv("LARIAT_RFA_JIT", raising=False)
            c_np, n_np = t_p.fast_score_row(mols_p[s], s, K, lup)
            c_rn, n_rn = t_r.fast_score_row(mols_r[s], s, K, lup)
            monkeypatch.setenv("LARIAT_RFA_JIT", "1")
            c_t, n_t = t_p.fast_score_row(mols_p[s], s, K, lup)
            c_j, n_j = t_r.fast_score_row(mols_r[s], s, K, lup)
            for c, n in ((c_np, n_np), (c_rn, n_rn),
                         (np.asarray(c_j), np.asarray(n_j))):
                np.testing.assert_array_equal(np.asarray(c_t), c)
                np.testing.assert_array_equal(np.asarray(n_t),
                                              np.asarray(n).astype(np.int64))
            assert c_t.dtype == np.float64 and n_t.dtype == np.int64
            n_rows += int(len(K) > 0 and n_t.max() > 0)
        monkeypatch.delenv("LARIAT_RFA_JIT", raising=False)

    check_all()
    opt_p = port_opt.RFAOptimizer(mols_p, alns_p, lup)
    opt_r = ref_opt.RFAOptimizer(mols_r, alns_r, lup)
    for _ in range(3 * len(mols_p)):
        opt_p.generate_move()
        opt_r.generate_move()
    assert [sorted(m.active_alignments) for m in mols_p] == \
        [sorted(m.active_alignments) for m in mols_r]
    check_all()
    if case == "far_genome":
        assert n_rows >= 4     # rows whose sinks share reads, both states


def _rfa_inputs(tmp_path):
    """A 300 kb genome with [2000:3000] copied to [152000:153000] and 4
    barcodes of three molecules (8 pairs each, two over the copies), so
    every barcode's optimizer scores rows."""
    rng = np.random.default_rng(7)
    g = BASES[rng.integers(0, 4, 300000)]
    g[152000:153000] = g[2000:3000]
    genome = g.tobytes()
    fasta = tmp_path / "g.fa"
    with open(fasta, "w") as f:
        f.write(">chrT\n")
        s = genome.decode()
        for i in range(0, len(s), 70):
            f.write(s[i:i + 70] + "\n")
    fq = tmp_path / "r.fastq.gz"
    q = "I" * 100
    with gzip.open(fq, "wt") as f:
        for b in range(4):
            bc = f"AAACAGAGAAAG{'ACGT'[b]}T-1"
            for m, start in enumerate((1500, 151500, 250000)):
                for i in range(8):
                    pos = start + int(rng.integers(0, 1700))
                    r1 = genome[pos:pos + 100].decode()
                    r2 = genome[pos + 200:pos + 300].translate(COMP)[::-1]
                    f.write(f"@b{b}m{m}r{i} x\n{r1}\n{q}\n{r2.decode()}\n"
                            f"{q}\n{bc},{bc[:-2]}\nJJJJJJJJJJJJJJ\n"
                            f"ACGTACGT\nIIIIIIII\n")
    return fasta, fq


def _counted_cli(fasta, fq, out, rows_log, **env):
    """The port's CLI at -threads 2, -use_device off, its torch rows
    counted (one line a row in ``rows_log``, written by the workers):
    stdout."""
    code = textwrap.dedent(f"""
        import sys
        from lariat_tpu_torch import cli
        from lariat_tpu_torch.rfa.tensor_rfa import RFATensors
        row = RFATensors._row_torch
        def counted(self, *a):
            with open({str(rows_log)!r}, "a") as f:
                f.write("row\\n")
            return row(self, *a)
        RFATensors._row_torch = counted
        sys.exit(cli.main(["-reads", {str(fq)!r}, "-genome", {str(fasta)!r},
                           "-output", {str(out)!r}, "-threads", "2",
                           "-use_device", "off", "-first_chunk"]))
        """)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=REPO, env=_env(**env), timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


def test_cli_torch_rows_in_forked_workers(tmp_path):
    """LARIAT_RFA_JIT=1 at -threads 2: the workers run the torch rows (one
    thread each), the summary says rows: jit, and the BAMs equal those of
    the run without it as whole files (CL aside)."""
    fasta, fq = _rfa_inputs(tmp_path)
    log_np, log_t = tmp_path / "rows_np", tmp_path / "rows_t"
    out_np = _counted_cli(fasta, fq, tmp_path / "np", log_np)
    out_t = _counted_cli(fasta, fq, tmp_path / "t", log_t,
                         LARIAT_RFA_JIT="1")
    assert not log_np.exists()
    assert len(log_t.read_text().splitlines()) >= 4 * 3
    s_np, s_t = bench.parse_summary(out_np), bench.parse_summary(out_t)
    assert (s_np["rfa_rows"], s_t["rfa_rows"]) == ("numpy", "jit")
    assert s_np["pairs"] == s_t["pairs"] == 96
    names = sorted(os.path.basename(p)
                   for p in glob.glob(str(tmp_path / "np" / "*.bam")))
    assert names == sorted(os.path.basename(p) for p in glob.glob(
        str(tmp_path / "t" / "*.bam")))
    for name in names:
        bamcompare.compare_bams(str(tmp_path / "np" / name),
                                str(tmp_path / "t" / name))


@pytest.fixture(scope="module")
def cpu_runs(tmp_path_factory):
    """The port's CLI on tests/test_torch_cli.py's input: -use_device off,
    and on with the plain twins on the CPU (LARIAT_TORCH_DEVICE=cpu), at
    2 workers: (out dirs, stdouts)."""
    tmp = tmp_path_factory.mktemp("bench_runs")
    fasta, fq = _inputs(tmp)
    outs, logs = {}, {}
    for mode, extra in (("off", {}), ("on", {"LARIAT_TORCH_DEVICE": "cpu"})):
        out = tmp / mode
        r = subprocess.run(
            [sys.executable, "-m", "lariat_tpu_torch.cli", "-reads", str(fq),
             "-genome", str(fasta), "-output", str(out), "-threads", "2",
             "-use_device", mode], capture_output=True, text=True, cwd=REPO,
            env=_env(**extra), timeout=600)
        assert r.returncode == 0, r.stderr[-2000:]
        outs[mode], logs[mode] = out, r.stdout
    return outs, logs


def test_bench_parses_the_cli_summary(cpu_runs):
    """The bench's regexes (bench.py's, one for one) on the port CLI's real
    summary lines: a host-native run and a device-mode run on the CPU."""
    for name in ("_RATE_RE", "_BUSY_RE", "_TIE_RE"):
        assert getattr(bench, name).pattern == getattr(ref_bench,
                                                       name).pattern
    _, logs = cpu_runs
    off, on = bench.parse_summary(logs["off"]), bench.parse_summary(
        logs["on"])
    assert off["pairs"] == on["pairs"] == 35
    assert off["pairs_s"] > 0 and off["steady_s"] >= 0
    assert "device_waves" not in off and "primed_pairs" not in off
    assert on["device_waves"] > 0 and on["device_wave_wall_s"] >= 0
    assert 0 <= on["device_busy_frac"] <= 1
    assert on["primed_pairs"] + on["host_pairs"] == 35
    line = next(s for s in logs["on"].splitlines()
                if s.startswith("device waves:"))
    m = ref_bench._BUSY_RE.search(line)
    assert (int(m.group(4)), int(m.group(5))) == (on["primed_pairs"],
                                                  on["host_pairs"])
    assert bench.parse_summary("no summary here") == {}


def test_median_of_matches_the_reference():
    cases = [[], [{"error": "x"}], [{"pairs_s": 3.0}],
             [{"pairs_s": 3.0}, {"error": "y"}, {"pairs_s": 1.0}],
             [{"pairs_s": 5.0, "a": 1}, {"pairs_s": 2.0, "a": 2},
              {"pairs_s": 9.0, "a": 3}],
             [{"pairs_s": 2.0, "a": 1}, {"pairs_s": 2.0, "a": 2},
              {"pairs_s": 1.0}, {"pairs_s": 4.0}]]
    for runs in cases:
        assert bench._median_of(runs) == ref_bench._median_of(runs)


def test_record_diff_rate_matches_the_reference(cpu_runs, tmp_path):
    outs, _ = cpu_runs
    assert bench._record_diff_rate(str(outs["off"]), str(outs["on"])) == \
        ref_bench._record_diff_rate(str(outs["off"]), str(outs["on"])) == \
        {"sam_diff_rate": 0.0, "records": 70}
    # one record's byte flipped in a copy: the same nonzero rate from both
    with gzip.open(outs["off"] / "bc_sorted_bam.bam", "rb") as f:
        data = bytearray(f.read())
    data[-3] ^= 0x01
    (tmp_path / "bad").mkdir()
    with open(tmp_path / "bad" / "bc_sorted_bam.bam", "wb") as f:
        w = BGZFWriter(f)
        w.write(bytes(data))
        w.close()
    got = bench._record_diff_rate(str(outs["off"]), str(tmp_path / "bad"))
    assert got == ref_bench._record_diff_rate(str(outs["off"]),
                                              str(tmp_path / "bad"))
    assert got == {"sam_diff_rate": round(1 / 70, 6), "records": 70}


def test_bench_without_a_card_exits_nonzero(tmp_path, monkeypatch):
    before = set(glob.glob(os.path.join(REPO, "build", "bench_*")))
    r = subprocess.run([sys.executable, "-m", "lariat_tpu_torch.tools.bench"],
                       capture_output=True, text=True, cwd=REPO, env=_env(),
                       timeout=300)
    assert r.returncode != 0
    assert not [s for s in r.stdout.splitlines() if s.startswith("{")]
    assert "torch.cuda.is_available() is false" in r.stderr
    assert set(glob.glob(os.path.join(REPO, "build", "bench_*"))) == before
    with pytest.raises(bench.BenchError, match="CUDA"):
        bench.run(str(tmp_path))
    assert not os.listdir(tmp_path)
    # without data_big/ the hg38 runs are skipped, never generated
    monkeypatch.setattr(bench, "HG38_DIR", str(tmp_path / "data_big"))
    assert bench._hg38_runs(str(tmp_path)) == {
        "hg38_skipped": "data_big/ missing; the port has no data generator "
                        "yet"}
