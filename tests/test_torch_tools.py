"""The port's measurement entry points on the CPU: the roofline's peak and
cell arithmetic, the ablation tool, the priming profile and the device
align step on the explicit CPU device, and each tool's refusal to run
without CUDA otherwise."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_cli import _env, _inputs

from lariat_tpu_torch.ops import extend_ablate as t1
from lariat_tpu_torch.tools import device_step, extend_ablate, kernel_roofline
from lariat_tpu_torch.tools import prime_profile

torch.set_num_threads(1)


def _json_lines(out):
    return [json.loads(s) for s in out.splitlines() if s.startswith("{")]


def test_roofline_peaks_from_attributes():
    # an H100 SXM's attributes: 132 SMs, 1,980 MHz, HBM3 2,619 MHz x 5120
    pk = kernel_roofline.peaks({"sm_count": 132, "sm_clock_khz": 1980000,
                                "mem_clock_khz": 2619000,
                                "mem_bus_bits": 5120})
    assert pk["int32_ops_s"] == 132 * 64 * 1.98e9
    assert pk["mem_B_s"] == pytest.approx(3.352e12, rel=1e-3)
    assert kernel_roofline.share(1e9, 20, 2.0, 1e13) == pytest.approx(100.0)


@pytest.mark.parametrize("qlen,tlen,w", [(151, 400, 100), (151, 160, 20),
                                         (5, 3, 0), (10, 40, 3), (0, 9, 4)])
def test_roofline_band_cells_count_the_band(qlen, tlen, w):
    want = sum(1 for i in range(tlen) for j in range(qlen)
               if max(i - w, 0) <= j < min(i + w + 1, qlen))
    assert kernel_roofline.band_cells(qlen, tlen, w) == want


def test_roofline_shares_collects_every_share():
    res = {"extend": {"ms": 1.0, "int32_sol_pct": 5.0},
           "global_tb": {"int32_sol_pct": 2.0, "traceback_mem_sol_pct": 1.0},
           "device": "x"}
    assert kernel_roofline.shares(res) == {
        "extend.int32_sol_pct": 5.0, "global_tb.int32_sol_pct": 2.0,
        "global_tb.traceback_mem_sol_pct": 1.0}


def test_extend_ablate_tool_on_cpu(capsys):
    assert extend_ablate.main(["--device", "cpu", "--B", "130", "--Lq", "32",
                               "--Lt", "48"]) == 0
    lines = _json_lines(capsys.readouterr().out)
    assert [x["variant"] for x in lines[:-1]] == list(t1.VARIANTS)
    for x in lines[:-1]:
        assert set(x) == {"variant", "Lt", "ms", "padded_cells_per_s",
                          "warp_steps", "ns_per_warp_step"}
        assert x["ms"] > 0 and x["Lt"] == (24 if x["variant"] == "rows_288"
                                           else 48)
        # the twin has no warp schedule: no steps on the CPU
        assert x["warp_steps"] is None and x["ns_per_warp_step"] is None
    final = lines[-1]
    assert set(final) == {"device", "card", "sm_count", "B", "Lq", "Lt",
                          "seed", "timing", "launches"}
    assert final["device"] == "cpu" and final["card"] is None
    assert final["sm_count"] is None
    assert final["launches"] == {"extend_ablate": 0}   # twins launch nothing


def test_extend_ablate_tool_inputs_are_the_jax_tools():
    q, t, params = extend_ablate.inputs(8, 192, 576, torch.device("cpu"))
    rng = np.random.default_rng(5)
    np.testing.assert_array_equal(q.numpy(), rng.integers(0, 4, (8, 192)))
    np.testing.assert_array_equal(t.numpy(), rng.integers(0, 4, (8, 576)))
    assert params[0].tolist() == [151, 400, 100, 30, 0, 0, 0, 0]


@pytest.mark.parametrize("flag,seeder", [(None, "host"), ("0", "host"),
                                         ("1", "device")])
def test_prime_profile_on_cpu(tmp_path, monkeypatch, capsys, flag, seeder):
    fasta, fq = _inputs(tmp_path)
    monkeypatch.setenv("LARIAT_TORCH_DEVICE", "cpu")
    if flag is None:
        monkeypatch.delenv("LARIAT_DEVICE_SEED", raising=False)
    else:
        monkeypatch.setenv("LARIAT_DEVICE_SEED", flag)
    assert prime_profile.main([str(fasta), str(fq), "35"]) == 0
    final = _json_lines(capsys.readouterr().out)[-1]
    assert final["device"] == "cpu" and final["pairs"] == 35
    assert final["seeder"] == seeder
    assert (final["index_upload_s"] > 0) == (seeder == "device")
    assert final["extend_waves"] > 0 and final["rescue_waves"] > 0
    assert final["total_s"] == pytest.approx(
        final["seed_s"] + final["align_s"] + final["rescue_s"])
    # the one-thread priming passes; no profiler split on the CPU
    assert len(final["prime_s"]) == prime_profile.PRIME_REPEATS
    assert min(final["prime_s"]) > 0
    assert final["prime_pairs_per_s"] == pytest.approx(
        35 / sorted(final["prime_s"])[1])
    assert final["seed_profile"] is None
    assert set(final["launches"]) >= {"sw_extend", "sw_local",
                                      "extend_ablate"}


def test_roofline_smem_seed_on_cpu():
    """The smem_seed section's arithmetic, run through the twins on a few
    reads: every read seeds, and every seed has at least one rbeg."""
    out = kernel_roofline.smem_seed(torch.device("cpu"),
                                    np.random.default_rng(5), n_reads=12)
    assert set(out) == {"reads", "read_len", "genome_bp", "ms",
                        "reads_per_s", "first_run_ms", "mems_total",
                        "rbegs_total"}
    assert out["reads"] == 12 and out["genome_bp"] == 1 << 20
    assert out["mems_total"] >= 12 and out["rbegs_total"] >= \
        out["mems_total"]


def test_tools_refuse_without_cuda(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("LARIAT_TORCH_DEVICE", raising=False)
    fasta, fq = _inputs(tmp_path)
    for run in (lambda: extend_ablate.main(["--B", "8"]),
                lambda: kernel_roofline.main([]),
                lambda: prime_profile.main([str(fasta), str(fq), "7"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            run()


def test_roofline_band_cells_batch_counts_rows_run():
    """K1's work: the band cells of the rows each task ran."""
    rng = np.random.default_rng(3)
    qlen = rng.integers(0, 40, 30)
    rows = rng.integers(0, 60, 30)
    w = rng.integers(0, 12, 30)
    want = sum(kernel_roofline.band_cells(int(q), int(r), int(x))
               for q, r, x in zip(qlen, rows, w))
    assert kernel_roofline.band_cells_batch(qlen, rows, w) == want
    assert kernel_roofline.band_cells_batch([5], [0], [3]) == 0


def test_kernel_turns_inputs():
    """The turns tool's K1 inputs (chip_smoke.py phase 3's) and its seeding
    batch from a FASTQ."""
    from lariat_tpu_torch.tools import kernel_turns
    a = kernel_turns.k1_inputs(np.random.default_rng(1), B=200)
    b = kernel_turns.k1_inputs(np.random.default_rng(1), B=200)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    q, qlen, t, tlen, w, h0 = a
    assert q.shape == (200, 192) and t.shape == (200, 576)
    assert (qlen[:64] == 0).all() and (tlen[64:128] == 0).all()
    assert (qlen <= 151).all() and (w == 100).all() and (h0 >= 19).all()
    assert q.max() <= 4 and t.max() <= 4


def test_kernel_turns_k2_inputs_and_sections():
    """The turns tool's K2/K2b inputs (chip_smoke.py phase 3's reg2aln
    chunk) and its refusal of an unknown section."""
    from lariat_tpu_torch.tools import kernel_turns
    q, qlen, t, tlen, w = kernel_turns.k2_inputs(np.random.default_rng(1),
                                                 B=300)
    assert q.shape == (300, 192) and t.shape == (300, 384)
    assert (qlen >= 30).all() and (qlen <= 151).all()
    assert (np.abs(tlen - qlen) <= 10).all()
    assert (w >= np.abs(qlen - tlen)).all() and (w >= 1).all()
    with pytest.raises(SystemExit, match="sections"):
        kernel_turns.main(["g.fa", "r.fq", "k2b,k10"])


def test_kernel_turns_k3_inputs():
    """The turns tool's K3 inputs (a rescue wave at chip_smoke.py phase 3's
    shape): the reads planted in their windows (2% substitutions), where
    the K3 twin finds each one (a score of 100 or more of 151)."""
    from lariat_tpu_torch.ops import sw_local
    from lariat_tpu_torch.tools import kernel_turns
    q, qlen, t, tlen, minsc = kernel_turns.k3_inputs(
        np.random.default_rng(3), B=8)
    assert q.shape == (8, 192) and t.shape == (8, 704)
    assert (qlen == 151).all() and (tlen == 686).all() and (minsc == 19).all()
    got = sw_local.local_batch_plain(*(torch.from_numpy(a) for a in
                                       (q, qlen, t, tlen, minsc)))
    assert got.shape[0] == 8 and (got[0] >= 100).all()


def test_kernel_turns_launch_us_runs_every_call():
    """The launch section's timer: every thread makes each of its calls,
    and the cost a call is the wall over all of them."""
    from lariat_tpu_torch.tools import kernel_turns
    calls = []
    us = kernel_turns.launch_us(lambda: calls.append(1), 4, 25)
    assert len(calls) == 1 + 4 * 25 and us > 0


def test_kernel_turns_variant(tmp_path):
    """A tuning variant: the package copied with one string of one file
    replaced, refused unless the string occurs exactly once."""
    from lariat_tpu_torch.tools import kernel_turns
    old = "constexpr int kRows = 32;"
    new = "constexpr int kRows = 32;  // a variant"
    assert kernel_turns.main(["variant", str(tmp_path / "v"),
                              "csrc/traceback.cu", old, new]) == 0
    pkg = tmp_path / "v" / "lariat_tpu_torch"
    src = (pkg / "csrc" / "traceback.cu").read_text()
    assert src.count(new) == 1
    assert (pkg / "ops" / "sw_global.py").exists()
    with pytest.raises(SystemExit, match="occurs 0 times"):
        kernel_turns.make_variant(str(tmp_path / "w"), "csrc/traceback.cu",
                                  "no such line", "x")


def test_kernel_turns_seed_batch_and_refusal(tmp_path, monkeypatch):
    from lariat_tpu_torch.align.engine import encode_read
    from lariat_tpu_torch.io.fastq import FastQReader
    from lariat_tpu_torch.tools import kernel_turns
    fasta, fq = _inputs(tmp_path)
    rmat, lens, qs = kernel_turns.seed_batch(str(fq), 7)
    recs, _ = FastQReader(str(fq)).read_barcode_set(0)
    first = [encode_read(s) for r in recs for s in (r.read1, r.read2)][:7]
    assert rmat.shape[0] == 7 and rmat.shape[1] % 64 == 0
    for i, s in enumerate(first):
        np.testing.assert_array_equal(qs[i], s)
        assert lens[i] == len(s)
        np.testing.assert_array_equal(rmat[i, :len(s)], s)
        assert (rmat[i, len(s):] == 4).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            kernel_turns.main([str(fasta), str(fq)])
        with pytest.raises(RuntimeError, match="CUDA"):
            kernel_turns.main([str(fasta), str(fq), "k7,step"])


TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "lariat_tpu_torch", "tools")


def test_sa_walks_logs_each_cli_launch_on_cpu(tmp_path):
    """sa_walks.py cli: the device-seeded CLI on the CPU (K5's twin), every
    SA walk logged as [rows, max_steps, longest walk, walks past 64], one
    512-step walk a lookup over rows padded to a power of two >= 128."""
    fasta, fq = _inputs(tmp_path)
    r = subprocess.run(
        [sys.executable, os.path.join(TOOLS, "sa_walks.py"), "cli",
         "-reads", str(fq), "-genome", str(fasta), "-output",
         str(tmp_path / "out"), "-threads", "2", "-use_device", "on",
         "-first_chunk"],
        capture_output=True, text=True, timeout=600,
        env=_env(LARIAT_TORCH_DEVICE="cpu", LARIAT_DEVICE_SEED="1",
                 PYTHONPATH=os.path.dirname(os.path.dirname(TOOLS))))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "primed pairs 35  host pairs 0" in r.stdout
    log = _json_lines(r.stdout)[-1]["sa_walk_launches"]
    assert log
    for rows, max_steps, longest, past in log:
        assert rows >= 128 and rows & (rows - 1) == 0
        assert max_steps == 512 and 0 <= longest <= 512
        assert 0 <= past <= rows and (past > 0) == (longest > 64)


def test_sa_walks_profile_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fasta, _ = _inputs(tmp_path)
    r = subprocess.run(
        [sys.executable, os.path.join(TOOLS, "sa_walks.py"), "profile",
         str(fasta)], capture_output=True, text=True, timeout=300,
        env=_env(PYTHONPATH=os.path.dirname(os.path.dirname(TOOLS))))
    assert r.returncode != 0 and "needs CUDA" in r.stderr


def test_roofline_fm_rank_on_cpu():
    """The fm_rank section's arithmetic through occ1_rank's twin."""
    rng = np.random.default_rng(5)
    fm = kernel_roofline.random_index(rng, 1 << 14)
    out = kernel_roofline.fm_rank(torch.device("cpu"), rng, fm, 3.352e12,
                                  iters=1, n=4096)
    assert set(out) == {"lookups", "genome_bp", "ms", "lookups_per_s",
                        "bytes", "mem_sol_pct"}
    assert out["lookups"] == 4096 and out["genome_bp"] == 1 << 14
    assert out["bytes"] == 4096 * (48 + 4 + 4 + 4)
    assert out["mem_sol_pct"] > 0


def test_device_step_tool_on_cpu(tmp_path, capsys):
    """tools/device_step.py at a tiny size on the CPU: both steps through
    the twins, every key of the JSON line, the reads bench.py's (odd ones
    reverse complemented, one substitution each)."""
    fasta, _ = _inputs(tmp_path)
    assert device_step.main([str(fasta), "--device", "cpu", "--B", "24",
                             "--L", "60"]) == 0
    (out,) = _json_lines(capsys.readouterr().out)
    parts = {"smem": {"lanes", "min_starts", "anchor_pick", "sa_lookup",
                      "orient", "fetch_extend"},
             "exact": {"exact_match", "sa_lookup", "orient", "fetch_extend"}}
    assert out["device"] == "cpu" and out["card"] is None
    assert (out["B"], out["L"], out["genome_bp"]) == (24, 60, 60000)
    # a substitution in the last 32 bases (about half of them at L 60)
    # leaves the exact step's seed no hit
    for pre, want, least in (("device_step", parts["smem"], 0.8),
                             ("exact_step", parts["exact"], 0.2)):
        assert out[f"{pre}_ms"] > 0
        assert out[f"{pre}_pairs_s"] == pytest.approx(
            24 / (out[f"{pre}_ms"] * 1e-3) / 2)
        assert least <= out[f"{pre}_mapped_frac"] <= 1.0
        assert least <= out[f"{pre}_at_truth_frac"] <= \
            out[f"{pre}_mapped_frac"]
        assert set(out[f"{pre}_parts_ms"]) == want
    assert out["launches"]["exact_match"] == 0      # twins launch nothing
    from lariat_tpu_torch.cli import load_reference
    reads, starts = device_step.step_reads(load_reference(str(fasta)), 24,
                                           60)
    codes = load_reference(str(fasta)).get_seq_codes(0, 60000)
    for i in (0, 1):
        seg = codes[starts[i]:starts[i] + 60]
        seg = (3 - seg)[::-1] if i % 2 else seg
        assert (reads[i] != seg).sum() == 1


def test_device_step_refuses_without_cuda(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("LARIAT_TORCH_DEVICE", raising=False)
    fasta, _ = _inputs(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_step.main([str(fasta), "--B", "8"])


def test_cli_turns_counts_pairs_and_wants_a_tree(tmp_path):
    """The CLI turns tool counts a FASTQ's pairs (9 lines a pair) and
    refuses to run without a tree."""
    import gzip
    from lariat_tpu_torch.tools import cli_turns
    fq = tmp_path / "r.fastq.gz"
    with gzip.open(fq, "wt") as f:
        f.write("".join(f"@p{i} rg\nA\nI\nC\nI\nBC-1,BC\nJ\nA\nI\n"
                        for i in range(7)))
    assert cli_turns.count_pairs(str(fq)) == 7
    with pytest.raises(SystemExit, match="usage"):
        cli_turns.main(["g.fa", str(fq)])
    with pytest.raises(SystemExit, match="configs"):
        cli_turns.main(["--configs", "primed,fast", "g.fa", str(fq), "."])
