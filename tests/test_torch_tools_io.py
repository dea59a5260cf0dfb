"""The port's BAM reader, its BAM tools (bam2sam, cat_bams), its metrics
harness (tools/check.py), the whole-file BAM comparator, the probe and
the entry step, against the JAX package's counterparts on the CPU."""

import dataclasses
import glob
import gzip
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_cli import REPO, _env, _inputs
from test_torch_sw_extend import cuda_device  # noqa: F401

from lariat_tpu.io.bamread import BamFile as RefBamFile
from lariat_tpu_torch.io import bamcompare
from lariat_tpu_torch.io.bamread import BamFile
from lariat_tpu_torch.io.bgzf import BGZFWriter

torch.set_num_threads(1)

BASES = np.frombuffer(b"ACGT", np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")


def _fasta(path, genome: bytes):
    with open(path, "w") as f:
        f.write(">chr1\n")
        s = genome.decode()
        for i in range(0, len(s), 70):
            f.write(s[i:i + 70] + "\n")


def _run(args, env=None, timeout=600):
    r = subprocess.run([sys.executable, *args], capture_output=True,
                       text=True, cwd=REPO, env=env or _env(),
                       timeout=timeout)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


def _cli(module, mode, fasta, fq, out, threads=2, extra_env=None):
    return _run(["-m", module, "-reads", str(fq), "-genome", str(fasta),
                 "-output", str(out), "-threads", str(threads),
                 "-use_device", mode, "-first_chunk"],
                env=_env(**(extra_env or {})))


@pytest.fixture(scope="module")
def off_runs(tmp_path_factory):
    """One input run by lariat_tpu.cli and lariat_tpu_torch.cli, both
    -use_device off at 2 workers: (out dir of each, BAM names)."""
    tmp = tmp_path_factory.mktemp("off_runs")
    fasta, fq = _inputs(tmp)
    ref, port = tmp / "ref", tmp / "port"
    _cli("lariat_tpu.cli", "off", fasta, fq, ref)
    _cli("lariat_tpu_torch.cli", "off", fasta, fq, port)
    names = sorted(os.path.basename(p) for p in glob.glob(str(ref / "*.bam")))
    assert names and names == sorted(
        os.path.basename(p) for p in glob.glob(str(port / "*.bam")))
    return ref, port, names


def test_bamread_copies_read_the_same_fields(off_runs):
    ref, port, names = off_runs
    n = 0
    for d in (ref, port):
        for name in names:
            a, b = RefBamFile(str(d / name)), BamFile(str(d / name))
            assert (a.header_text, a.references, a._records_start,
                    a.data) == (b.header_text, b.references,
                                b._records_start, b.data)
            ra, rb = list(a), list(b)
            assert [dataclasses.astuple(x) for x in ra] == \
                [dataclasses.astuple(x) for x in rb]
            assert [(x.is_unmapped, x.is_proper_pair, x.is_reverse,
                     x.is_secondary, x.is_duplicate, x.is_read1)
                    for x in ra] == \
                [(x.is_unmapped, x.is_proper_pair, x.is_reverse,
                  x.is_secondary, x.is_duplicate, x.is_read1) for x in rb]
            n += len(rb)
    assert n >= 2 * 70


def test_whole_bam_comparator_passes_across_entry_points(off_runs):
    """The port's off run against lariat_tpu.cli's: equal up to CL."""
    ref, port, names = off_runs
    for name in names:
        a = BamFile(str(ref / name))
        b = BamFile(str(port / name))
        assert a.header_text != b.header_text      # argv differs in CL
        rep = bamcompare.compare_bams(str(ref / name), str(port / name))
        assert rep["records"] == len(list(b))
        assert rep["blocks_compared"] >= 1 and rep["bytes_compared"] >= 28


def _flip_record_byte(src, dst, at=-5):
    with gzip.open(src, "rb") as f:
        data = bytearray(f.read())
    data[at] ^= 0x01
    with open(dst, "wb") as f:
        w = BGZFWriter(f)
        w.write(bytes(data))
        w.close()


def test_whole_bam_comparator_flags_one_flipped_record_byte(off_runs,
                                                            tmp_path):
    ref, port, _ = off_runs
    bad = tmp_path / "bad.bam"
    _flip_record_byte(port / "bc_sorted_bam.bam", bad)
    with pytest.raises(bamcompare.BamMismatch, match="records"):
        bamcompare.compare_bams(str(ref / "bc_sorted_bam.bam"), str(bad))


def _big_bam(path, cl: str, n_copies=40, level=2, src=None):
    """A BAM whose stream spans several BGZF blocks: a run's header with
    its @PG CL set to ``cl`` and its records repeated."""
    with gzip.open(src, "rb") as f:
        data = f.read()
    start = bamcompare.header_end(data)
    (l_text,) = struct.unpack_from("<i", data, 4)
    text = data[8:8 + l_text].decode()
    text = "\n".join("\t".join("CL:" + cl if f.startswith("CL:") else f
                               for f in line.split("\t"))
                     if line.startswith("@PG") else line
                     for line in text.split("\n")).encode()
    head = data[:4] + struct.pack("<i", len(text)) + text
    with open(path, "wb") as f:
        w = BGZFWriter(f, level=level)
        w.write(head + data[8 + l_text:start] + data[start:] * n_copies)
        w.close()


def test_whole_bam_comparator_compares_blocks(off_runs, tmp_path):
    """CLs of one length: every block past the header is compared and a
    different CL is not flagged; CLs of two lengths shift the blocks, which
    are counted; a block compressed otherwise is flagged."""
    _, port, _ = off_runs
    src = port / "bc_sorted_bam.bam"
    a, b, c, d = (tmp_path / f"{x}.bam" for x in "abcd")
    _big_bam(a, "lariat run one", src=src)
    _big_bam(b, "lariat run two", src=src)
    _big_bam(c, "lariat run number three", src=src)
    _big_bam(d, "lariat run two", src=src, level=6)
    rep = bamcompare.compare_bams(str(a), str(b))
    assert rep["blocks"] >= 4 and rep["shifted_blocks"] == 0
    assert rep["blocks_compared"] == rep["blocks"] - rep["header_blocks"]
    rep = bamcompare.compare_bams(str(a), str(c))
    assert rep["blocks_compared"] == 1            # the EOF block
    assert rep["shifted_blocks"] == rep["blocks"] - rep["header_blocks"] - 1
    with pytest.raises(bamcompare.BamMismatch, match="BGZF block"):
        bamcompare.compare_bams(str(a), str(d))
    with open(d, "r+b") as f:                       # no EOF block
        f.truncate(os.path.getsize(d) - 28)
    with pytest.raises(bamcompare.BamMismatch, match="EOF"):
        bamcompare.compare_bams(str(a), str(d))


def _two_chunks(tmp_path):
    """tests/test_tools.py's two-chunk input, each chunk run by
    lariat_tpu.cli: the output dirs."""
    from lariat_tpu import cli as ref_cli
    genome = BASES[np.random.default_rng(2).integers(0, 4, 30000)].tobytes()
    fasta = tmp_path / "g.fa"
    _fasta(fasta, genome)
    qual = "I" * 100
    outs = []
    for chunk in range(2):
        fq = tmp_path / f"r{chunk}.fastq.gz"
        with gzip.open(fq, "wt") as f:
            for i in range(4):
                pos = 2000 + chunk * 8000 + i * 400
                r1 = genome[pos:pos + 100].decode()
                r2 = genome[pos + 200:pos + 300].translate(COMP)[::-1]
                f.write(f"@c{chunk}r{i} rg\n{r1}\n{qual}\n{r2.decode()}\n"
                        f"{qual}\nAAACAGAGAAAGAT-1,AAACAGAGAAAGAT\n"
                        f"JJJJJJJJJJJJJJ\nACGTACGT\nIIIIIIII\n")
        out = tmp_path / f"out{chunk}"
        argv = ["-reads", str(fq), "-genome", str(fasta), "-output",
                str(out), "-threads", "1"]
        if chunk == 0:
            argv.append("-first_chunk")
        assert ref_cli.main(argv) == 0
        outs.append(str(out))
    return outs


def test_cat_bams_and_bam2sam_match_the_reference_tools(tmp_path):
    from lariat_tpu_torch.tools import cat_bams
    outs = _two_chunks(tmp_path)
    want, got = tmp_path / "want.bam", tmp_path / "got.bam"
    _run(["tools/cat_bams.py", "-o", str(want), "--auto", *outs])
    assert cat_bams.main(["-o", str(got), "--auto", *outs]) == 0
    with open(want, "rb") as f, open(got, "rb") as g:
        assert f.read() == g.read()
    files = sorted(glob.glob(os.path.join(outs[0], "*.bam")))
    want2, got2 = tmp_path / "want2.bam", tmp_path / "got2.bam"
    _run(["tools/cat_bams.py", "-o", str(want2), *files])
    _run(["-m", "lariat_tpu_torch.tools.cat_bams", "-o", str(got2), *files])
    with open(want2, "rb") as f, open(got2, "rb") as g:
        assert f.read() == g.read()
    assert len(list(BamFile(str(got)))) == 16
    for args in ([str(got)], [str(got), "--no-header"]):
        ref = _run(["tools/bam2sam.py", *args])
        port = _run(["-m", "lariat_tpu_torch.tools.bam2sam", *args])
        assert port == ref and len(port.splitlines()) >= 16


def test_check_harness_matches_the_reference(tmp_path):
    """tests/test_tools.py's truth-in-qname input through tools/check.py
    and the port's check -use_device off: the same log lines."""
    rng = np.random.default_rng(17)
    genome = BASES[rng.integers(0, 4, 40000)].tobytes()
    fasta = tmp_path / "g.fa"
    _fasta(fasta, genome)
    fq = tmp_path / "r.fastq.gz"
    qual = "I" * 100
    with gzip.open(fq, "wt") as f:
        for i in range(8):
            pos = 3000 + i * 400
            r1 = genome[pos:pos + 100].decode()
            end = pos + 300
            r2 = genome[end - 100:end].translate(COMP)[::-1].decode()
            f.write(f"@mol:1:chr1:0:0:{pos}:{end - 100} rg\n{r1}\n{qual}\n"
                    f"{r2}\n{qual}\nAAACAGAGAAAGAT-1,AAACAGAGAAAGAT\n"
                    f"JJJJJJJJJJJJJJ\nACGTACGT\nIIIIIIII\n")
    logs = {}
    for name, args in (("ref", ["tools/check.py"]),
                       ("port", ["-m", "lariat_tpu_torch.tools.check",
                                 "-use_device", "off"])):
        log = tmp_path / f"{name}_log.txt"
        out = _run([*args, "-reads", str(fq), "-genome", str(fasta),
                    "-output", str(tmp_path / name), "-log", str(log),
                    "-threads", "1"])
        assert "Proper pair    : 1.000000" in out
        logs[name] = log.read_text().splitlines()
    ref, port = logs["ref"], logs["port"]
    assert ref[2].endswith("ref/bc_sorted_bam.bam")
    assert port[2].endswith("port/bc_sorted_bam.bam")
    assert ref[:2] + ref[3:] == port[:2] + port[3:]
    assert any("'bin': 45" in s for s in port)


def test_check_harness_defaults_to_the_card(tmp_path):
    """Without -use_device the harness asks the CLI for the card, which
    raises here (no CUDA) and writes no log."""
    fasta, fq = _inputs(tmp_path)
    log = tmp_path / "log.txt"
    r = subprocess.run(
        [sys.executable, "-m", "lariat_tpu_torch.tools.check", "-reads",
         str(fq), "-genome", str(fasta), "-output", str(tmp_path / "o"),
         "-log", str(log), "-threads", "2"], capture_output=True, text=True,
        cwd=REPO, env=_env(), timeout=600)
    assert r.returncode != 0 and "CUDA" in r.stderr
    assert not log.exists()


def test_probe_on_cpu_and_refusal_without_cuda():
    out = _run(["-m", "lariat_tpu_torch.tools.probe_device", "--device",
                "cpu", "--kernel-B", "4", "--plain-B", "4"])
    lines = [json.loads(s) for s in out.splitlines()]
    assert [x["probe"] for x in lines] == ["device", "k1_B4", "k1_plain_B4",
                                           "launches"]
    assert lines[1]["per_call_ms"] > 0
    assert lines[2]["useful_cells_per_s"] > 0
    assert lines[3]["sw_extend"] == 0                # the twin on the CPU
    r = subprocess.run(
        [sys.executable, "-m", "lariat_tpu_torch.tools.probe_device"],
        capture_output=True, text=True, cwd=REPO, env=_env(), timeout=300)
    assert r.returncode != 0 and not r.stdout.strip()


def test_entry_step_matches_the_reference_entry():
    """The port's entry() on the CPU against __graft_entry__.entry() of the
    JAX package: the same toy index, reads and lens, and every field of
    the step's result."""
    import __graft_entry__ as ref
    from lariat_tpu_torch.tools.entry import entry
    fn, (dg, reads, lens, mat) = entry("cpu")
    rfn, (rdg, rreads, rlens, rmat) = ref.entry()
    assert (dg.l_pac, dg.sa_intv, dg.fmd.primary) == (
        int(rdg.l_pac), int(rdg.sa_intv), int(rdg.fmd.primary))
    np.testing.assert_array_equal(reads.numpy(), np.asarray(rreads))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(rlens))
    np.testing.assert_array_equal(mat, np.asarray(rmat))
    got = fn(dg, reads, lens, mat)
    want = rfn(rdg, rreads, rlens, rmat)
    for field in ("pos", "is_rev", "n_hits", "score", "mapped"):
        g = getattr(got, field).numpy()
        np.testing.assert_array_equal(
            g, np.asarray(getattr(want, field)).astype(g.dtype),
            err_msg=field)
    assert got.mapped.all()


@pytest.mark.cuda
def test_entry_step_on_the_card_matches_the_twins(cuda_device):  # noqa: F811
    from lariat_tpu_torch.tools.entry import entry
    fn, args = entry()
    got = fn(*args)
    cfn, cargs = entry("cpu")
    want = cfn(*cargs)
    for field in got._fields:
        np.testing.assert_array_equal(getattr(got, field).cpu().numpy(),
                                      getattr(want, field).numpy(),
                                      err_msg=field)


def test_roofline_fm_rank_bound_counts_distinct_rows():
    """K6's bound in the roofline's fm_rank section: 48 bytes a distinct
    fused row the lookups read, plus the rows, codes and ranks in and out,
    over the memory peak."""
    from lariat_tpu_torch.tools import kernel_roofline
    rng = np.random.default_rng(5)
    fm = kernel_roofline.random_index(rng, 1 << 14)
    state = rng.bit_generator.state
    out = kernel_roofline.fm_rank(torch.device("cpu"), rng, fm, 3.352e12,
                                  iters=1, n=4096, with_bound=True)
    rng.bit_generator.state = state
    k = rng.integers(0, fm.seq_len, 4096)
    kk = np.clip(np.where(k >= fm.primary, k - 1, k), 0, fm.seq_len - 1)
    rows = len(np.unique((kk + 1) // 128))
    assert out["rows_distinct"] == rows
    assert out["bound_ms"] == pytest.approx(
        (48 * rows + 4096 * 12) / 3.352e12 * 1e3)
