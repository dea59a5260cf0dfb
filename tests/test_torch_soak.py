"""The soak test's messy reads (tests/test_soak.py: indels, N runs,
chimeric joins, homopolymers, junk, reads of 1-24 bases) through the port.

On the CPU: the port's ``TorchBatchAlignmentEngine`` (every wave and, with
``LARIAT_DEVICE_SEED=1``, the seeding through the kernels' plain twins)
against the JAX ``BatchAlignmentEngine(use_pallas=False)`` and the port's
host ``AlignmentEngine.align1``, field for field; its priming pass over
messy pairs against the JAX engine's; the port's ``process_barcode`` over
messy pairs against the JAX package's, record for record; and the port's
CLI, every pair primed, over a FASTQ of ``tools/messy_reads.py`` against
``lariat_tpu.cli -use_device off``. ``-m cuda``: the same reads on the card
against the twins, exact (integer scores, coordinates and CIGARs). The
regular suite runs 2 rounds; RUN_SLOW=1 runs 8.
"""

import dataclasses
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lariat_tpu.align.batch_engine import BatchAlignmentEngine
from lariat_tpu.config import RFAConfig
from lariat_tpu.io.bamread import BamFile
from lariat_tpu.io.fastq import FastQRecord
from lariat_tpu.rfa.pipeline import process_barcode
from lariat_tpu_torch.align.batch_engine import TorchBatchAlignmentEngine
from lariat_tpu_torch.align.engine import AlignmentEngine, encode_read
from lariat_tpu_torch.io.fastq import FastQRecord as PortRecord
from lariat_tpu_torch.rfa.pipeline import process_barcode as port_barcode
from lariat_tpu_torch.tools import messy_reads

from test_rfa import dup_genome  # noqa: F401
from test_soak import _messy_read
from test_torch_cli import REPO, _env
from test_torch_sw_extend import cuda_device  # noqa: F401

torch.set_num_threads(1)

N_ROUNDS = 8 if os.environ.get("RUN_SLOW") else 2


def _rows(regs):
    return [dataclasses.astuple(r) for r in regs]


def _seqs(genome, round_, n=20):
    """test_soak.py's batch of a round: ``n`` messy reads."""
    rng = np.random.default_rng(round_ * 977 + 5)
    return [messy_reads.messy_read(genome, rng) for _ in range(n)]


def _pairs(genome, round_, cls, n=24):
    """test_soak.py's pipeline records of a round, as ``cls`` (the JAX
    package's FastQRecord or the port's copy)."""
    rng = np.random.default_rng(round_ * 31 + 11)
    recs = []
    for i in range(n):
        r1 = messy_reads.messy_read(genome, rng)
        r2 = messy_reads.messy_read(genome, rng)
        recs.append(cls(
            read1=r1, read_qual1=b"I" * len(r1), read2=r2,
            read_qual2=b"I" * len(r2), barcode10x=b"ACGTACGTACGTAA-1",
            barcode10x_qual=b"J" * 14, raw_barcode10x=b"ACGTACGTACGTAA",
            barcode=b"ACGTACGT", barcode_qual=b"IIIIIIII",
            read_info=f"soak:{round_}:{i}"))
    return recs


def test_messy_read_is_the_soak_tests(dup_genome):  # noqa: F811
    """The port's generator draws test_soak.py's reads from the same
    random stream, so chip_smoke.py's messy FASTQ holds the soak's
    kinds."""
    _, genome = dup_genome
    for seed in range(6):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        assert [messy_reads.messy_read(genome, a) for _ in range(50)] == \
            [_messy_read(genome, b) for _ in range(50)]


@pytest.mark.parametrize("seeder", ["host", "device"])
@pytest.mark.parametrize("round_", range(N_ROUNDS))
def test_messy_batch_matches_jax_and_host(dup_genome, round_,  # noqa: F811
                                          seeder, monkeypatch):
    fm, genome = dup_genome
    seqs = _seqs(genome, round_)
    monkeypatch.setenv("LARIAT_DEVICE_SEED", "1" if seeder == "device"
                       else "0")
    port = TorchBatchAlignmentEngine(fm, device="cpu")
    got = [_rows(r) for r in port.align_batch(seqs)]
    assert (port._seed_state is not None) == (seeder == "device")
    jax_eng = BatchAlignmentEngine(fm, use_pallas=False)
    assert got == [_rows(r) for r in jax_eng.align_batch(seqs)]
    host = AlignmentEngine(fm)
    for seq, g in zip(seqs, got):
        assert g == _rows(host.align1(encode_read(seq))), seq


@pytest.mark.parametrize("round_", range(N_ROUNDS))
def test_messy_prime_regions_matches_jax(dup_genome, round_):  # noqa: F811
    """The whole priming pass (extension, mate rescue, reg2aln) over
    messy pairs: the port's twins against the JAX engine's XLA path."""
    fm, genome = dup_genome
    delta = RFAConfig().chain_score_delta
    recs = _pairs(genome, round_, FastQRecord)
    port = TorchBatchAlignmentEngine(fm, device="cpu")
    got = port.prime_regions(recs, delta)
    want = BatchAlignmentEngine(fm, use_pallas=False).prime_regions(recs,
                                                                    delta)

    def flat(primes):
        return [(_rows(a), _rows(b), f, _rows(c), _rows(d))
                for a, b, f, c, d in primes]

    assert flat(got) == flat(want)
    assert port.path_log()["largest_batch_pairs"] == len(recs)


def _scalars(obj):
    """A dataclass's own values (numbers, strings, tuples and lists), not
    the objects it links to."""
    return tuple(v for f in dataclasses.fields(obj)
                 if isinstance(v := getattr(obj, f.name),
                               (int, float, str, tuple, list)))


def _record(a):
    """An Alignment's own fields, its mate's id and its MAPQ data's."""
    mate, mq = a.mate_alignment, a.mapq_data
    return (_scalars(a), None if mate is None else mate.id,
            None if mq is None else _scalars(mq))


@pytest.mark.parametrize("round_", range(N_ROUNDS))
def test_messy_full_pipeline_matches_jax(dup_genome, round_):  # noqa: F811
    """The port's per-barcode RFA pipeline over messy pairs completes, and
    returns every read once, with one active alignment, and the JAX
    package's records."""
    fm, genome = dup_genome
    got = port_barcode(AlignmentEngine(fm), _pairs(genome, round_,
                                                   PortRecord),
                       True, RFAConfig())
    from lariat_tpu.align.engine import AlignmentEngine as JaxEngine
    want = process_barcode(JaxEngine(fm), _pairs(genome, round_,
                                                 FastQRecord),
                           True, RFAConfig())
    assert len(got.alignments) == len(want.alignments) == 48
    for read_id, (g, w) in enumerate(zip(got.alignments, want.alignments)):
        assert sum(a.active for a in g) == 1, read_id
        assert [_record(a) for a in g] == [_record(a) for a in w], read_id
    assert got.attach_bx == want.attach_bx


def test_messy_cli_primed_matches_jax_host(dup_genome, tmp_path):  # noqa: F811
    """tools/messy_reads.py's FASTQ (4 barcodes x 24 pairs) through the
    port's CLI on the CPU, every pair primed, with host and with device
    seeding: the records of ``lariat_tpu.cli -use_device off``."""
    _, genome = dup_genome
    fasta = tmp_path / "g.fa"
    with open(fasta, "w") as f:
        f.write(">chrT\n")
        for i in range(0, len(genome), 70):
            f.write(genome[i:i + 70].decode() + "\n")
    assert messy_reads.load_genome(str(fasta)) == genome
    fq = str(tmp_path / "messy.fastq.gz")
    assert messy_reads.main([str(fasta), fq, "--barcodes", "4",
                             "--pairs-per-bc", "24"]) == 0
    runs = {"host": ("lariat_tpu.cli", "off", {}),
            "port": ("lariat_tpu_torch.cli", "on",
                     {"LARIAT_TORCH_DEVICE": "cpu"}),
            "port_seed": ("lariat_tpu_torch.cli", "on",
                          {"LARIAT_TORCH_DEVICE": "cpu",
                           "LARIAT_DEVICE_SEED": "1"})}
    for name, (mod, mode, extra) in runs.items():
        r = subprocess.run(
            [sys.executable, "-m", mod, "-reads", fq, "-genome", str(fasta),
             "-output", str(tmp_path / name), "-threads", "2",
             "-use_device", mode, "-first_chunk"],
            capture_output=True, text=True, cwd=REPO, env=_env(**extra),
            timeout=600)
        assert r.returncode == 0, r.stderr[-2000:]
        assert "Processed 96 read pairs across 4 barcodes" in r.stdout
        if mode == "on":
            assert "primed pairs 96  host pairs 0" in r.stdout, r.stdout
    bams = sorted(os.path.basename(p)
                  for p in glob.glob(str(tmp_path / "host" / "*.bam")))
    for port in ("port", "port_seed"):
        assert bams and bams == sorted(
            os.path.basename(p)
            for p in glob.glob(str(tmp_path / port / "*.bam")))
        for k in bams:
            assert list(BamFile(str(tmp_path / "host" / k))) == \
                list(BamFile(str(tmp_path / port / k))), (port, k)


@pytest.mark.cuda
@pytest.mark.parametrize("seeder", ["host", "device"])
def test_messy_reads_on_the_card_match_twins(  # noqa: F811
        dup_genome, cuda_device, seeder, monkeypatch):  # noqa: F811
    """Every round's messy reads and pairs on the card (K1-K3, K2b; K4a-K4c
    and K5 when seeding on the device) against the same engine on the CPU
    twins: equal, field for field."""
    fm, genome = dup_genome
    delta = RFAConfig().chain_score_delta
    monkeypatch.setenv("LARIAT_DEVICE_SEED", "1" if seeder == "device"
                       else "0")
    cpu = TorchBatchAlignmentEngine(fm, device="cpu")
    card = TorchBatchAlignmentEngine(fm, device=cuda_device)
    for round_ in range(N_ROUNDS):
        seqs = _seqs(genome, round_)
        assert [_rows(r) for r in card.align_batch(seqs)] == \
            [_rows(r) for r in cpu.align_batch(seqs)], round_
        recs = _pairs(genome, round_, FastQRecord)
        for g, w in zip(card.prime_regions(recs, delta),
                        cpu.prime_regions(recs, delta)):
            assert [_rows(x) if isinstance(x, list) else x for x in g] == \
                [_rows(x) if isinstance(x, list) else x for x in w], round_
    log = card.path_log()
    assert log["largest_launches"]["sw_extend"] > 0
    assert log["cuda_peak_bytes"] > 0
    if seeder == "device":
        assert log["seed_device_batches"] > 0
