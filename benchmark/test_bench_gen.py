"""CPU tests of the benchmark's generators: the reads' bytes repeat by
seed, are barcode-grouped 9-line records that the port's ``FastQReader``
reads, and carry their truth in the qnames; shards are barcode-complete.

    python -m pytest benchmark/test_bench_gen.py -q -p no:cacheprovider
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from gen import genome, shards, sim_reads  # noqa: E402

CFG = {"scale": 0.002, "genome_seed": 7, "centromeres": True, "sa_intv": 32}


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("g") / "tiny")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE))
    genome.ensure(CFG, d, env=env)
    return d


MIX = {"pairs_per_bc": 10, "molecules_per_bc": 4, "molecule_len": 50000,
       "read_len": 151, "insert": 200, "insert_sd": 100, "insert_max": 500,
       "indel_rate": 0.0002, "indel_len_p": 0.5, "indel_len_max": 8,
       "error_rate": 0.003}


def _reads(cache, seed, n_bc=12, **kw):
    codes, contigs = genome.load_codes(cache)
    return sim_reads.simulate(codes, contigs, n_bc, dict(MIX, **kw), seed)


def test_genome_is_synth_genome_at_its_scale(cache):
    codes, contigs = genome.load_codes(cache)
    assert len(contigs) == 24 and contigs[0][0] == "chr1"
    assert contigs[0][2] == int(248_900_000 * CFG["scale"])
    assert sum(c[2] for c in contigs) == len(codes)
    with open(os.path.join(cache, "genome.fa"), "rb") as f:
        f.readline()
        line = f.readline().strip()
    assert line == np.frombuffer(b"ACGT", np.uint8)[
        np.asarray(codes[:len(line)])].tobytes()


@pytest.mark.parametrize("seed", [3, 2**31 + 11, -5])
def test_same_seed_same_bytes(cache, tmp_path, seed):
    a, b = tmp_path / "a.fastq", tmp_path / "b.fastq"
    sim_reads.write_fastq(str(a), _reads(cache, seed))
    sim_reads.write_fastq(str(b), _reads(cache, seed))
    assert a.read_bytes() == b.read_bytes()
    sim_reads.write_fastq(str(b), _reads(cache, seed + 1))
    assert a.read_bytes() != b.read_bytes()


def test_records_read_by_the_port_in_barcode_groups(cache, tmp_path):
    from lariat_tpu_torch.io.fastq import FastQReader
    r = _reads(cache, 9)
    path = str(tmp_path / "r.fastq")
    sim_reads.write_fastq(path, r)
    reader = FastQReader(path)
    bounds = r.group_bounds()
    lut = np.frombuffer(b"ACGT", np.uint8)
    for g in range(len(bounds) - 1):
        recs, _ = reader.read_barcode_set(0)
        assert len(recs) == bounds[g + 1] - bounds[g]
        for k, rec in enumerate(recs):
            i = bounds[g] + k
            assert rec.read1 == lut[r.r1[i]].tobytes()
            assert rec.read2 == lut[r.r2[i]].tobytes()
            assert rec.barcode10x.decode() == r.barcodes[r.bc_of[i]] + "-1"
    assert reader.read_barcode_set(0)[0] is None


def _walk(cig, seq, codes, start):
    """Bases of ``seq`` that differ from the genome along ``cig``."""
    d, q, g = 0, 0, start
    for op, ln in cig:
        if op == 0:
            d += int((seq[q:q + ln] != np.asarray(codes[g:g + ln])).sum())
        q += ln if op in (0, 1) else 0
        g += ln if op in (0, 2) else 0
    assert q == len(seq)
    return d


def test_truth_in_the_qnames(cache):
    from reference import judge
    codes, contigs = genome.load_codes(cache)
    r = _reads(cache, 4, n_bc=40, error_rate=0.0, indel_rate=0.01)
    L = r.r1.shape[1]
    assert 0.35 < r.rev[:, 0].mean() < 0.65
    assert (r.rev[:, 0] != r.rev[:, 1]).all()
    assert len(r.gapped) > r.n // 5
    ins = np.abs(r.pos2 - r.pos1) + L
    assert ins.min() >= L and ins.max() <= 500 and ins.std() > 40
    origin = judge.origin_scores(r, codes, contigs)
    for i in range(r.n):
        parts = r.qnames[i].split(":")
        name, p1, p2 = parts[2], int(parts[5]), int(parts[6])
        c = [x for x in contigs if x[0] == name][0]
        assert (p1, p2) == (r.pos1[i], r.pos2[i])
        for m, (read, p) in enumerate(((r.r1[i], p1), (r.r2[i], p2))):
            seq = judge.genome_strand(read, r.rev[i, m])
            cig = r.gapped.get(2 * i + m, [(0, L)])
            # no substitutions: the read is the genome along its truth
            assert _walk(cig, seq, codes, c[1] + p) == 0
            gaps = sum(6 + ln for op, ln in cig if op in (1, 2))
            ins_b = sum(ln for op, ln in cig if op == 1)
            assert origin[i, m] == L - ins_b - gaps


def test_substitutions_at_the_rate(cache):
    codes, contigs = genome.load_codes(cache)
    r = _reads(cache, 5, n_bc=40, indel_rate=0.0)
    L = r.r1.shape[1]
    assert not r.gapped
    offs = np.array([c[1] for c in contigs])[r.contig]
    mm = 0
    for m, (read, pos) in enumerate(((r.r1, r.pos1), (r.r2, r.pos2))):
        g = np.asarray(codes)[(offs + pos)[:, None] + np.arange(L)]
        seq = np.where(r.rev[:, m, None], (3 - read)[:, ::-1], read)
        mm += int((seq != g).sum())
    # a uniform base keeps the old one a quarter of the time
    assert 0.5 < mm / (2 * r.n * L * 0.003 * 0.75) < 1.5


@pytest.mark.parametrize("n", [1, 2, 4])
def test_shards_are_barcode_complete(cache, n):
    r = _reads(cache, 5, n_bc=10)
    rngs = shards.shard_ranges(r.group_bounds(), n)
    assert rngs[0][0] == 0 and rngs[-1][1] == r.n
    for (s0, e0), (s1, _) in zip(rngs, rngs[1:]):
        assert e0 == s1
    for s, e in rngs:
        if s < e:
            assert s == 0 or r.bc_of[s] != r.bc_of[s - 1]
