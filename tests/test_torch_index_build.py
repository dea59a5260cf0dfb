"""The port's lean index build (``lariat_tpu_torch/index/fmindex.py``
``build_index``) against the JAX package's: the same files from
``save_dir``, byte for byte, whatever the chunk size, and a fraction of
its memory once the suffix array is handed in."""

import filecmp
import os
import tracemalloc

import numpy as np
import pytest

from lariat_tpu.index import fmindex as ref_fmindex
from lariat_tpu.index import suffix as ref_suffix
from lariat_tpu_torch.index import fmindex
from lariat_tpu_torch.index import suffix

BASES = np.frombuffer(b"ACGT", np.uint8)


def _write_fasta(path, contigs):
    with open(path, "w") as f:
        for name, s in contigs:
            f.write(f">{name} test contig\n")
            for i in range(0, len(s), 60):
                f.write(s[i:i + 60].decode() + "\n")
    return str(path)


def _random(rng, n):
    return BASES[rng.integers(0, 4, n)].tobytes()


def _single(rng):
    return [("chr1", _random(rng, 12000))]


def _several(rng):
    # a repeat across contigs, so suffixes share long prefixes
    a = _random(rng, 7000)
    b = _random(rng, 3000) + a[1000:2500] + _random(rng, 2000)
    return [("chrA", a), ("chrB", b), ("chrC", _random(rng, 900)),
            ("chrD", _random(rng, 61))]


def _iupac(rng):
    # runs of N and other IUPAC codes (bwa's amb regions, filled by the
    # drand48 LCG), lower case, and a contig that is mostly N
    s = bytearray(_random(rng, 9000))
    s[100:140] = b"N" * 40
    s[2000:2003] = b"RYK"
    s[3000:3010] = b"nnnnnMMSWW"
    s[5000:5600] = _random(rng, 600).lower()
    s[8999] = ord("B")
    return [("chrI", bytes(s)),
            ("chrN", b"N" * 300 + _random(rng, 200) + b"DHVN" * 5)]


GENOMES = {"single": _single, "several": _several, "iupac": _iupac}
CHUNKS = ("inside", "first", "last", "one", "past_text")


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    """Each genome's FASTA and the JAX package's index of it: the saved
    directory and its primary row."""
    out = {}
    for k, (name, make) in enumerate(GENOMES.items()):
        d = tmp_path_factory.mktemp(f"ref_{name}")
        fa = _write_fasta(d / "g.fa", make(np.random.default_rng(10 + k)))
        fm = ref_fmindex.build_index(fa, sa_intv=16)
        fm.save_dir(str(d / "ref"))
        out[name] = (fa, str(d / "ref.lariat.d"), fm.primary, fm.seq_len)
    return out


def _chunk(mode, primary, seq_len):
    """A chunk that puts the primary row inside a chunk, on its first or
    its last row; 1; or more rows than the SA has."""
    if mode == "inside":
        c = max(3, primary // 3 + 2)
        while primary % c in (0, c - 1):
            c += 1
        return c
    return {"first": primary, "last": primary + 1, "one": 1,
            "past_text": seq_len + 7}[mode]


def _same_dir(a, b):
    """Two .lariat.d directories: the same files, every .npy byte for
    byte, meta.npz array by array (its zip entries carry a time)."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and "meta.npz" in names
    for n in names:
        if n.endswith(".npz"):
            za, zb = np.load(os.path.join(a, n)), np.load(os.path.join(b, n))
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert za[k].dtype == zb[k].dtype, k
                np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
        else:
            assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                               shallow=False), n


def _int64_sa(monkeypatch, module):
    """``module.suffix_array`` returning int64, as it does at hg38 scale."""
    real = module.suffix_array
    monkeypatch.setattr(module, "suffix_array",
                        lambda text, k: real(text, k).astype(np.int64))


@pytest.mark.parametrize("mode", CHUNKS)
@pytest.mark.parametrize("genome", sorted(GENOMES))
def test_build_is_byte_identical(references, genome, mode, tmp_path,
                                 monkeypatch):
    fa, ref_dir, primary, seq_len = references[genome]
    chunk = _chunk(mode, primary, seq_len)
    assert chunk >= 1
    if mode == "first":
        assert primary > 0 and primary % chunk == 0
    monkeypatch.setattr(fmindex, "_BUILD_CHUNK", chunk)
    fm = fmindex.build_index(fa, sa_intv=16)
    assert fm.primary == primary
    fm.save_dir(str(tmp_path / "port"))
    _same_dir(str(tmp_path / "port.lariat.d"), ref_dir)


@pytest.mark.parametrize("mode", ("inside", "first", "last"))
def test_build_with_int64_sa_is_byte_identical(references, mode, tmp_path,
                                               monkeypatch):
    """The hg38 dtype: both packages' suffix arrays int64."""
    fa, _, primary, seq_len = references["iupac"]
    _int64_sa(monkeypatch, suffix)
    _int64_sa(monkeypatch, ref_suffix)
    monkeypatch.setattr(fmindex, "_BUILD_CHUNK",
                        _chunk(mode, primary, seq_len))
    fmindex.build_index(fa, sa_intv=32).save_dir(str(tmp_path / "port"))
    ref_fmindex.build_index(fa, sa_intv=32).save_dir(str(tmp_path / "ref"))
    _same_dir(str(tmp_path / "port.lariat.d"), str(tmp_path / "ref.lariat.d"))


@pytest.mark.parametrize("chunk", (1, 128, 129, 1000, 1 << 20))
def test_blocked_counts_in_chunks(chunk, monkeypatch):
    """The occ checkpoints counted a chunk at a time equal the JAX
    package's whole-array count, partial last block included."""
    codes = np.random.default_rng(3).integers(0, 4, 5000).astype(np.uint8)
    monkeypatch.setattr(fmindex, "_BUILD_CHUNK", chunk)
    for n in (0, 1, 128, 4999, 5000):
        got = fmindex._blocked_counts(codes[:n], fmindex.OCC_INTERVAL)
        want = ref_fmindex._blocked_counts(codes[:n], fmindex.OCC_INTERVAL)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_build_peak_memory_is_half_the_reference(tmp_path, monkeypatch):
    """With the SA handed in as int64 (SA-IS's dtype at hg38 scale) and
    made before tracing starts, the port's traced numpy peak on a 3 Mbp
    genome is at most half the JAX build's. Measured on the CPU: 2.63
    bytes a text row against 12.50 (0.21x): fwd, T$ and the BWT against
    those, the text and SA - 1 in int64 with its gathered rows."""
    rng = np.random.default_rng(5)
    fa = _write_fasta(tmp_path / "g.fa", [("chr1", _random(rng, 1_800_000)),
                                          ("chr2", _random(rng, 1_200_000))])
    fwd = fmindex.encode_genome(fa)[0]
    sa = suffix.suffix_array(fmindex._text_with_sentinel(fwd), 5).astype(
        np.int64)
    rows = 2 * len(fwd) + 1
    del fwd
    for module in (suffix, ref_suffix):
        monkeypatch.setattr(module, "suffix_array", lambda text, k: sa)
    monkeypatch.setattr(fmindex, "_BUILD_CHUNK", 1 << 16)
    peaks = {}
    for name, build in (("ref", ref_fmindex.build_index),
                        ("port", fmindex.build_index)):
        tracemalloc.start()
        try:
            fm = build(fa)
            peaks[name] = tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()
        peaks[name + "_primary"] = fm.primary
        del fm
    assert peaks["port_primary"] == peaks["ref_primary"]
    per_row = {k: peaks[k] / rows for k in ("ref", "port")}
    assert per_row["ref"] > 8, per_row     # it holds sa - 1 in int64
    assert peaks["port"] <= 0.5 * peaks["ref"], per_row
