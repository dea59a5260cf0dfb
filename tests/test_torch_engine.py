"""The slice as a whole: TorchBatchAlignmentEngine.prime_regions on the
explicit CPU device (every wave through the kernels' plain twins) against
lariat_tpu's BatchAlignmentEngine -- with its three Pallas entries in
interpret mode, and on its XLA path -- compared field by field. Also
device seeding (LARIAT_DEVICE_SEED) against host seeding and the JAX
engine's, the engine's refusals: CUDA asked for and absent, an upload
or kernel error under device seeding, and its Python replays when the
native sessions are missing."""

import dataclasses

import numpy as np
import pytest
import torch

from lariat_tpu.align.batch_engine import BatchAlignmentEngine
from lariat_tpu.config import RFAConfig
from lariat_tpu.io.fastq import FastQRecord
from lariat_tpu_torch.align.batch_engine import TorchBatchAlignmentEngine
from lariat_tpu_torch.ops import _build

from test_batch_engine import _rescue_pairs
from test_rfa import _make_pair, dup_genome  # noqa: F401

torch.set_num_threads(1)


def _record(r1: bytes, r2: bytes, name: str) -> FastQRecord:
    q = b"I" * 100
    return FastQRecord(read1=r1, read_qual1=q[:len(r1)], read2=r2,
                       read_qual2=q[:len(r2)],
                       barcode10x=b"AAACAGAGAAAGAT-1",
                       barcode10x_qual=b"J" * 14,
                       raw_barcode10x=b"AAACAGAGAAAGAT",
                       barcode=b"ACGTACGT", barcode_qual=b"IIIIIIII",
                       read_info=name)


def _recs(genome):
    recs = [_make_pair(genome, pos, 300, f"m:{i}")
            for i, pos in enumerate(range(1500, 3100, 200))]   # segdup
    recs += [_make_pair(genome, pos, 280, f"u:{i}")
             for i, pos in enumerate(range(20000, 60000, 9000))]
    rng = np.random.default_rng(58)
    recs += [_record(r1, r2, f"r:{i}")
             for i, (r1, r2) in enumerate(_rescue_pairs(genome, rng, n=4))]
    recs.append(_record(b"", genome[5000:5100], "empty-read1"))
    return recs


def _rows(objs):
    """Dataclass instances -> plain tuples: the port's AlnReg and
    SingleReadAlignment are copies, not the JAX package's classes."""
    return [dataclasses.astuple(o) for o in objs]


def _flat(primes):
    """5-tuples -> comparable plain values, field by field."""
    return [(_rows(regs1), _rows(regs2), flag, _rows(sras1), _rows(sras2))
            for regs1, regs2, flag, sras1, sras2 in primes]


def _pallas_interpret(monkeypatch):
    import lariat_tpu.ops.sw_extend_pallas as sep
    import lariat_tpu.ops.sw_global_pallas as sgp
    import lariat_tpu.ops.sw_local_pallas as slp
    for mod, name in ((sep, "extend_batch_pallas"),
                      (sgp, "global_batch_pallas"),
                      (slp, "local_two_pass_pallas")):
        orig = getattr(mod, name)
        monkeypatch.setattr(
            mod, name,
            lambda *a, _f=orig, **kw: _f(*a, **{**kw, "interpret": True,
                                                "tile_b": 8}))


def test_prime_regions_matches_jax_engine(dup_genome, monkeypatch):  # noqa: F811
    fm, genome = dup_genome
    recs = _recs(genome)
    delta = RFAConfig().chain_score_delta
    _build.reset_launches()
    port = TorchBatchAlignmentEngine(fm, device="cpu")
    primes = port.prime_regions(recs, delta)
    got = _flat(primes)
    # the CPU route runs the plain twins: no kernel launches
    assert _build.launches() == dict.fromkeys(_build.KERNELS, 0)
    assert port.wave_stats["n"] >= 3
    assert any(r.rescued for p in primes for r in p[0] + p[1]), \
        "fixture triggered no mate rescue"
    xla = BatchAlignmentEngine(fm, use_pallas=False)
    assert got == _flat(xla.prime_regions(recs, delta))
    _pallas_interpret(monkeypatch)
    pallas = BatchAlignmentEngine(fm, use_pallas=True)
    pallas.r2a_wave_pad = 0
    assert got == _flat(pallas.prime_regions(recs, delta))


def test_engine_raises_without_cuda(dup_genome, monkeypatch):  # noqa: F811
    fm, _ = dup_genome
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchBatchAlignmentEngine(fm, device="cuda")
    monkeypatch.delenv("LARIAT_TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchBatchAlignmentEngine(fm)        # the default is cuda


def _seed_seqs(genome):
    """tests/test_smem_device.py's align_batch reads: mutated, some
    reverse-complemented."""
    rng = np.random.default_rng(80)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    seqs = []
    for _ in range(25):
        ln = int(rng.integers(40, 152))
        pos = int(rng.integers(0, len(genome) - ln))
        seg = bytearray(genome[pos:pos + ln])
        for _ in range(int(rng.integers(0, 4))):
            seg[int(rng.integers(0, ln))] = b"ACGT"[int(rng.integers(0, 4))]
        if rng.integers(0, 2):
            seg = bytearray(bytes(seg).translate(comp)[::-1])
        seqs.append(bytes(seg))
    return seqs + [b"", genome[2100:2250]]


def test_device_seeding_matches_host_and_jax(dup_genome, monkeypatch):  # noqa: F811
    """LARIAT_DEVICE_SEED=1 on the CPU: align_batch seeds through the
    kernels' twins, and its regions equal the host-seeded port's and the
    JAX engine's with its own device seeding."""
    fm, genome = dup_genome
    seqs = _seed_seqs(genome)
    monkeypatch.setenv("LARIAT_DEVICE_SEED", "0")
    host = TorchBatchAlignmentEngine(fm, device="cpu")
    want = host.align_batch(seqs)
    assert host._seed_state is None and host.wave_stats["n"] > 0
    monkeypatch.setenv("LARIAT_DEVICE_SEED", "1")
    port = TorchBatchAlignmentEngine(fm, device="cpu")
    waves = port.wave_stats["n"]
    got = port.align_batch(seqs)
    assert port._seed_state is not None
    fmd, dg = port._seed_state
    assert dg.fmd is fmd                       # one index on the device
    assert port.wave_stats["n"] > waves
    assert got == want
    jax_eng = BatchAlignmentEngine(fm, use_pallas=False)
    assert [_rows(r) for r in jax_eng.align_batch(seqs)] == \
        [_rows(r) for r in want]


def test_device_seeding_policy(dup_genome, monkeypatch):  # noqa: F811
    """Unset on the CPU (and below the genome-size threshold) or =0: the
    host seeder runs and nothing is uploaded."""
    fm, genome = dup_genome
    port = TorchBatchAlignmentEngine(fm, device="cpu")
    q = [np.frombuffer(genome[100:200], np.uint8) % 4]
    monkeypatch.delenv("LARIAT_DEVICE_SEED", raising=False)
    monkeypatch.setattr(TorchBatchAlignmentEngine,
                        "DEVICE_SEED_AUTO_MIN_LPAC", 0)
    assert port._device_seed(q) is None      # auto: CUDA only
    monkeypatch.setenv("LARIAT_DEVICE_SEED", "0")
    assert port._device_seed(q) is None
    monkeypatch.setenv("LARIAT_DEVICE_SEED", "1")
    assert port._device_seed([]) is None
    assert port._seed_state is None


def test_forced_device_seeding_raises(dup_genome, monkeypatch):  # noqa: F811
    """An upload error or a kernel error under device seeding raises: no
    fallback to the host seeder."""
    from lariat_tpu_torch.ops import fm_batch, smem_device
    fm, genome = dup_genome
    monkeypatch.setenv("LARIAT_DEVICE_SEED", "1")

    def fail(*a, **kw):
        raise RuntimeError("smem_twoptr kernel launch failed")

    monkeypatch.setattr(smem_device, "min_starts_twoptr", fail)
    port = TorchBatchAlignmentEngine(fm, device="cpu")
    with pytest.raises(RuntimeError, match="launch failed"):
        port.align_batch([genome[100:200]])

    def fail_upload(*a, **kw):
        raise RuntimeError("index upload failed")

    monkeypatch.setattr(fm_batch.DeviceFMIndex, "from_host", fail_upload)
    port = TorchBatchAlignmentEngine(fm, device="cpu")
    with pytest.raises(RuntimeError, match="upload failed"):
        port.align_batch([genome[100:200]])
    with pytest.raises(RuntimeError, match="upload failed"):   # stays so
        port.align_batch([genome[100:200]])
    assert port._seed_state is None


def test_missing_native_sessions_take_python_replays(dup_genome,  # noqa: F811
                                                     monkeypatch):
    """Without the native sessions the engine builds: align_batch takes the Python replay of chain2aln and
    reg2aln_batch the Python ladder, with the sessions' regions and
    alignments."""
    from lariat_tpu_torch.align import batch_engine, native_engine
    fm, genome = dup_genome
    seqs = _seed_seqs(genome)
    want = TorchBatchAlignmentEngine(fm, device="cpu")
    want_regs = want.align_batch(seqs)
    tasks = [(s, r) for s, regs in zip(seqs, want_regs) for r in regs]
    want_sras = want.reg2aln_batch(tasks)
    for cls in (native_engine.Align1Session, native_engine.Reg2AlnSession):
        monkeypatch.setattr(cls, "available", staticmethod(lambda: False))
    taken = []
    for name in ("_align_batch_python", "_reg2aln_python"):
        orig = getattr(batch_engine.TorchBatchAlignmentEngine, name)
        monkeypatch.setattr(
            batch_engine.TorchBatchAlignmentEngine, name,
            lambda self, *a, _f=orig, _n=name: taken.append(_n) or
            _f(self, *a))
    port = TorchBatchAlignmentEngine(fm, device="cpu")
    assert port.align_batch(seqs) == want_regs
    assert port.reg2aln_batch(tasks) == want_sras
    assert taken == ["_align_batch_python", "_reg2aln_python"]
