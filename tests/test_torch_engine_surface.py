"""TorchBatchAlignmentEngine's drop-in surface on the explicit CPU device
against lariat_tpu's BatchAlignmentEngine (use_pallas=False):
``prime_regions`` with and without a score delta, ``prime_pairs`` and its
``_pair_cache``, ``align1`` through the batch path; and the cooperative
abort: ``abort_prime`` set after a wave raises ``PrimeAborted`` at the next
wave boundary and closes every session it opened without finishing it.
Dataclasses compare by ``dataclasses.astuple`` (exact)."""

import dataclasses

import numpy as np
import pytest
import torch

from lariat_tpu.align.batch_engine import BatchAlignmentEngine
from lariat_tpu.align.engine import encode_read
from lariat_tpu.config import RFAConfig
from lariat_tpu_torch.align import native_engine
from lariat_tpu_torch.align.batch_engine import (PrimeAborted,
                                                 TorchBatchAlignmentEngine)

from test_rfa import dup_genome  # noqa: F401
from test_torch_engine import _record, _recs, _seed_seqs

torch.set_num_threads(1)

DELTA = RFAConfig().chain_score_delta


def _plain(obj):
    """Dataclasses, tuples and lists -> nested plain tuples (the port's
    dataclasses are copies of the JAX package's, not the same classes)."""
    if dataclasses.is_dataclass(obj):
        return dataclasses.astuple(obj)
    if isinstance(obj, (list, tuple)):
        return tuple(_plain(o) for o in obj)
    return obj


@pytest.mark.parametrize("delta", [None, DELTA])
def test_prime_regions_matches_jax(dup_genome, delta):  # noqa: F811
    fm, genome = dup_genome
    recs = _recs(genome)
    got = TorchBatchAlignmentEngine(fm, device="cpu").prime_regions(
        recs, delta)
    want = BatchAlignmentEngine(fm, use_pallas=False).prime_regions(
        recs, delta)
    assert len(got) == len(recs)
    assert all(len(p) == (2 if delta is None else 5) for p in got)
    assert _plain(got) == _plain(want)


def test_prime_regions_without_delta_is_pre_rescue(dup_genome):  # noqa: F811
    """Without a delta the regions are align_batch's, before rescue; the
    full pass's regions hold rescued ones besides."""
    fm, genome = dup_genome
    recs = _recs(genome)
    eng = TorchBatchAlignmentEngine(fm, device="cpu")
    pre = eng.prime_regions(recs)
    full = eng.prime_regions(recs, DELTA)
    assert not any(r.rescued for p in pre for r in p[0] + p[1])
    assert any(r.rescued for p in full for r in p[0] + p[1])


def test_prime_pairs_cache_matches_jax(dup_genome):  # noqa: F811
    fm, genome = dup_genome
    recs = _recs(genome)
    port = TorchBatchAlignmentEngine(fm, device="cpu")
    ref = BatchAlignmentEngine(fm, use_pallas=False)
    port.prime_pairs(recs, DELTA)
    ref.prime_pairs(recs, DELTA)
    assert sorted(port._pair_cache) == sorted(id(r) for r in recs)
    got = [_plain(port._pair_cache[id(r)]) for r in recs]
    assert got == [_plain(ref._pair_cache[id(r)]) for r in recs]
    assert any(ea1 and ea2 for ea1, ea2 in got)


def test_align1_matches_jax(dup_genome):  # noqa: F811
    fm, genome = dup_genome
    port = TorchBatchAlignmentEngine(fm, device="cpu")
    ref = BatchAlignmentEngine(fm, use_pallas=False)
    n_regs = 0
    for seq in _seed_seqs(genome):
        q = encode_read(seq)
        got = port.align1(q)
        assert _plain(got) == _plain(ref.align1(q))
        n_regs += len(got)
    assert n_regs > 20


def _track_sessions(monkeypatch):
    """Every native session the engine opens, with whether it finished."""
    opened = []

    def tracked(base):
        class Tracked(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self.finished = False
                opened.append(self)

            def finish(self):
                self.finished = True
                return super().finish()
        return Tracked

    for name in ("Align1Session", "Reg2AlnSession"):
        monkeypatch.setattr(native_engine, name,
                            tracked(getattr(native_engine, name)))
    return opened


def _abort_after(monkeypatch, where):
    """Set ``abort_prime`` right after the first device wave (``extend``,
    ``rescue``: the abort lands in the extension loop when it has a second
    wave, else at the rescue wave) or after the rescue wave
    (``reg2aln``: it lands in the reg2aln loop)."""
    cls = TorchBatchAlignmentEngine
    name = "local_align_device" if where == "reg2aln" else "_wave_done"
    orig = getattr(cls, name)

    def hook(self, *a):
        out = orig(self, *a)
        self.abort_prime = True
        return out
    monkeypatch.setattr(cls, name, hook)


def _pairs(seqs):
    return [_record(a, b, f"s:{i}")
            for i, (a, b) in enumerate(zip(seqs[0::2], seqs[1::2]))]


@pytest.mark.parametrize("where", ["extend", "rescue", "reg2aln"])
def test_abort_raises_and_closes_sessions(dup_genome, monkeypatch, where):  # noqa: F811
    """The abort lands at the next wave boundary: in the extension loop
    (the fixture's seeds take two waves), at the rescue wave (one), or in
    the reg2aln loop; every session opened is closed, none finished past
    the abort."""
    fm, genome = dup_genome
    recs = (_pairs(_seed_seqs(genome)) if where == "extend"
            else _recs(genome))
    opened = _track_sessions(monkeypatch)
    eng = TorchBatchAlignmentEngine(fm, device="cpu")
    _abort_after(monkeypatch, where)
    with pytest.raises(PrimeAborted):
        eng.prime_regions(recs, DELTA)
    assert opened and all(s.handle is None for s in opened)   # all closed
    a1 = [s for s in opened if isinstance(s, native_engine.Align1Session)]
    r2 = [s for s in opened if isinstance(s, native_engine.Reg2AlnSession)]
    assert len(a1) == 1
    assert a1[0].finished == (where != "extend")
    assert bool(r2) == (where == "reg2aln")
    assert not any(s.finished for s in r2)
    # a pass started after the abort stops at its first boundary
    with pytest.raises(PrimeAborted):
        eng.prime_regions(recs[:2], DELTA)
    monkeypatch.undo()
    eng.abort_prime = False
    assert _plain(eng.prime_regions(recs[:3], DELTA)) == _plain(
        TorchBatchAlignmentEngine(fm, device="cpu").prime_regions(recs[:3],
                                                                  DELTA))


def test_device_seed_reraises_abort(dup_genome, monkeypatch):  # noqa: F811
    """The seeding call is a wave boundary too, under device seeding."""
    fm, genome = dup_genome
    monkeypatch.setenv("LARIAT_DEVICE_SEED", "1")
    eng = TorchBatchAlignmentEngine(fm, device="cpu")
    eng.abort_prime = True
    q = [np.frombuffer(genome[100:200], np.uint8) % 4]
    with pytest.raises(PrimeAborted):
        eng._device_seed(q)
    assert eng._seed_state is None
