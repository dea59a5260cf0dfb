"""The engine's paths without the native sessions, and auto seeding's
background index upload, on the explicit CPU device (every wave through
the kernels' plain twins):

- the Python replay of chain2aln (``_align_batch_python``) and the Python
  reg2aln ladder (``_reg2aln_python``) against the port's sessions, the JAX
  package's replays and the host engine, field by field;
- the port's ``cigars_from_ops`` / ``unpack_ops`` against the JAX
  package's, and the waves' padding (``ksw.pad_tiles``);
- the CLI both ways against ``lariat_tpu.cli`` with the same flags;
- the background upload: auto mode host-seeds until the upload lands,
  forced mode waits, an upload error raises and stays raised.

The ``cuda`` cases run the new paths on the card and skip here."""

import dataclasses
import glob
import json
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from lariat_tpu.align.batch_engine import BatchAlignmentEngine
from lariat_tpu.io.bamread import BamFile
from lariat_tpu_torch.align import ksw, native_engine
from lariat_tpu_torch.align.batch_engine import TorchBatchAlignmentEngine
from lariat_tpu_torch.align.engine import AlignmentEngine, encode_read
from lariat_tpu_torch.config import AlignerConfig
from lariat_tpu_torch.ops import _build, fm_batch, smem_device, sw_global

from test_batch_engine import _reads
from test_rfa import dup_genome  # noqa: F401
from test_torch_cli import REPO, _env, _inputs
from test_torch_sw_extend import cuda_device  # noqa: F401

torch.set_num_threads(1)


def _rows(per_read):
    """Regions per read -> plain tuples (the port's classes are copies)."""
    return [[dataclasses.astuple(r) for r in regs] for regs in per_read]


def _sras(alns):
    return [dataclasses.astuple(a) for a in alns]


def _tasks(fm, seqs):
    host = AlignmentEngine(fm)
    return [(s, r) for s in seqs for r in host.align1(encode_read(s))]


@pytest.fixture(scope="module")
def seqs(dup_genome):  # noqa: F811
    return _reads(dup_genome[1], np.random.default_rng(97), n=300)


def _indel_reads(genome, n=60):
    """Reads with a deletion or an insertion of 3-29 bases: past a narrow
    band's 3/4, so their extensions take the band retry."""
    rng = np.random.default_rng(4)
    out = []
    for k in range(n):
        p = int(rng.integers(5000, 70000))
        d = int(rng.integers(3, 30))
        a = int(rng.integers(20, 130))
        if k % 2:
            out.append(genome[p:p + a] + genome[p + a + d:p + 150 + d])
        else:
            ins = bytes(b"ACGT"[int(c)] for c in rng.integers(0, 4, d))
            out.append(genome[p:p + a] + ins + genome[p + a:p + 150 - d])
    return out


@pytest.mark.parametrize("band", [None, 10], ids=["default", "band10"])
def test_python_replay_matches_session_jax_and_host(dup_genome, seqs,  # noqa: F811
                                                    band):
    """At the default band no extension retries; at band 10 the indel
    reads take both retry waves (four K1 waves)."""
    from lariat_tpu.config import AlignerConfig as JaxConfig
    fm, genome = dup_genome
    kw = {} if band is None else {"band_width": band}
    if band is not None:
        seqs = seqs[:100] + _indel_reads(genome)
    port = TorchBatchAlignmentEngine(fm, opt=AlignerConfig(**kw),
                                     device="cpu")
    got = _rows(port._align_batch_python(seqs))
    assert port.wave_stats["n"] == (2 if band is None else 4)
    assert got == _rows(port._align_batch_session(seqs))
    host = AlignmentEngine(fm, opt=AlignerConfig(**kw))
    assert got == _rows([host.align1(encode_read(s)) for s in seqs])
    jax_eng = BatchAlignmentEngine(fm, opt=JaxConfig(**kw), use_pallas=False)
    assert got == _rows(jax_eng._align_batch_python(seqs))


def test_python_replay_right_waves_take_pen_clip3(dup_genome):  # noqa: F811
    """The replay's right waves take pen_clip3 as their end bonus, as
    mem_chain2aln does (the reference's replay takes pen_clip5 for every
    wave): equal to the host engine and the session with the two apart."""
    fm, genome = dup_genome
    opt = AlignerConfig(band_width=10, pen_clip3=1)
    seqs = _indel_reads(genome)
    port = TorchBatchAlignmentEngine(fm, opt=opt, device="cpu")
    got = _rows(port._align_batch_python(seqs))
    assert got == _rows(port._align_batch_session(seqs))
    host = AlignmentEngine(fm, opt=opt)
    assert got == _rows([host.align1(encode_read(s)) for s in seqs])


def test_reg2aln_python_matches_session_jax_and_host(dup_genome, seqs):  # noqa: F811
    fm, _ = dup_genome
    tasks = _tasks(fm, seqs[:150]) + [(seqs[0], None)]
    port = TorchBatchAlignmentEngine(fm, device="cpu")
    got = _sras(port._reg2aln_python(tasks))
    assert got == _sras(port._reg2aln_session(tasks))
    host = AlignmentEngine(fm)
    assert got == _sras([host.reg2aln(s, r) for s, r in tasks])
    jax_eng = BatchAlignmentEngine(fm, use_pallas=False)
    assert got == _sras(jax_eng._reg2aln_python(tasks))


def test_python_paths_without_native_sessions(dup_genome, seqs,  # noqa: F811
                                              monkeypatch):
    """With both sessions unavailable the engine builds, and align_batch
    and reg2aln_batch take the Python replays, split over two devices
    too."""
    fm, _ = dup_genome
    tasks = _tasks(fm, seqs[:60])
    want = TorchBatchAlignmentEngine(fm, device="cpu")
    want_regs = _rows(want.align_batch(seqs[:60]))
    want_sras = _sras(want.reg2aln_batch(tasks))
    for cls in (native_engine.Align1Session, native_engine.Reg2AlnSession):
        monkeypatch.setattr(cls, "available", staticmethod(lambda: False))
    for devices in (None, ["cpu", "cpu"]):
        port = TorchBatchAlignmentEngine(
            fm, **({"device": "cpu"} if devices is None
                   else {"devices": devices}))
        assert _rows(port.align_batch(seqs[:60])) == want_regs
        assert _sras(port.reg2aln_batch(tasks)) == want_sras
        # the ladder's waves split, _ExtBatcher's do not
        assert (port.shard_waves > 0) == (devices is not None)


def _random_ops(rng, B=40, S=64):
    """Random unpacked walks: ops 0-2, then 255 from a random end on."""
    ops = rng.integers(0, 3, (B, S)).astype(np.uint8)
    ends = rng.integers(0, S + 1, B)
    ops[np.arange(S)[None, :] >= ends[:, None]] = 255
    i_fin = rng.integers(-1, 6, B).astype(np.int32)
    k_fin = rng.integers(-1, 6, B).astype(np.int32)
    return ops, i_fin, k_fin


@pytest.mark.parametrize("native", [True, False])
def test_cigars_from_ops_matches_jax(native, monkeypatch):
    import lariat_tpu.ops.sw_global_pallas as sgp
    ops, i_fin, k_fin = _random_ops(np.random.default_rng(5))
    if not native:
        for mod in (sgp, sw_global):
            monkeypatch.setattr(mod, "cigars_from_ops_raw",
                                lambda *a: None)
    got = sw_global.cigars_from_ops(ops, i_fin, k_fin)
    assert got == [[tuple(c) for c in cig]
                   for cig in sgp.cigars_from_ops(ops, i_fin, k_fin)]
    assert any(len(c) > 2 for c in got)


@pytest.mark.parametrize("n,lq,lt", [(1, 1, 0), (128, 64, 65),
                                      (129, 150, 300), (300, 20, 640)])
def test_pad_tiles_pads_as_the_reference(n, lq, lt):
    """Lengths to multiples of 64 (at least 64), the batch to a power of
    two of at least 128; every task's codes and lengths in its row, zero
    rows after."""
    rng = np.random.default_rng(n)
    qs = [rng.integers(0, 5, int(rng.integers(0, lq + 1))).astype(np.uint8)
          for _ in range(n)]
    ts = [rng.integers(0, 5, int(rng.integers(0, lt + 1))).astype(np.int64)
          for _ in range(n)]
    qs[-1], ts[-1] = qs[-1][:0].copy(), ts[-1][:0].copy()
    qs[0] = rng.integers(0, 5, lq).astype(np.uint8)
    ts[0] = rng.integers(0, 5, lt).astype(np.int64)
    qa, qlen, ta, tlen = ksw.pad_tiles(qs, ts)
    Bp = max(128, 1 << (n - 1).bit_length())
    assert qa.shape == (Bp, max(64, -(-lq // 64) * 64))
    assert ta.shape == (Bp, max(64, -(-lt // 64) * 64))
    assert qa.dtype == ta.dtype == np.uint8
    assert qlen.dtype == tlen.dtype == np.int32 and len(tlen) == Bp
    for i in range(n):
        assert qlen[i] == len(qs[i]) and tlen[i] == len(ts[i])
        assert np.array_equal(qa[i, :qlen[i]], qs[i])
        assert np.array_equal(ta[i, :tlen[i]], ts[i])
        assert not qa[i, qlen[i]:].any() and not ta[i, tlen[i]:].any()
    assert not (qa[n:].any() or ta[n:].any() or qlen[n:].any()
                or tlen[n:].any())


def test_unpack_ops_inverts_the_packing():
    """K2b's packing (the JAX ``traceback_ops_device(pack=True)``: ops & 3,
    four to a byte, first in the low bits) undone, 255 past the end."""
    ops, _, _ = _random_ops(np.random.default_rng(6))
    p = (ops & 3).reshape(len(ops), -1, 4).astype(np.uint8)
    packed = p[:, :, 0] | (p[:, :, 1] << 2) | (p[:, :, 2] << 4) | (
        p[:, :, 3] << 6)
    assert np.array_equal(sw_global.unpack_ops(packed, ops.shape[1]), ops)


@pytest.mark.parametrize("flags", [
    {},
    {"LARIAT_NO_NATIVE_KSW": "1", "LARIAT_NO_NATIVE_ALIGN1": "1"}],
    ids=["sessions", "python"])
def test_cli_paths_match_jax_cli(tmp_path, flags):
    """The port's CLI on the CPU (-use_device on, every pair primed) with
    each path's flags writes the records of lariat_tpu.cli with the same
    flags."""
    fasta, fq = _inputs(tmp_path)
    logs = {}
    for name, mod, extra in (
            ("jax", "lariat_tpu.cli", {}),
            ("port", "lariat_tpu_torch.cli", {"LARIAT_TORCH_DEVICE": "cpu"})):
        r = subprocess.run(
            [sys.executable, "-m", mod, "-reads", str(fq), "-genome",
             str(fasta), "-output", str(tmp_path / name), "-threads", "2",
             "-use_device", "on", "-first_chunk"],
            capture_output=True, text=True, cwd=REPO,
            env=_env(**extra, **flags), timeout=600)
        assert r.returncode == 0, r.stderr[-2000:]
        logs[name] = r.stdout
    assert "primed pairs 35  host pairs 0" in logs["port"], logs["port"]
    assert re.search(r"^index load: [0-9.]+s$", logs["port"], re.M)
    path = json.loads(re.search(r"^device path: (\{.*\})$", logs["port"],
                                re.M).group(1))
    # the CPU's auto policy seeds on the host; every pair's batch seeded
    assert path["seed_host_batches"] > 0 and not path["seed_device_batches"]
    assert path["host_batches_before_device"] is None
    assert path["rescue_tasks"] >= 0
    # the CLI's batches: every pair primed, in batches of 35 pairs at most
    assert 0 < path["largest_batch_pairs"] <= 35
    assert path["largest_launches"] == dict.fromkeys(_build.KERNELS, 0)
    assert path["cuda_peak_bytes"] is None
    bams = sorted(os.path.basename(p)
                  for p in glob.glob(str(tmp_path / "jax" / "*.bam")))
    assert bams and bams == sorted(
        os.path.basename(p)
        for p in glob.glob(str(tmp_path / "port" / "*.bam")))
    for k in bams:
        assert list(BamFile(str(tmp_path / "jax" / k))) == \
            list(BamFile(str(tmp_path / "port" / k))), k


def test_path_log_keeps_the_largest_batch_and_launch(dup_genome):  # noqa: F811
    """``path_log``'s largest batch is the largest finished priming pass
    (an aborted one does not count; regions alone or with rescue and
    reg2aln); its largest launches are ``_build``'s, kept a kernel at a
    time, in the kernel's own unit, and cleared with the counts; it names
    the engine's device and the cards the process holds a context on."""
    from lariat_tpu_torch.align.batch_engine import PrimeAborted
    from test_torch_engine import _recs
    fm, genome = dup_genome
    recs = _recs(genome)
    eng = TorchBatchAlignmentEngine(fm, device="cpu")
    log = eng.path_log()
    assert log["largest_batch_pairs"] == 0 and log["cuda_peak_bytes"] is None
    assert log["device"] == "cpu"
    assert set(log["cuda_contexts"]) <= set(range(torch.cuda.device_count()))
    eng.prime_regions(recs[:3], 17)
    eng.prime_regions(recs[:5])
    eng.prime_regions(recs[:2], 17)
    assert eng.path_log()["largest_batch_pairs"] == 5
    eng.abort_prime = True
    with pytest.raises(PrimeAborted):
        eng.prime_regions(recs[:9], 17)
    assert eng.path_log()["largest_batch_pairs"] == 5
    _build.reset_launches()
    for name, entry, size in (("sw_extend", "lariat_sw_extend_desc", 900),
                              ("sw_extend", "lariat_sw_extend", 4000),
                              ("sw_extend", "lariat_sw_extend_desc", 30),
                              ("sa_walk", "lariat_sa_walk", 65536)):
        _build._count(name, entry, size)
    want = dict.fromkeys(_build.KERNELS, 0) | {"sw_extend": 4000,
                                               "sa_walk": 65536}
    assert eng.path_log()["largest_launches"] == _build.largest() == want
    assert _build.launches()["sw_extend"] == 3
    assert _build.entry_launches()["lariat_sw_extend_desc"] == 2
    _build.reset_launches()
    assert _build.largest() == dict.fromkeys(_build.KERNELS, 0)


# ---- the background index upload ------------------------------------------


def _gated_upload(monkeypatch, error=None):
    """DeviceFMIndex.from_host held until the returned event is set; then
    the upload, or ``error`` raised."""
    gate = threading.Event()
    orig = fm_batch.DeviceFMIndex.from_host

    def gated(fm, device):
        gate.wait(120)
        if error is not None:
            raise error
        return orig(fm, device)

    monkeypatch.setattr(fm_batch.DeviceFMIndex, "from_host", gated)
    return gate


def _count_device_collects(monkeypatch):
    n = []
    orig = smem_device.collect_seeds_rbegs_device
    monkeypatch.setattr(smem_device, "collect_seeds_rbegs_device",
                        lambda *a: n.append(1) or orig(*a))
    return n


def _auto_engine(fm, monkeypatch):
    """An engine in auto mode with device seeding due (auto needs CUDA, so
    its policy is forced true on the CPU)."""
    monkeypatch.delenv("LARIAT_DEVICE_SEED", raising=False)
    eng = TorchBatchAlignmentEngine(fm, device="cpu")
    monkeypatch.setattr(eng, "device_seeding", lambda: True)
    return eng


def test_auto_seeding_uploads_in_the_background(dup_genome, seqs,  # noqa: F811
                                                monkeypatch):
    fm, _ = dup_genome
    batch = seqs[:40]
    monkeypatch.delenv("LARIAT_DEVICE_SEED", raising=False)
    want = _rows(TorchBatchAlignmentEngine(fm, device="cpu")
                 .align_batch(batch))
    gate = _gated_upload(monkeypatch)
    n_dev = _count_device_collects(monkeypatch)
    eng = _auto_engine(fm, monkeypatch)
    for _ in range(2):            # host-seeded while the upload is held
        assert _rows(eng.align_batch(batch)) == want
    assert not n_dev and eng._seed_state is None
    assert eng._seed_thread.is_alive() and eng.seed_upload_s is None
    gate.set()
    eng._seed_thread.join(60)
    assert eng.seed_upload_s > 0 and eng._seed_state is not None
    assert _rows(eng.align_batch(batch)) == want
    assert len(n_dev) == 1
    assert eng._seed_state[1].pac_words is eng._pac_resident()[0]
    log = eng.path_log()
    assert (log["seed_host_batches"], log["seed_device_batches"],
            log["host_batches_before_device"]) == (2, 1, 2)
    assert log["seed_upload_s"] == eng.seed_upload_s


def test_forced_seeding_waits_for_the_upload(dup_genome, seqs,  # noqa: F811
                                             monkeypatch):
    fm, _ = dup_genome
    batch = seqs[:40]
    monkeypatch.setenv("LARIAT_DEVICE_SEED", "0")
    want = _rows(TorchBatchAlignmentEngine(fm, device="cpu")
                 .align_batch(batch))
    gate = _gated_upload(monkeypatch)
    n_dev = _count_device_collects(monkeypatch)
    monkeypatch.setenv("LARIAT_DEVICE_SEED", "1")
    eng = TorchBatchAlignmentEngine(fm, device="cpu")
    got = []
    th = threading.Thread(target=lambda: got.append(eng.align_batch(batch)))
    th.start()
    th.join(1.0)
    assert th.is_alive() and not got and eng._seed_thread.is_alive()
    gate.set()
    th.join(120)
    assert _rows(got[0]) == want and len(n_dev) == 1


def test_upload_error_raises_and_stays_raised(dup_genome, seqs,  # noqa: F811
                                              monkeypatch):
    fm, _ = dup_genome
    batch = seqs[:20]
    gate = _gated_upload(monkeypatch, RuntimeError("index upload failed"))
    eng = _auto_engine(fm, monkeypatch)
    assert eng.align_batch(batch)           # host-seeded: still uploading
    gate.set()
    eng._seed_thread.join(60)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="upload failed"):
            eng.align_batch(batch)
    assert eng._seed_state is None


# ---- the new paths on the card --------------------------------------------


@pytest.mark.cuda
def test_replay_paths_on_the_card(dup_genome, seqs,  # noqa: F811
                                  cuda_device):  # noqa: F811
    """The Python replays launch K1 through its tile entry only, and K2
    and K2b; each equals the CPU engine."""
    fm, _ = dup_genome
    tasks = _tasks(fm, seqs[:100])
    cpu = TorchBatchAlignmentEngine(fm, device="cpu")
    want_regs = _rows(cpu.align_batch(seqs))
    want_sras = _sras(cpu.reg2aln_batch(tasks))
    eng = TorchBatchAlignmentEngine(fm, device=cuda_device)
    _build.reset_launches()
    regs = eng._align_batch_python(seqs)
    sras = eng._reg2aln_python(tasks)
    assert _rows(regs) == want_regs and _sras(sras) == want_sras
    n, e = _build.launches(), _build.entry_launches()
    assert n["sw_extend"] > 0 and e["lariat_sw_extend_desc"] == 0
    assert e["lariat_sw_extend_step"] == 0
    assert n["sw_global"] > 0 and n["traceback"] > 0


@pytest.mark.cuda
def test_background_upload_on_the_card(dup_genome, seqs, cuda_device,  # noqa: F811
                                       monkeypatch):
    """Auto mode on the card (the genome-size gate at 0): host-seeded
    batches, then device-seeded ones, regions equal throughout."""
    fm, _ = dup_genome
    monkeypatch.delenv("LARIAT_DEVICE_SEED", raising=False)
    want = _rows(TorchBatchAlignmentEngine(fm, device=cuda_device)
                 .align_batch(seqs))
    eng = TorchBatchAlignmentEngine(fm, device=cuda_device)
    eng.DEVICE_SEED_AUTO_MIN_LPAC = 0
    seeded = []
    for _ in range(200):
        before = _build.launches()["smem_twoptr"]
        assert _rows(eng.align_batch(seqs)) == want
        seeded.append(_build.launches()["smem_twoptr"] > before)
        if seeded[-1]:
            break
    assert not seeded[0] and seeded[-1]
    assert seeded == sorted(seeded)
