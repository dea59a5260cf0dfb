"""Auto seeding on the CLI's path, in the CLI's own process, on the
explicit CPU device (the kernels' plain twins): the port's CLI with
``LARIAT_DEVICE_SEED`` unset and auto mode let in (its genome gate at 0,
the CPU among its device types), the index upload held back until the
first batch has started seeding. The first batch host-seeds while the
upload runs, later ones seed on the device, and the records equal the JAX
package's CLI's. No JAX runs in this process: the CLI forks its workers
here."""

import glob
import json
import os
import re
import subprocess
import sys
import threading

import torch

from lariat_tpu.io.bamread import BamFile
from lariat_tpu_torch import cli
from lariat_tpu_torch.align.batch_engine import TorchBatchAlignmentEngine
from lariat_tpu_torch.ops import fm_batch, smem_device

from test_torch_cli import REPO, _env, _inputs

torch.set_num_threads(1)


def test_cli_auto_seeding_serves_both_seeders(tmp_path, monkeypatch,
                                              capsys):
    """Three batches, all primed: the first starts the upload and
    host-seeds, then lets the upload go; the other two wait for it to land
    and seed on the device. path_log says both seeders served batches, two
    device collects ran, and every BAM holds lariat_tpu.cli's records
    (exact)."""
    fasta, fq = _inputs(tmp_path)
    r = subprocess.run(
        [sys.executable, "-m", "lariat_tpu.cli", "-reads", str(fq),
         "-genome", str(fasta), "-output", str(tmp_path / "jax"),
         "-threads", "2", "-use_device", "off", "-first_chunk"],
        capture_output=True, text=True, cwd=REPO, env=_env(), timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    for k, v in _env(LARIAT_TORCH_DEVICE="cpu", LARIAT_PRIME_THREADS="8",
                     LARIAT_PRIME_MIN_FRAC="0").items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("LARIAT_DEVICE_SEED", raising=False)
    monkeypatch.setattr(TorchBatchAlignmentEngine,
                        "DEVICE_SEED_AUTO_MIN_LPAC", 0)
    monkeypatch.setattr(TorchBatchAlignmentEngine, "DEVICE_SEED_AUTO_TYPES",
                        ("cuda", "cpu"))
    # two barcodes (14 pairs) a batch: 14, 14, then the remainder of 7
    monkeypatch.setattr(cli, "_batch_target", lambda rate, fixed=None: 14)
    gate, landed = threading.Event(), threading.Event()
    from_host = fm_batch.DeviceFMIndex.from_host
    upload = TorchBatchAlignmentEngine._upload_seed_index
    seed = TorchBatchAlignmentEngine._device_seed
    collect = smem_device.collect_seeds_rbegs_device
    lock, started, n_dev = threading.Lock(), [], []

    def held_from_host(fm, device):
        assert gate.wait(120)
        return from_host(fm, device)

    def upload_then_tell(self):
        upload(self)
        landed.set()

    def device_seed(self, nonempty):
        with lock:
            first = not started
            started.append(1)
        if first:       # starts the upload, host-seeds, lets the upload go
            out = seed(self, nonempty)
            gate.set()
            return out
        assert landed.wait(120)
        return seed(self, nonempty)

    monkeypatch.setattr(fm_batch.DeviceFMIndex, "from_host", held_from_host)
    monkeypatch.setattr(TorchBatchAlignmentEngine, "_upload_seed_index",
                        upload_then_tell)
    monkeypatch.setattr(TorchBatchAlignmentEngine, "_device_seed",
                        device_seed)
    monkeypatch.setattr(smem_device, "collect_seeds_rbegs_device",
                        lambda *a: n_dev.append(1) or collect(*a))
    assert cli.main(["-reads", str(fq), "-genome", str(fasta), "-output",
                     str(tmp_path / "port"), "-threads", "2", "-use_device",
                     "auto", "-first_chunk"]) == 0
    out = capsys.readouterr().out
    assert "primed pairs 35  host pairs 0" in out, out
    path = json.loads(re.search(r"^device path: (\{.*\})$", out,
                                re.M).group(1))
    assert (path["seed_host_batches"], path["seed_device_batches"],
            path["host_batches_before_device"]) == (1, 2, 1)
    assert path["seed_upload_s"] > 0 and len(n_dev) == 2
    bams = sorted(os.path.basename(p)
                  for p in glob.glob(str(tmp_path / "jax" / "*.bam")))
    assert bams and bams == sorted(
        os.path.basename(p)
        for p in glob.glob(str(tmp_path / "port" / "*.bam")))
    for k in bams:
        assert list(BamFile(str(tmp_path / "jax" / k))) == \
            list(BamFile(str(tmp_path / "port" / k))), k
