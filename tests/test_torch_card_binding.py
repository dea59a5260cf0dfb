"""Card binding: a process whose engine is on card h touches no other card.

On a host with two or more cards (``-m cuda``): an engine on the last card
primes a batch from a ``ThreadPoolExecutor`` thread (as the CLI's router
does), runs auto seeding's background upload and primes a device-seeded
batch the same way, times a step part with ``StepClock``, and a resident
server started on that card serves one request; afterwards the process
holds no CUDA context and no allocation on card 0, and neither does the
server. The checks run in a fresh process, since other tests of a session
put contexts on card 0.

On the CPU: the environment ``chip_smoke.py``'s four-card phase gives
process h (card h, socket h, no inherited ``LARIAT_*`` knob), the card
index check of ``device.get_device`` and ``device.contexts`` against a
stand-in driver.
"""

import ctypes
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import chip_smoke
from lariat_tpu_torch import device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture
def cuda_device():
    """The card, or a skip: a CUDA kernel has no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _plain(obj):
    if dataclasses.is_dataclass(obj):
        return dataclasses.astuple(obj)
    if isinstance(obj, (list, tuple)):
        return tuple(_plain(o) for o in obj)
    return obj


def _inputs(tmp, n_pairs=256, seed=5):
    """A 200 kb genome written as FASTA and ``n_pairs`` read pairs of 151
    bases drawn from it (an insert of 400)."""
    from lariat_tpu_torch.io.fastq import FastQRecord
    rng = np.random.default_rng(seed)
    lut = np.frombuffer(b"ACGT", np.uint8)
    genome = lut[rng.integers(0, 4, 200_000)].tobytes()
    fasta = os.path.join(tmp, "g.fa")
    with open(fasta, "w") as f:
        f.write(">chr1\n")
        for i in range(0, len(genome), 70):
            f.write(genome[i:i + 70].decode() + "\n")
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    recs = []
    for _ in range(n_pairs):
        pos = int(rng.integers(0, len(genome) - 400))
        r2 = genome[pos + 249:pos + 400].translate(comp)[::-1]
        recs.append(FastQRecord(read1=genome[pos:pos + 151],
                                read_qual1=b"I" * 151, read2=r2,
                                read_qual2=b"I" * 151,
                                barcode10x=b"ACGTACGTACGTAC-1"))
    return fasta, recs


def _bind_run(tmp: str, card: int) -> None:
    """The card binding run (its own process): prints one JSON line."""
    from concurrent.futures import ThreadPoolExecutor

    from lariat_tpu_torch import cli
    from lariat_tpu_torch.align.batch_engine import TorchBatchAlignmentEngine
    from lariat_tpu_torch.config import RFAConfig
    from lariat_tpu_torch.parallel import device_server
    from lariat_tpu_torch.parallel.align_step import StepClock

    delta = RFAConfig().chain_score_delta
    fasta, recs = _inputs(tmp)
    dev = torch.device("cuda", card)
    eng = TorchBatchAlignmentEngine(cli.load_reference(fasta), device=dev)
    # auto seeding on this small genome: the first batch starts the upload
    # and seeds on the host, the next seeds on the card
    eng.DEVICE_SEED_AUTO_MIN_LPAC = 0
    with ThreadPoolExecutor(1, thread_name_prefix="lariat-prime") as ex:
        host_seeded = ex.submit(eng.prime_regions, recs, delta).result()
        eng._seed_thread.join(600)
        card_seeded = ex.submit(eng.prime_regions, recs, delta).result()
    clock = StepClock(dev)
    with clock.part("sum"):
        torch.ones(1 << 20, device=dev).sum()
    clock.ms()
    sock = os.path.join(tmp, "srv.sock")
    ready = os.path.join(tmp, "srv.ready")
    env = {k: v for k, v in os.environ.items() if not k.startswith("LARIAT_")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "lariat_tpu_torch.parallel.device_server",
         "-genome", fasta, "-socket", sock, "-ready_file", ready],
        cwd=REPO, env={**env, "LARIAT_TORCH_DEVICE": f"cuda:{card}",
                       "LARIAT_DEVICE_SEED": "1", "LARIAT_PRIME_BATCH": "64"},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        t0 = time.time()
        while not os.path.exists(ready):
            if proc.poll() is not None or time.time() - t0 > 600:
                raise RuntimeError("the server never became ready")
            time.sleep(0.2)
        client = device_server.DeviceServerClient.connect(fasta, path=sock)
        served = client.prime_regions(recs, delta)
        client.close()
        device_server.stop_server(sock)
        out = proc.communicate(timeout=120)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    srv = json.loads(re.search(r"\[device_server\] device path: (\{.*\})",
                               out).group(1))
    torch.cuda.synchronize(dev)
    contexts = device.contexts()        # before anything reads card 0
    print(json.dumps({
        "contexts": contexts, "allocated_0": torch.cuda.memory_allocated(0),
        "allocated_card": torch.cuda.memory_allocated(card),
        "seed_batches": eng.seed_batches, "path": eng.path_log(),
        "server_path": srv, "server_rc": proc.returncode,
        "server_device": client.device_name,
        "same": [_plain(host_seeded) == _plain(card_seeded),
                 _plain(served) == _plain(host_seeded)]}))


@pytest.mark.cuda
def test_engine_on_the_last_card_leaves_card_0_alone(cuda_device, tmp_path):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two or more CUDA devices, found {n}")
    card = n - 1
    env = {k: v for k, v in os.environ.items() if not k.startswith("LARIAT_")}
    r = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path[:0] = [{REPO!r}, {TESTS!r}]; "
         f"import test_torch_card_binding as t; "
         f"t._bind_run({str(tmp_path)!r}, {card})"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=1500)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    got = json.loads(r.stdout.splitlines()[-1])
    assert got["contexts"] == [card], got
    assert got["allocated_0"] == 0 and got["allocated_card"] > 0, got
    assert got["seed_batches"] == {"host": 1, "device": 1,
                                   "host_before_device": 1}, got
    assert got["path"]["device"] == f"cuda:{card}"
    assert got["path"]["cuda_contexts"] == [card]
    assert got["path"]["cuda_peak_bytes"] > 0
    assert got["server_rc"] == 0
    assert got["server_device"].startswith(f"cuda:{card} ")
    assert got["server_path"]["device"] == f"cuda:{card}"
    assert got["server_path"]["cuda_contexts"] == [card]
    assert got["same"] == [True, True]


def test_four_card_phase_gives_each_process_its_card_and_socket():
    """chip_smoke's phase 22: process h gets card h and, through a server,
    socket h; no LARIAT_* knob of the caller's environment reaches it."""
    base = {"PATH": "/usr/bin", "HOME": "/h", "LARIAT_PRIME_MIN_FRAC": "0",
            "LARIAT_DEVICE_SEED": "1", "LARIAT_TORCH_DEVICE": "cuda:0",
            "LARIAT_DEVICE_SOCKET": "/tmp/other.sock",
            "LARIAT_PRIME_BATCH": "8"}
    for h in range(4):
        sock = f"/run/srv_{h}.sock"
        assert chip_smoke._card_env(base, h) == {
            "PATH": "/usr/bin", "HOME": "/h",
            "LARIAT_TORCH_DEVICE": f"cuda:{h}"}
        assert chip_smoke._card_env(base, h, sock) == {
            "PATH": "/usr/bin", "HOME": "/h",
            "LARIAT_TORCH_DEVICE": f"cuda:{h}",
            "LARIAT_DEVICE_SOCKET": sock}
    assert base["LARIAT_TORCH_DEVICE"] == "cuda:0"     # left as it was


def test_get_device_refuses_a_card_the_host_lacks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert device.get_device("cuda:1") == torch.device("cuda", 1)
    monkeypatch.setenv(device.ENV_VAR, "cuda:3")
    with pytest.raises(RuntimeError, match="has 2 CUDA device"):
        device.get_device()


class _Fn:
    """A stand-in driver function: callable, and takes ``argtypes`` and
    ``restype`` as ctypes' functions do."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)


def _driver(active):
    """A stand-in CUDA driver with four cards, primary contexts active on
    the cards in ``active``; pointers come as ``byref`` objects."""
    def count(n):
        n._obj.value = 4
        return 0

    def get(dev, i):
        dev._obj.value = 10 + i
        return 0

    def state(dev, flags, on):
        on._obj.value = int(dev.value - 10 in active)
        return 0

    drv = type("Driver", (), {})()
    drv.cuInit = _Fn(lambda flags: 0)
    drv.cuDeviceGetCount = _Fn(count)
    drv.cuDeviceGet = _Fn(get)
    drv.cuDevicePrimaryCtxGetState = _Fn(state)
    return drv


@pytest.mark.parametrize("active", [[], [2], [0, 3]])
def test_contexts_lists_the_cards_with_an_active_context(monkeypatch,
                                                         active):
    def cdll(name):
        assert name == "libcuda.so.1"
        return _driver(active)

    monkeypatch.setattr(ctypes, "CDLL", cdll)
    assert device.contexts() == active


def test_contexts_without_a_driver(monkeypatch):
    def cdll(name):
        raise OSError(f"{name}: cannot open shared object file")

    monkeypatch.setattr(ctypes, "CDLL", cdll)
    assert device.contexts() == []


def test_four_card_group_kills_the_rest_on_a_failure(tmp_path):
    """chip_smoke's phase 22 runs a mode's processes as a group: the first
    nonzero exit kills the others at once (none is left waiting at the
    rendezvous), and each gets its exit code or None, its log and its
    peak RSS line."""
    logs = [str(tmp_path / f"p{h}.log") for h in range(4)]
    # the failing process exits once every other has printed its line (at
    # most 30 s), so a loaded host cannot kill one before it is up
    fail = ("import os, sys, time\n"
            f"logs = {logs!r}\n"
            "def up(p):\n"
            "    return os.path.exists(p) and open(p).read().startswith('up')\n"
            "t = time.time()\n"
            "while time.time() - t < 30 and not all(map(up, logs)):\n"
            "    time.sleep(0.05)\n"
            "sys.exit(3)\n")
    procs = [{"label": f"cli {h}", "env": dict(os.environ), "log": logs[h],
              "cmd": [sys.executable, "-c",
                      "import sys, time; print('up', flush=True)\n"
                      + (fail if h == 2 else "time.sleep(120)")]}
             for h in range(4)]
    roots = {}
    t0 = time.time()
    chip_smoke._group(procs, 300, roots)
    assert time.time() - t0 < 60
    assert [x["rc"] for x in procs] == [None, None, 3, None]
    assert sorted(roots.values()) == [f"cli {h}" for h in range(4)]
    assert all(x["out"].startswith("up") for x in procs)
    assert procs[2]["rss_gib"] > 0
    assert all(x["proc"].poll() is not None for x in procs)


def test_four_card_binding_rules():
    """Phase 22's reading of nvidia-smi's apps: each card carries exactly
    its process of the run, none holds contexts on two cards, and a run
    nvidia-smi never listed is said so, not failed."""
    def apps(seen):
        a = chip_smoke._Apps.__new__(chip_smoke._Apps)
        a.roots = {10 + h: f"server {h}" for h in range(4)}
        a.roots.update({20 + h: f"cli {h}" for h in range(4)})
        a.seen, a.samples, a.errors = seen, 5, []
        return a

    want = {h: f"server {h}" for h in range(4)}
    good = {(f"server {h}", h): 600 for h in range(4)}
    good[("pid 99", 0)] = 500             # not a process of this run
    assert apps(good).binding(want) == ([], None)
    problems, _ = apps({**good, ("cli 1", 1): 500}).binding(want)
    assert problems == ["card 1 carried ['cli 1', 'server 1'], want "
                        "[server 1]", "cli 1 held contexts on cards ['1']"]
    problems, _ = apps({**good, ("server 3", 0): 500}).binding(want)
    assert problems == ["card 0 carried ['server 0', 'server 3'], want "
                        "[server 0]", "server 3 held contexts on cards "
                        "['0', '3']"]
    problems, note = apps({("pid 99", 0): 500}).binding(want)
    assert problems == [] and "listed no app of this run" in note
    assert chip_smoke._bus("00000000:1B:00.0") == chip_smoke._bus(
        "0000:1b:00.0") == "1b:00.0"
