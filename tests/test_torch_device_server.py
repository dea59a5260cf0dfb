"""The port's resident priming server (lariat_tpu_torch/parallel/
device_server.py) as a subprocess on the explicit CPU device
(LARIAT_TORCH_DEVICE=cpu; the CLI takes a CPU server only with
LARIAT_DEVICE_SERVER_CPU_OK=1): ``prime`` equals the local engine's (exact,
dataclasses by ``astuple``), the CLI through it writes BAM records equal to
host-native's and to the JAX package's CLI through its own server, an abort
relayed to it stops a prime in flight, a killed server makes the client
raise and the CLI fail, and its socket is named apart from the JAX
server's."""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from lariat_tpu.io.bamread import BamFile
from lariat_tpu_torch import cli
from lariat_tpu_torch.align.batch_engine import (PrimeAborted,
                                                 TorchBatchAlignmentEngine)
from lariat_tpu_torch.config import RFAConfig
from lariat_tpu_torch.io.fastq import FastQReader, FastQRecord
from lariat_tpu_torch.parallel import device_server

from test_torch_cli import _env, _inputs
from test_torch_engine_surface import _plain

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DELTA = RFAConfig().chain_score_delta


def _start(module, fasta, tmp_path, tag, **extra):
    """A server subprocess on a socket of its own; returns (process,
    socket path) once its ready file exists."""
    sock = str(tmp_path / f"{tag}.sock")
    ready = tmp_path / f"{tag}.ready"
    proc = subprocess.Popen(
        [sys.executable, "-m", module, "-genome", str(fasta), "-socket",
         sock, "-ready_file", str(ready)],
        cwd=REPO, env=_env(LARIAT_PRIME_BATCH="8", **extra),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for _ in range(1200):
        if ready.exists():
            return proc, sock
        if proc.poll() is not None:
            raise RuntimeError(proc.stdout.read()[-2000:])
        time.sleep(0.1)
    proc.kill()
    raise RuntimeError("server never became ready")


def _port_server(fasta, tmp_path, tag="port", device="cpu"):
    return _start("lariat_tpu_torch.parallel.device_server", fasta, tmp_path,
                  tag, LARIAT_TORCH_DEVICE=device)


@pytest.fixture
def last_card():
    """The host's last card (``cuda:N-1``), or a skip: a server on a card
    needs one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return f"cuda:{torch.cuda.device_count() - 1}"


def _stop(proc, sock):
    device_server.stop_server(sock)
    out = proc.communicate(timeout=120)[0]
    assert proc.returncode == 0, out[-2000:]
    return out


def _first_barcode(fq):
    reads, _ = FastQReader(str(fq)).read_barcode_set(0)
    return reads


def test_server_prime_matches_local_engine(tmp_path):
    fasta, fq = _inputs(tmp_path)
    reads = _first_barcode(fq)
    local = TorchBatchAlignmentEngine(cli.load_reference(str(fasta)),
                                      device="cpu")
    proc, sock = _port_server(fasta, tmp_path)
    try:
        client = device_server.DeviceServerClient.connect(str(fasta),
                                                          path=sock)
        assert client is not None
        assert (client.device_type, client.device_name) == ("cpu", "cpu")
        for delta in (DELTA, None):
            got = client.prime_regions(reads, delta)
            assert _plain(got) == _plain(local.prime_regions(reads, delta))
        assert client.wave_stats["n"] > 0
        client.close()
    finally:
        out = _stop(proc, sock)
    assert "[device_server] prewarm" in out
    assert "[device_server] kernel launches: {" in out


def _run_cli(module, fq, fasta, out, **extra):
    r = subprocess.run(
        [sys.executable, "-m", module, "-reads", str(fq), "-genome",
         str(fasta), "-output", str(out), "-threads", "2", "-use_device",
         "on" if "LARIAT_DEVICE_SOCKET" in extra else "off", "-first_chunk"],
        capture_output=True, text=True, cwd=REPO, env=_env(**extra),
        timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


def _records(out):
    return {os.path.basename(p): list(BamFile(p))
            for p in sorted(str(f) for f in out.glob("*.bam"))}


def test_cli_via_server_matches_host_and_jax_server(tmp_path):
    fasta, fq = _inputs(tmp_path)
    _run_cli("lariat_tpu.cli", fq, fasta, tmp_path / "host")
    proc, sock = _port_server(fasta, tmp_path)
    try:
        log = _run_cli("lariat_tpu_torch.cli", fq, fasta, tmp_path / "port",
                       LARIAT_DEVICE_SOCKET=sock,
                       LARIAT_DEVICE_SERVER_CPU_OK="1",
                       LARIAT_PRIME_BATCH="8")
    finally:
        srv_log = _stop(proc, sock)
    assert f"device priming via server ({sock}, device cpu)" in log
    assert "cuda initialized in the CLI process: False" in log
    primed = int(log.split("primed pairs ")[1].split()[0])
    host = int(log.split("host pairs ")[1].split()[0])
    assert primed > 0 and primed + host == 35
    assert "[device_server] device waves" in srv_log
    jproc, jsock = _start("lariat_tpu.parallel.device_server", fasta,
                          tmp_path, "jax", LARIAT_SERVER_NO_PREWARM="1")
    try:
        jlog = _run_cli("lariat_tpu.cli", fq, fasta, tmp_path / "jax",
                        LARIAT_DEVICE_SOCKET=jsock,
                        LARIAT_DEVICE_SERVER_CPU_OK="1",
                        LARIAT_PRIME_BATCH="8")
    finally:
        jproc.kill()
        jproc.wait()
    assert "device priming via server" in jlog
    want = _records(tmp_path / "host")
    assert want and _records(tmp_path / "port") == want
    assert _records(tmp_path / "jax") == want


def test_device_seeding_server_matches_host_and_jax_server(tmp_path):
    """Servers whose environment has LARIAT_DEVICE_SEED=1 (the port's seeds
    through the kernels' twins): every batch the port's server primed
    seeded on the device, and the port's CLI through it writes the records
    of lariat_tpu.cli's host run and of the JAX CLI through the JAX server
    under the same setting."""
    import json
    import re
    fasta, fq = _inputs(tmp_path)
    _run_cli("lariat_tpu.cli", fq, fasta, tmp_path / "host")
    proc, sock = _start("lariat_tpu_torch.parallel.device_server", fasta,
                        tmp_path, "port", LARIAT_TORCH_DEVICE="cpu",
                        LARIAT_DEVICE_SEED="1")
    try:
        # the all-primed knobs: a thread for each of the five batches, no
        # dormancy (the twins seed slowly on the CPU)
        log = _run_cli("lariat_tpu_torch.cli", fq, fasta, tmp_path / "port",
                       LARIAT_DEVICE_SOCKET=sock,
                       LARIAT_DEVICE_SERVER_CPU_OK="1",
                       LARIAT_PRIME_BATCH="8", LARIAT_PRIME_THREADS="5",
                       LARIAT_PRIME_MIN_FRAC="0")
    finally:
        srv_log = _stop(proc, sock)
    assert "primed pairs 35  host pairs 0" in log, log
    assert re.search(r"\[device_server\] set-up: imports [0-9.]+s, load "
                     r"[0-9.]+s \(index, kernels\), upload [0-9.]+s \(pac, "
                     r"seeding index\)", srv_log)
    path = json.loads(re.search(r"\[device_server\] device path: (\{.*\})",
                                srv_log).group(1))
    # the clients' batches only (the prewarm's are not counted): all five
    # seeded on the device
    assert (path["seed_host_batches"], path["seed_device_batches"]) == (0, 5)
    jproc, jsock = _start("lariat_tpu.parallel.device_server", fasta,
                          tmp_path, "jax", LARIAT_SERVER_NO_PREWARM="1",
                          LARIAT_DEVICE_SEED="1")
    try:
        _run_cli("lariat_tpu.cli", fq, fasta, tmp_path / "jax",
                 LARIAT_DEVICE_SOCKET=jsock, LARIAT_DEVICE_SERVER_CPU_OK="1",
                 LARIAT_PRIME_BATCH="8")
    finally:
        jproc.kill()
        jproc.wait()
    want = _records(tmp_path / "host")
    assert want and _records(tmp_path / "port") == want
    assert _records(tmp_path / "jax") == want


def _pairs(fasta, n, seed=3):
    """n read pairs from the genome, 151 bases a mate."""
    fm = cli.load_reference(str(fasta))
    rng = np.random.default_rng(seed)
    lut = np.frombuffer(b"ACGT", np.uint8)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    out = []
    for _ in range(n):
        pos = int(rng.integers(0, fm.l_pac - 402))
        seg = np.asarray(fm.get_seq_codes(pos, pos + 400)).copy()
        r1 = lut[seg[:151]].tobytes()
        r2 = lut[seg[249:]].tobytes().translate(comp)[::-1]
        out.append(FastQRecord(read1=r1, read_qual1=b"I" * 151, read2=r2,
                               read_qual2=b"I" * 151,
                               barcode10x=b"ACGTACGTACGTAC-1"))
    return out


def _abort_relay(tmp_path, device, n_pairs):
    """The router's abort, relayed to a server on ``device`` priming
    ``n_pairs`` pairs, makes its prime in flight raise PrimeAborted at a
    wave boundary; the server then primes the next request in full."""
    fasta, _ = _inputs(tmp_path)
    recs = _pairs(fasta, n_pairs)
    proc, sock = _start("lariat_tpu_torch.parallel.device_server", fasta,
                        tmp_path, "abort", LARIAT_TORCH_DEVICE=device,
                        LARIAT_SERVER_NO_PREWARM="1")
    try:
        client = device_server.DeviceServerClient.connect(str(fasta),
                                                          path=sock)
        box = {}

        def prime():
            try:
                box["out"] = client.prime_regions(recs, DELTA)
            except Exception as e:  # noqa: BLE001
                box["err"] = e

        th = threading.Thread(target=prime)
        th.start()
        time.sleep(1.0)          # the prime runs for several seconds
        client.abort_prime = True
        th.join(120)
        assert isinstance(box.get("err"), PrimeAborted), box
        assert len(client.prime_regions(recs[:4], DELTA)) == 4
        client.close()
    finally:
        _stop(proc, sock)


def test_abort_relay_stops_a_prime_in_flight(tmp_path):
    # 600 pairs prime in about 7 s on one CPU core
    _abort_relay(tmp_path, "cpu", 600)


@pytest.mark.cuda
def test_abort_relay_stops_a_prime_in_flight_on_a_card(tmp_path, last_card):
    # the card primes about 60 times faster than one CPU core
    _abort_relay(tmp_path, last_card, 40_000)


def test_abort_is_cleared_before_the_aborted_prime_replies(tmp_path,
                                                           monkeypatch):
    """The server answers an aborted prime only once the abort is
    cleared, so a client's next prime, sent on that answer over another
    connection, runs in full. The server runs in this process, its error
    replies held 0.5 s after they are sent: a clearing made after the
    reply would still be pending when the next prime arrives."""
    fasta, _ = _inputs(tmp_path)
    recs = _pairs(fasta, 600)
    sock, ready = str(tmp_path / "s.sock"), tmp_path / "s.ready"
    send = device_server._send

    def slow_err(conn, obj):
        send(conn, obj)
        if obj[0] == "err":
            time.sleep(0.5)

    monkeypatch.setattr(device_server, "_send", slow_err)
    monkeypatch.setenv("LARIAT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("LARIAT_SERVER_NO_PREWARM", "1")
    monkeypatch.delenv("LARIAT_DEVICE_SEED", raising=False)
    srv = threading.Thread(target=device_server.serve,
                           args=(str(fasta), sock, 300.0, str(ready)),
                           daemon=True)
    srv.start()
    try:
        for _ in range(1200):
            if ready.exists() or not srv.is_alive():
                break
            time.sleep(0.1)
        assert ready.exists()
        client = device_server.DeviceServerClient.connect(str(fasta),
                                                          path=sock)
        box = {}

        def prime():
            try:
                box["out"] = client.prime_regions(recs, DELTA)
            except Exception as e:  # noqa: BLE001
                box["err"] = e

        th = threading.Thread(target=prime)
        th.start()
        time.sleep(1.0)          # the prime runs about 7 s on one CPU core
        client.abort_prime = True
        th.join(120)
        assert isinstance(box.get("err"), PrimeAborted), box
        assert len(client.prime_regions(recs[:4], DELTA)) == 4
        client.close()
    finally:
        if srv.is_alive():
            device_server.stop_server(sock)
        srv.join(120)
    assert not srv.is_alive()


def _killed_server(tmp_path, monkeypatch, device):
    """A server on ``device`` that dies under a client: the client raises
    (not PrimeAborted), and a CLI run priming through it ends with an
    error."""
    fasta, fq = _inputs(tmp_path)
    reads = _first_barcode(fq)
    proc, sock = _port_server(fasta, tmp_path, device=device)
    client = device_server.DeviceServerClient.connect(str(fasta), path=sock)
    assert client is not None and client.device_type == device.split(":")[0]
    proc.kill()
    proc.wait()
    with pytest.raises(OSError):
        client.prime_regions(reads, DELTA)

    proc, sock = _port_server(fasta, tmp_path, "cli", device=device)
    real = cli._device_engine

    def dying(genome, fm):
        eng = real(genome, fm)
        proc.kill()
        proc.wait()
        return eng

    monkeypatch.setattr(cli, "_device_engine", dying)
    monkeypatch.setenv("LARIAT_DEVICE_SOCKET", sock)
    monkeypatch.setenv("LARIAT_DEVICE_SERVER_CPU_OK", "1")
    monkeypatch.setenv("LARIAT_PRIME_BATCH", "8")
    with pytest.raises(RuntimeError, match="device priming failed") as e:
        cli.main(["-reads", str(fq), "-genome", str(fasta), "-output",
                  str(tmp_path / "o"), "-threads", "2", "-use_device", "on",
                  "-first_chunk"])
    assert isinstance(e.value.__cause__, OSError)
    assert not isinstance(e.value.__cause__, PrimeAborted)


def test_killed_server_fails_client_and_cli(tmp_path, monkeypatch):
    _killed_server(tmp_path, monkeypatch, "cpu")


@pytest.mark.cuda
def test_killed_server_fails_client_and_cli_on_a_card(tmp_path, monkeypatch,
                                                      last_card):
    _killed_server(tmp_path, monkeypatch, last_card)


def test_second_server_refuses_a_socket_in_use(tmp_path):
    """A server started on a socket another server answers on exits
    nonzero before it loads anything, and the first keeps serving: servers
    on one host, a card each, cannot silently share a socket."""
    fasta, _ = _inputs(tmp_path)
    proc, sock = _port_server(fasta, tmp_path)
    try:
        r = subprocess.run(
            [sys.executable, "-m", "lariat_tpu_torch.parallel.device_server",
             "-genome", str(fasta), "-socket", sock, "-ready_file",
             str(tmp_path / "second.ready")], cwd=REPO,
            env=_env(LARIAT_TORCH_DEVICE="cpu", LARIAT_PRIME_BATCH="8"),
            capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert f"a device server already listens on {sock}" in r.stderr
        assert not (tmp_path / "second.ready").exists()
        client = device_server.DeviceServerClient.connect(str(fasta),
                                                          path=sock)
        assert client is not None and client.device_type == "cpu"
    finally:
        _stop(proc, sock)


def test_socket_path_differs_from_the_jax_server():
    from lariat_tpu.parallel import device_server as jax_server
    for g in ("/data/ref/hg38.fa", "g.fa"):
        mine = device_server.default_socket_path(g)
        assert mine != jax_server.default_socket_path(g)
        assert os.path.basename(mine).startswith("lariat_torch_dev_")
        assert mine == device_server.default_socket_path(g)
