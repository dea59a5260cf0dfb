"""Resident priming server and its client (unix-socket IPC): the port of
lariat_tpu/parallel/device_server.py.

A CLI run pays, before its first primed batch, the CUDA context, the kernel
library's build or load, the pac (and, with device seeding, the FM index)
upload and the first waves' allocations. A resident process holds all of
them across runs: short-lived CLI runs send it their batches over a unix
socket and their workers never touch CUDA.

    python -m lariat_tpu_torch.parallel.device_server -genome ref.fa \\
        [-socket PATH] [-idle_timeout SECONDS] [-ready_file PATH]

then run the CLI with ``LARIAT_DEVICE_SOCKET=PATH`` (or without it, when
the server listens on the genome's default socket). The server builds
``TorchBatchAlignmentEngine`` on ``device.get_device()`` (CUDA unless
``LARIAT_TORCH_DEVICE=cpu``), builds the kernels, uploads the pac (and the
seeding index when the seeding policy turns it on), primes one synthetic
batch of ``LARIAT_PRIME_BATCH`` pairs (``_prewarm``; skipped with
``LARIAT_SERVER_NO_PREWARM=1``), and only then listens and writes the ready
file; its log gives the seconds of its imports, the load, the upload and
the prewarm. On a host with several cards each server takes its card with
``LARIAT_TORCH_DEVICE=cuda:h`` and a ``-socket`` of its own, and each CLI
that primes through it that socket in ``LARIAT_DEVICE_SOCKET``: a server
refuses a socket on which another already answers. It primes on two
worker threads, as the CLI's two priming threads do, and at its end
prints the kernel launches made since it became ready and its device
path (``path_log`` since then: its card and CUDA contexts, the batches
each seeder served, the largest batch and launches, the peak device
memory).

Protocol: length-prefixed pickles. Requests:
  ("prime", recs, score_delta) -> ("ok", primes, wave_stats_delta)
  ("ping",)                    -> ("ok", device_type, device_name)
  ("abort",)                   -> ("ok",): the primes in flight stop at
                                  their next wave boundary (PrimeAborted)
  ("stop",)                    -> ("ok",) then the server exits
A server-side exception answers ("err", repr) and the connection stays
usable. The client raises on a socket error or an "err" reply; only a
server-side PrimeAborted comes back as PrimeAborted, which the router
host-routes.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import socket
import struct
import tempfile
import threading
import time
from typing import Optional

_HDR = struct.Struct("<Q")


def default_socket_path(genome: str) -> str:
    """The genome's socket (its absolute path hashed) in the temporary
    directory; named apart from the JAX package's server, whose replies a
    port client could not read."""
    h = hashlib.sha1(os.path.abspath(genome).encode()).hexdigest()[:12]
    return os.path.join(tempfile.gettempdir(), f"lariat_torch_dev_{h}.sock")


def _send(conn: socket.socket, obj) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    conn.sendall(_HDR.pack(len(data)) + data)


def _recv(conn: socket.socket):
    """One message, or None when the peer closed the connection."""
    hdr = b""
    while len(hdr) < _HDR.size:
        chunk = conn.recv(_HDR.size - len(hdr))
        if not chunk:
            return None
        hdr += chunk
    (n,) = _HDR.unpack(hdr)
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = conn.recv_into(view[got:], min(1 << 20, n - got))
        if not r:
            return None
        got += r
    return pickle.loads(bytes(buf))


# ---------------------------------------------------------------- server


def _prewarm(engine, fm, pairs: int = 0) -> None:
    """Prime one synthetic batch at the router's fixed batch size: every
    wave kind (seeding, extension, rescue, reg2aln) runs once before the
    first request."""
    import numpy as np

    from ..io.fastq import FastQRecord

    pairs = pairs or int(os.environ.get("LARIAT_PRIME_BATCH", "1024"))
    rng = np.random.default_rng(99)
    lut = np.frombuffer(b"ACGT", np.uint8)
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    span = 400
    recs = []
    for i in range(pairs):
        pos = int(rng.integers(0, max(fm.l_pac - span - 2, 1)))
        seg = np.asarray(fm.get_seq_codes(pos, pos + span)).copy()
        # mutations and an occasional broken mate run rescue and the band
        # ladders
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(0, span))
            seg[p] = (seg[p] + 1) % 4
        r1 = lut[np.clip(seg[:151], 0, 3)].tobytes()
        r2b = lut[np.clip(seg[span - 151:], 0, 3)].tobytes()
        r2 = r2b.translate(comp)[::-1]
        if i % 97 == 0:
            r2 = lut[rng.integers(0, 4, 151)].tobytes()
        recs.append(FastQRecord(read1=r1, read_qual1=b"I" * 151,
                                read2=r2, read_qual2=b"I" * 151,
                                barcode10x=b"ACGTACGTACGTAC-1"))
    engine.prime_regions(recs, 17)


def _refuse_taken(genome: str, path: str) -> None:
    """Raise when a server answers on ``path``: another would unlink its
    socket and take its clients, so servers on one host (a card each) need
    a socket each."""
    if DeviceServerClient.connect(genome, path=path) is not None:
        raise RuntimeError(f"a device server already listens on {path}; "
                           f"give this one a socket of its own (-socket)")


def serve(genome: str, socket_path: Optional[str] = None,
          idle_timeout_s: float = 1800.0, ready_file: Optional[str] = None
          ) -> None:
    """Run the priming server until a stop request or ``idle_timeout_s``
    without one. Any set-up error (the kernel build, an upload, the
    prewarm) raises before the server listens, as does a server already
    answering on the socket."""
    t_imports = time.time()
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from ..align.batch_engine import TorchBatchAlignmentEngine
    from ..cli import load_reference
    from ..device import describe
    from ..ops import _build

    path = socket_path or default_socket_path(genome)
    _refuse_taken(genome, path)
    t0 = time.time()
    fm = load_reference(genome)
    engine = TorchBatchAlignmentEngine(fm)       # builds the kernels
    dev = engine.device
    t1 = time.time()
    engine._pac_resident()
    seeding = engine.device_seeding()
    if seeding:
        engine._seed_index()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"[device_server] set-up: imports {t0 - t_imports:.3f}s, load "
          f"{t1 - t0:.3f}s (index, kernels), upload {time.time() - t1:.3f}s "
          f"(pac{', seeding index' if seeding else ''}), l_pac {fm.l_pac}",
          flush=True)
    if os.environ.get("LARIAT_SERVER_NO_PREWARM") != "1":
        t0 = time.time()
        _prewarm(engine, fm)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        print(f"[device_server] prewarm {time.time() - t0:.3f}s", flush=True)
    # the launches, the batches, the largest batch and the peak memory
    # printed at the end are the clients'
    _build.reset_launches()
    engine.reset_path_log()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    _refuse_taken(genome, path)
    try:
        os.unlink(path)           # a stale socket file
    except OSError:
        pass
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(path)
    srv.listen(8)
    srv.settimeout(1.0)
    if ready_file:
        with open(ready_file, "w") as f:
            f.write("ready\n")
    name = describe(dev)
    print(f"[device_server] serving {genome} on {path} ({name})", flush=True)

    last_used = [time.time()]
    stop = threading.Event()
    ex = ThreadPoolExecutor(max_workers=2,
                            thread_name_prefix="lariat-serve-prime")
    active = [0]
    alock = threading.Lock()

    def handle(conn: socket.socket) -> None:
        try:
            while not stop.is_set():
                req = _recv(conn)
                if req is None:
                    return
                last_used[0] = time.time()
                kind = req[0]
                if kind == "ping":
                    _send(conn, ("ok", dev.type, name))
                elif kind == "stop":
                    _send(conn, ("ok",))
                    stop.set()
                    return
                elif kind == "abort":
                    # a client hit the end of its input with primes in
                    # flight: they stop at their next wave boundary, so the
                    # workers are free for the next run
                    with alock:
                        if active[0] > 0:
                            engine.abort_prime = True
                    _send(conn, ("ok",))
                elif kind == "prime":
                    _, recs, delta = req
                    with alock:
                        active[0] += 1
                    # the waves of this prime (and of one running beside
                    # it on the other worker, as in the reference)
                    w0 = dict(engine.wave_stats)
                    try:
                        primes = ex.submit(engine.prime_regions, recs,
                                           delta).result()
                        reply = ("ok", primes,
                                 {k: engine.wave_stats[k] - w0[k]
                                  for k in engine.wave_stats})
                    except Exception as e:  # noqa: BLE001 -- to the client
                        reply = ("err", repr(e))
                    finally:
                        with alock:
                            active[0] -= 1
                            if active[0] == 0:
                                engine.abort_prime = False
                    # only now: a client that sends its next prime on the
                    # reply (on another connection) finds no abort left
                    _send(conn, reply)
                else:
                    _send(conn, ("err", f"unknown request {kind!r}"))
        except OSError:
            pass
        finally:
            conn.close()

    try:
        while not stop.is_set():
            if time.time() - last_used[0] > idle_timeout_s:
                print("[device_server] idle timeout", flush=True)
                break
            try:
                conn, _ = srv.accept()
            except socket.timeout:
                continue
            threading.Thread(target=handle, args=(conn,),
                             daemon=True).start()
    finally:
        srv.close()
        try:
            os.unlink(path)
        except OSError:
            pass
        ex.shutdown(wait=True)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ws = engine.wave_stats
        print(f"[device_server] device waves {ws['n']}  wave wall "
              f"{ws['wall']:.3f}s", flush=True)
        print(f"[device_server] kernel launches: "
              f"{json.dumps(_build.launches())}", flush=True)
        print(f"[device_server] kernel entry launches: "
              f"{json.dumps(_build.entry_launches())}", flush=True)
        print(f"[device_server] device path: "
              f"{json.dumps(engine.path_log())}", flush=True)


# ---------------------------------------------------------------- client


class DeviceServerClient:
    """Engine-shaped proxy: the CLI's router primes through it as through
    a local ``TorchBatchAlignmentEngine``. A connection per priming thread.
    A socket error or an "err" reply raises (the run fails); a server-side
    ``PrimeAborted`` raises ``PrimeAborted`` (the router host-routes)."""

    def __init__(self, path: str, device_type: str, device_name: str,
                 timeout_s: float = 600.0):
        self.path = path
        self.device_type = device_type
        self.device_name = device_name
        self.timeout_s = timeout_s
        self._abort = False
        self.wave_stats = {"wall": 0.0, "n": 0}
        self._local = threading.local()
        self._lock = threading.Lock()

    @classmethod
    def connect(cls, genome: str, path: Optional[str] = None,
                probe_timeout_s: float = 10.0
                ) -> Optional["DeviceServerClient"]:
        """A client of the server on ``path`` (default: the genome's
        socket), or None when no server answers there."""
        path = path or default_socket_path(genome)
        if not os.path.exists(path):
            return None
        try:
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
                c.settimeout(probe_timeout_s)
                c.connect(path)
                _send(c, ("ping",))
                resp = _recv(c)
        except OSError:
            return None                 # a stale socket file
        if not resp or resp[0] != "ok":
            return None
        return cls(path, resp[1], resp[2])

    @property
    def abort_prime(self) -> bool:
        return self._abort

    @abort_prime.setter
    def abort_prime(self, v: bool) -> None:
        # the router sets it at the end of its input: relay it, so that the
        # server's primes in flight stop between waves too
        self._abort = bool(v)
        if v:
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
                c.settimeout(self.timeout_s)
                c.connect(self.path)
                _send(c, ("abort",))
                if _recv(c) is None:
                    raise ConnectionError(
                        f"device server {self.path} closed the connection")

    def _conn(self) -> socket.socket:
        c = getattr(self._local, "conn", None)
        if c is None:
            c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            c.settimeout(self.timeout_s)
            c.connect(self.path)
            self._local.conn = c
        return c

    def prime_regions(self, recs, score_delta=None):
        from ..align.batch_engine import PrimeAborted
        c = self._conn()
        _send(c, ("prime", list(recs), score_delta))
        resp = _recv(c)
        if resp is None:
            raise ConnectionError(
                f"device server {self.path} closed the connection")
        if resp[0] == "err":
            if resp[1].startswith("PrimeAborted("):
                raise PrimeAborted()
            raise RuntimeError(f"device server {self.path}: {resp[1]}")
        _, primes, dw = resp
        with self._lock:
            self.wave_stats["wall"] += dw.get("wall", 0.0)
            self.wave_stats["n"] += dw.get("n", 0)
        return primes

    def close(self) -> None:
        c = getattr(self._local, "conn", None)
        if c is not None:
            c.close()
            self._local.conn = None


def stop_server(path: str, timeout_s: float = 60.0) -> None:
    """Ask the server on ``path`` to exit."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
        c.settimeout(timeout_s)
        c.connect(path)
        _send(c, ("stop",))
        if _recv(c) is None:
            raise ConnectionError(f"device server {path} closed the "
                                  f"connection")


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        description="Resident priming server of lariat_tpu_torch (see the "
                    "module docstring)")
    p.add_argument("-genome", required=True)
    p.add_argument("-socket", default="")
    p.add_argument("-idle_timeout", type=float, default=1800.0)
    p.add_argument("-ready_file", default="")
    a = p.parse_args(argv)
    serve(a.genome, a.socket or None, a.idle_timeout, a.ready_file or None)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
