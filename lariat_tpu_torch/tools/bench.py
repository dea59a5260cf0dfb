"""Benchmark of the port: end-to-end pipeline throughput on one GPU, the
port of bench.py.

    python -m lariat_tpu_torch.tools.bench      # needs CUDA; one card

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "detail": {...}}

Primary metric: the throughput of the shipped CLI (``python -m
lariat_tpu_torch.cli``: FASTQ -> candidates -> mate rescue -> RFA -> BAM)
over 320 molecule-structured barcodes x 100 pairs on a 4.6 Mb synthetic
genome with a planted segdup at ``sa_intv=32``, 5 workers, the better of
two configurations, in read pairs aligned per second per card:

- host-native (``-use_device off``);
- device-primed through the resident server
  (``python -m lariat_tpu_torch.parallel.device_server``, on its own
  socket, stopped in a ``finally``) at the router's defaults; the
  server's kernel launches over the mode's runs are recorded.

Each is one warm-up run and the median of 3; every run records its
``primed_pairs`` and ``host_pairs`` where the CLI prints them. ``detail``
also holds the RFA row probe (one host-native run with the torch rows,
``LARIAT_RFA_JIT=1``), the record diff rate of the last host and device
runs, the ``data_big/`` hg38 and chr20 1M runs (``data_big/`` regenerated
by ``python -m lariat_tpu_torch.tools.gen_data_big`` when it is missing,
unless ``LARIAT_BENCH_NO_GEN`` is set, which records ``hg38_skipped``), the
kernel
roofline (``python -m lariat_tpu_torch.tools.kernel_roofline``), the device
align step (``python -m lariat_tpu_torch.tools.device_step``) and the
card's name and power limit as nvidia-smi gives them. The roofline and the
device step run in subprocesses: this process never initialises CUDA.

vs_baseline compares against 10,000 read pairs/s, a rough figure for the
single-node reference (Go + BWA C API, 8 threads) on commodity CPUs.

Without CUDA (asked in a subprocess) the bench exits nonzero and prints no
result line; so it does when the server does not come up or the device
configuration yields no rate.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np

BASELINE_PAIRS_PER_S = 10_000.0
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
N_BARCODES = 320
PAIRS_PER_BC = 100
THREADS = 5
HG38_DIR = os.path.join(REPO, "data_big")


class BenchError(RuntimeError):
    """The bench cannot produce an honest result line."""


def _env(**extra) -> dict:
    env = {**os.environ, "PYTHONPATH": REPO + (
        ":" + os.environ["PYTHONPATH"] if os.environ.get("PYTHONPATH")
        else "")}
    env.pop("LARIAT_DEVICE_SOCKET", None)
    env.update(extra)
    return env


def _prepare_inputs(workdir: str) -> tuple[str, str, float]:
    """Synth genome + sa_intv=32 index (.lariat.d) + simulated linked reads."""
    from ..index import fmindex

    rng = np.random.default_rng(12)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    glen = 4_600_000
    g = bases[rng.integers(0, 4, glen)].copy()
    # plant segdups so second-best hits / molecule moves are exercised
    g[1_000_000:1_010_000] = g[3_000_000:3_010_000]
    fa = os.path.join(workdir, "g.fa")
    with open(fa, "w") as f:
        s = g.tobytes().decode()
        f.write(">chrE\n")
        step = 1 << 16
        for i in range(0, len(s), step):
            f.write(s[i:i + step] + "\n")
    t0 = time.time()
    fm = fmindex.build_index(fa, sa_intv=32)
    fm.save_dir(fa)  # CLI subprocesses mmap it (instant load)
    t_index = time.time() - t0

    reads = os.path.join(workdir, "reads.fastq.gz")
    subprocess.run(
        [sys.executable, os.path.join(REPO, "tools/sim_reads.py"), fa, reads,
         "--barcodes", str(N_BARCODES), "--pairs-per-bc", str(PAIRS_PER_BC),
         "--molecule-len", "40000"],
        check=True, env=_env(), stdout=subprocess.DEVNULL)
    return fa, reads, t_index


_RATE_RE = re.compile(r"Processed (\d+) read pairs across (\d+) barcodes "
                      r"in ([0-9.]+)s \(([0-9.]+) pairs/s\)")
_BUSY_RE = re.compile(r"device waves: (\d+)\s+wave wall ([0-9.]+)s\s+"
                      r"busy fraction ([0-9.]+)(?:\s+primed pairs (\d+)\s+"
                      r"host pairs (\d+))?")
_TIE_RE = re.compile(r"tie-sensitive picks: (\d+)/(\d+) \(([0-9.]+)\)")
_RFA_RE = re.compile(r"rfa wall: ([0-9.]+)s across workers \(rows: (\w+)\)")


def parse_summary(stdout: str) -> dict:
    """The CLI summary's numbers: {pairs_s, steady_s, pairs} and, where
    printed, the device line (waves, wave wall, busy fraction, primed and
    host pairs), the tie-sensitive picks and the RFA rows."""
    m = _RATE_RE.search(stdout)
    if not m:
        return {}
    out = {"pairs_s": float(m.group(4)), "steady_s": float(m.group(3)),
           "pairs": int(m.group(1))}
    b = _BUSY_RE.search(stdout)
    if b:
        out["device_waves"] = int(b.group(1))
        out["device_wave_wall_s"] = float(b.group(2))
        out["device_busy_frac"] = float(b.group(3))
        if b.group(4) is not None:
            out["primed_pairs"] = int(b.group(4))
            out["host_pairs"] = int(b.group(5))
    tie = _TIE_RE.search(stdout)
    if tie:
        out["tie_sensitive_rate"] = float(tie.group(3))
        out["tie_sensitive_picks"] = [int(tie.group(1)), int(tie.group(2))]
    rfa = _RFA_RE.search(stdout)
    if rfa:
        out["rfa_wall_s"] = float(rfa.group(1))
        out["rfa_rows"] = rfa.group(2)
    return out


def _run_cli(fa: str, reads: str, outdir: str, use_device: str,
             extra=(), threads: int = THREADS, timeout_s: float = 900,
             env: dict = None) -> dict:
    """One CLI invocation; returns {pairs_s, wall_s, pairs, ...} or
    {error}. Bounded, so one hung run never eats the whole bench."""
    t0 = time.time()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "lariat_tpu_torch.cli", "-reads", reads,
             "-genome", fa, "-output", outdir, "-threads", str(threads),
             "-use_device", use_device, *extra],
            cwd=REPO, env=env or _env(), capture_output=True, text=True,
            timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return {"error": f"timeout after {timeout_s:.0f}s"}
    wall = time.time() - t0
    out = parse_summary(proc.stdout)
    if proc.returncode != 0 or not out:
        return {"error": (proc.stderr or proc.stdout)[-400:]}
    out["wall_s"] = round(wall, 1)
    out["startup_s"] = round(wall - out["steady_s"], 1)
    return out


def _cuda_available(timeout_s: float = 150.0) -> bool:
    """torch.cuda.is_available(), asked in a subprocess so that this
    process never initialises CUDA."""
    try:
        p = subprocess.run(
            [sys.executable, "-c",
             "import torch; print('CUDA', torch.cuda.is_available())"],
            env=_env(), capture_output=True, text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return False
    return "CUDA True" in p.stdout


def _card() -> str:
    """The first card's ``name, power.limit`` as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0] if out else ""


class DeviceServer:
    """The port's resident priming server on a socket of its own; ``with``
    stops it (and kills it if it will not stop). After ``close``,
    ``launches`` and ``entry_launches`` hold the kernel launches its log
    reports since it became ready (empty if it was killed)."""

    def __init__(self, genome: str, workdir: str, timeout_s: float = 600.0):
        # the socket in a short directory of its own (a unix socket's path
        # is capped near 108 bytes), so no two benches share a server
        self._sock_dir = tempfile.mkdtemp(prefix="lariat_bench_")
        self.sock = os.path.join(self._sock_dir, "dev.sock")
        d = tempfile.mkdtemp(prefix="srv_", dir=workdir)
        ready = os.path.join(d, "ready")
        self.log = os.path.join(d, "server.log")
        with open(self.log, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, "-m",
                 "lariat_tpu_torch.parallel.device_server", "-genome",
                 genome, "-socket", self.sock, "-ready_file", ready,
                 "-idle_timeout", "3600"], cwd=REPO, env=_env(),
                stdout=log, stderr=subprocess.STDOUT)
        t0 = time.time()
        try:
            while not os.path.exists(ready):
                if self.proc.poll() is not None:
                    raise BenchError(
                        f"the device server exited {self.proc.returncode} "
                        f"before it was ready: {self._tail()}")
                if time.time() - t0 > timeout_s:
                    raise BenchError(
                        f"the device server was not ready after "
                        f"{timeout_s:.0f}s: {self._tail()}")
                time.sleep(0.5)
        except BaseException:
            self.close()
            raise
        self.ready_s = round(time.time() - t0, 1)
        self.launches = self.entry_launches = {}

    def _tail(self) -> str:
        with open(self.log) as f:
            return f.read()[-400:]

    def close(self) -> None:
        if self.proc.poll() is None:
            from ..parallel.device_server import stop_server
            try:
                stop_server(self.sock)
                self.proc.wait(timeout=120)
            except Exception:  # noqa: BLE001 - killed below
                pass
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        shutil.rmtree(self._sock_dir, ignore_errors=True)
        with open(self.log) as f:
            log = f.read()
        m = re.search(r"kernel launches: (\{.*\})", log)
        self.launches = json.loads(m.group(1)) if m else {}
        m = re.search(r"kernel entry launches: (\{.*\})", log)
        self.entry_launches = json.loads(m.group(1)) if m else {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _median_of(runs: list) -> dict:
    """Median-by-pairs_s run dict (the median of >= 3 warm runs is the
    reported number; the run list stays in detail)."""
    if not runs:
        return {"error": "no runs"}
    ok = sorted((r for r in runs if "pairs_s" in r),
                key=lambda r: r["pairs_s"])
    if not ok:
        return runs[-1]
    return ok[len(ok) // 2]


def _mode_runs(fa, reads, workdir, mode, tag, n=4, threads=THREADS,
               extra=(), first_timeout=1200, timeout=600) -> tuple:
    """Run 0 (warm-up) then n - 1 measured runs of one mode; a device mode
    primes through a server of its own. Returns (median with its run
    list, the runs, the stopped server or None)."""
    runs = []
    server = DeviceServer(fa, workdir) if mode == "on" else None
    try:
        env = _env(**({"LARIAT_DEVICE_SOCKET": server.sock} if server
                      else {}))
        errs = 0
        for i in range(n):
            r = _run_cli(fa, reads, os.path.join(workdir, f"{tag}{i}"), mode,
                         extra, threads=threads, env=env,
                         timeout_s=first_timeout if i == 0 else timeout)
            runs.append(r)
            errs = errs + 1 if "error" in r else 0
            if errs >= 2:
                break
    finally:
        if server:
            server.close()
    med = dict(_median_of(runs[1:]))
    med["runs"] = [r.get("pairs_s", 0.0) for r in runs]
    return med, runs, server


def _hg38_inputs():
    """(FASTA, reads, centromeres) of data_big/: the largest read set
    there is."""
    fa = os.path.join(HG38_DIR, "hg38sim.fa")
    reads = os.path.join(HG38_DIR, "sim200k.fastq.gz")
    for fall in ("sim50k.fastq.gz", "sim10k.fastq.gz"):
        if not os.path.exists(reads):
            reads = os.path.join(HG38_DIR, fall)
    return fa, reads, os.path.join(HG38_DIR, "hg38sim.centromeres.tsv")


def _generate_data_big() -> Optional[str]:
    """Regenerate data_big/ with the port's generator (one at a time: it
    takes data_big/.gen.lock); None when it succeeded, else why not. The
    generator runs in a session of its own, so a timeout
    (``LARIAT_BENCH_GEN_TIMEOUT``, default 10,800 s) stops it and its
    children."""
    timeout = float(os.environ.get("LARIAT_BENCH_GEN_TIMEOUT", "10800"))
    print("data_big/ missing; regenerating it (python -m "
          "lariat_tpu_torch.tools.gen_data_big; hours at hg38 scale)",
          file=sys.stderr, flush=True)
    proc = subprocess.Popen(
        [sys.executable, "-m", "lariat_tpu_torch.tools.gen_data_big",
         HG38_DIR], cwd=REPO, env=_env(), stdout=sys.stderr,
        start_new_session=True)
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        return f"data_big regeneration timed out after {timeout:.0f}s"
    return None if rc == 0 else f"data_big regeneration failed (rc {rc})"


def _hg38_runs(workdir: str) -> dict:
    """Full-genome (3.09 Gbp simulated hg38) CLI runs, host vs device, 8
    workers, one warm-up and the median of 3 each, then chr20 scale at 1M
    pairs (device-primed, one run). When ``data_big/`` lacks the inputs it
    is regenerated first, as the reference bench does; with
    ``LARIAT_BENCH_NO_GEN`` set, or when the generator fails, this records
    ``hg38_skipped``."""
    fa, reads, cents = _hg38_inputs()
    if not os.path.isdir(fa + ".lariat.d") or not os.path.exists(reads):
        if os.environ.get("LARIAT_BENCH_NO_GEN"):
            return {"hg38_skipped": "data_big/ missing and "
                                    "LARIAT_BENCH_NO_GEN=1"}
        why = _generate_data_big()
        if why:
            return {"hg38_skipped": why}
        fa, reads, cents = _hg38_inputs()
        if not os.path.isdir(fa + ".lariat.d") or not os.path.exists(reads):
            return {"hg38_skipped": "regeneration completed but inputs "
                                    "still absent"}
    out = {}
    extra = ("-centromeres", cents) if os.path.exists(cents) else ()
    for mode, key in (("off", "hg38_host_8w"), ("on", "hg38_device_8w")):
        med, _, server = _mode_runs(fa, reads, workdir, mode,
                                    f"hg38_{mode}", threads=8, extra=extra,
                                    timeout=900)
        if server:
            med.update(server_ready_s=server.ready_s,
                       server_launches=server.launches,
                       server_entry_launches=server.entry_launches)
        out[key] = med
    c20 = os.path.join(HG38_DIR, "chr20sim.fa")
    c20_reads = os.path.join(HG38_DIR, "sim1m_chr20.fastq.gz")
    if os.path.isdir(c20 + ".lariat.d") and os.path.exists(c20_reads):
        with DeviceServer(c20, workdir) as srv:
            out["chr20_1m"] = _run_cli(
                c20, c20_reads, os.path.join(workdir, "chr20"), "on",
                threads=8, timeout_s=2400,
                env=_env(LARIAT_DEVICE_SOCKET=srv.sock))
    return out


def _record_diff_rate(dir_a: str, dir_b: str) -> dict:
    """Record-level BAM diff between two CLI output dirs: fraction of
    bc-sorted records whose packed bytes differ."""
    import struct

    from ..io.bamread import BamFile

    def recs(d):
        bf = BamFile(os.path.join(d, "bc_sorted_bam.bam"))
        out, off, data = [], bf._records_start, bf.data
        while off < len(data):
            n = struct.unpack_from("<I", data, off)[0]
            out.append(data[off + 4:off + 4 + n])
            off += 4 + n
        return out

    a, b = recs(dir_a), recs(dir_b)
    n = max(len(a), len(b))
    if n == 0:
        return {"sam_diff_rate": 0.0, "records": 0}
    diff = sum(1 for x, y in zip(a, b) if x != y) + abs(len(a) - len(b))
    return {"sam_diff_rate": round(diff / n, 6), "records": n}


def _tool_json(module: str, *args, timeout: float) -> dict:
    """The last JSON line of ``python -m lariat_tpu_torch.tools.<module>``,
    run in a subprocess."""
    p = subprocess.run(
        [sys.executable, "-m", f"lariat_tpu_torch.tools.{module}", *args],
        cwd=REPO, env=_env(), capture_output=True, text=True,
        timeout=timeout)
    lines = [s for s in p.stdout.splitlines() if s.startswith("{")]
    if p.returncode != 0 or not lines:
        raise RuntimeError((p.stderr or p.stdout)[-200:])
    return json.loads(lines[-1])


def run(workdir: str) -> dict:
    """The bench's result object (see the module docstring)."""
    if not _cuda_available():
        raise BenchError("torch.cuda.is_available() is false: the port's "
                         "bench needs one CUDA card")
    fa, reads, t_index = _prepare_inputs(workdir)
    host, host_runs, _ = _mode_runs(fa, reads, workdir, "off", "out_host",
                                    first_timeout=900, timeout=900)
    dev, dev_runs, server = _mode_runs(fa, reads, workdir, "on", "out_dev")
    if "pairs_s" not in dev:
        raise BenchError(f"the device configuration yielded no rate: "
                         f"{dev.get('error', dev)}")
    dev.update(server=True, server_ready_s=server.ready_s,
               server_launches=server.launches,
               server_entry_launches=server.entry_launches)

    candidates = {"cli_host_native_5w": host, "cli_device_primed_5w": dev}
    # a device configuration whose median run primed nothing ran on the
    # host: it is kept in detail but never named the best
    best_name, best = max(
        ((k, v) for k, v in candidates.items() if "pairs_s" in v
         and (v is host or v.get("primed_pairs", 0) > 0)),
        key=lambda kv: kv[1]["pairs_s"], default=(None, None))

    detail = {
        "config": f"{N_BARCODES} barcodes x {PAIRS_PER_BC} pairs, 151bp, "
                  f"4.6Mb genome + segdup, sa_intv=32, {THREADS} workers",
        "card": _card(),
        "best_config": best_name,
        "index_build_s": round(t_index, 1),
        **candidates,
    }
    # the RFA row probe: one host-native run with the torch rows, so the
    # choice of numpy rows stays measured in every result
    detail["rfa_numpy"] = {"pairs_s": host.get("pairs_s"),
                           "rfa_wall_s": host.get("rfa_wall_s")}
    jit_probe = _run_cli(fa, reads, os.path.join(workdir, "out_rfajit2"),
                         "off", env=_env(LARIAT_RFA_JIT="1"))
    detail["rfa_jit_probe"] = {
        k: jit_probe.get(k) for k in ("pairs_s", "rfa_wall_s", "rfa_rows")}
    # record-level device-vs-host parity on the last pair of runs
    try:
        detail["device_vs_host_diff"] = _record_diff_rate(
            os.path.join(workdir, f"out_host{len(host_runs) - 1}"),
            os.path.join(workdir, f"out_dev{len(dev_runs) - 1}"))
    except Exception as e:  # noqa: BLE001
        detail["device_vs_host_diff"] = {"error": str(e)[:200]}
    hg38 = _hg38_runs(workdir)
    detail.update(hg38)
    try:
        detail["roofline"] = _tool_json("kernel_roofline", timeout=1800)
    except Exception as e:  # noqa: BLE001
        detail["roofline_error"] = str(e)[:200]
    try:
        step = _tool_json("device_step", fa, timeout=1200)
        detail.update({k: step[k] for k in (
            "device_step_pairs_s", "device_step_ms",
            "device_step_mapped_frac", "device")})
        detail["device_step_launches"] = step["launches"]
    except Exception as e:  # noqa: BLE001
        detail["device_step_error"] = str(e)[:200]

    # primary metric: the hg38-scale runs when their inputs are present,
    # else the small-genome pipeline, saying so in the metric string
    hg_dev = hg38.get("hg38_device_8w", {})
    hg_host = hg38.get("hg38_host_8w", {})
    hg_best = None
    if "pairs_s" in hg_dev or "pairs_s" in hg_host:
        hg_best = max((r for r in (hg_dev, hg_host) if "pairs_s" in r
                       and (r is hg_host or r.get("primed_pairs", 0) > 0)),
                      key=lambda r: r["pairs_s"], default=None)
        if hg_best is not None:
            detail["primary_config"] = ("hg38_device_8w" if hg_best is hg_dev
                                        else "hg38_host_8w")
    if hg_best is not None:
        value = hg_best["pairs_s"]
        metric = ("read pairs aligned/sec/card (full CLI pipeline on 3.09 "
                  "Gbp simulated hg38: FASTQ->candidates->rescue->RFA->BAM, "
                  "barcoded 10X reads)")
        detail["small_genome_pairs_s"] = best["pairs_s"] if best else 0.0
    else:
        reason = hg38.get("hg38_skipped", "hg38 runs produced no rate")
        detail.setdefault("hg38_skipped", reason)
        value = best["pairs_s"] if best else 0.0
        metric = ("read pairs aligned/sec/card (full CLI pipeline, 4.6Mb "
                  "TOY genome -- hg38 regime SKIPPED: " + str(reason)[:120]
                  + ")")
    return {"metric": metric, "value": round(value, 1),
            "unit": "pairs/s/card",
            "vs_baseline": round(value / BASELINE_PAIRS_PER_S, 3),
            "detail": detail}


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="bench_",
                               dir=os.path.join(REPO, "build"))
    try:
        result = run(workdir)
    except BenchError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
