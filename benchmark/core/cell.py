"""One run of one cell: set-up, the window, the comparison, the metrics.

Every run is a fresh process tree and goes the same way:

1. set-up (``setup_s``): the configuration's genome and index from the
   checkout's cache (built in the first run), the reads from the seed
   (``pairs_per_s_hint`` x seconds, whole barcodes) written under the
   run's temporary directory, the resident server started and waited on
   (server cells), the measured processes started;
2. the window: from the first ``device priming on`` / ``device priming
   via server`` line of a measured process to the moment the last of them
   returns from the port's module (``launch.py``'s ``[bench] module done``
   line);
3. after the window: the server stopped, the comparison with the
   reference, the metrics.

The host CPU seconds of the window (``host_cpu_s_per_kpair``) are those of
every process of the port (each measured process with its workers, and the
resident server), read from ``/proc`` when a measured process prints its
opening line and again when the window closes.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import socket
import struct
import subprocess
import sys
import tempfile
import threading
import time

from gen import genome, shards, sim_reads
from reference import judge as judge_mod

from . import cpu, lines

OPEN_MARKS = ("device priming on", "device priming via server")
DONE_MARK = "[bench] module done"
# the CLI's summary line, printed before multihost's rendezvous
FINISH_MARK = "Processed "
LAUNCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "launch.py")


class RunError(RuntimeError):
    pass


def stop_on_term() -> None:
    """SIGTERM ends a run as an error would: ``run``'s ``finally`` kills
    every process the run started and waits for each."""
    signal.signal(signal.SIGTERM, lambda signum, _: sys.exit(128 + signum))


class Proc:
    """A launcher subprocess; each output line kept with the host's time
    at which it arrived, and copied to a log."""

    def __init__(self, name, module, args, env, workdir, root,
                 trace=None, on_open=None):
        self.name = name
        # the tree's CPU seconds when its first opening line arrived
        self.cpu_open = None
        self.on_open = on_open
        self.side_path = os.path.join(workdir, f"{name}.side.json")
        self.log_path = os.path.join(workdir, f"{name}.log")
        self.lines = []
        cmd = [sys.executable, LAUNCH, "--side", self.side_path,
               "--module", module]
        if trace:
            cmd += ["--trace-at", trace]
        self.cmd = cmd + ["--", *args]
        self.env, self.root = env, root
        self.p = None

    def start(self):
        self._log = open(self.log_path, "w")
        self._log.write("$ " + " ".join(self.cmd) + "\n")
        self.p = subprocess.Popen(
            self.cmd, env=self.env, cwd=self.root, stdin=subprocess.DEVNULL,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            start_new_session=True, text=True, bufsize=1)
        self._t = threading.Thread(target=self._read, daemon=True)
        self._t.start()
        return self

    def _read(self):
        opened = self.on_open is None
        for line in self.p.stdout:
            self.lines.append((time.time(), line))
            if not opened and any(m in line for m in OPEN_MARKS):
                opened = True
                self.on_open(self)
            self._log.write(line)
        self._log.flush()

    def first(self, marks) -> float | None:
        for t, line in list(self.lines):
            if any(m in line for m in marks):
                return t
        return None

    def wait(self, timeout) -> int:
        rc = self.p.wait(timeout=timeout)
        self._t.join(timeout=30)
        return rc

    def alive(self) -> bool:
        return self.p is not None and self.p.poll() is None

    def kill(self):
        if self.alive():
            try:
                os.killpg(self.p.pid, signal.SIGKILL)
            except OSError:
                pass
            self.p.wait()
        if self.p is not None:
            self._t.join(timeout=30)

    def text(self) -> str:
        return "".join(line for _, line in self.lines)

    def side(self) -> dict:
        with open(self.side_path) as f:
            return json.load(f)


class Smi:
    """``nvidia-smi`` sampled every second: the memory in use on each card,
    for the memory peak. Nothing where there is no ``nvidia-smi``."""

    def __init__(self):
        self.samples = []
        self.p = None

    def start(self):
        try:
            self.p = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=index,memory.used",
                 "--format=csv,noheader,nounits",
                 "-lms", "1000"], stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, stdin=subprocess.DEVNULL,
                text=True, start_new_session=True)
        except OSError:
            return self
        self._t = threading.Thread(target=self._read, daemon=True)
        self._t.start()
        return self

    def _read(self):
        for line in self.p.stdout:
            try:
                i, mem = (float(x) for x in line.split(","))
            except ValueError:
                continue
            self.samples.append((int(i), mem))

    def stop(self):
        if self.p is not None and self.p.poll() is None:
            self.p.terminate()
            try:
                self.p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.p.kill()
                self.p.wait()
            self._t.join(timeout=10)

    def peak_bytes(self, cards) -> int:
        used = [m for i, m in self.samples if i in cards]
        return int(max(used) * 2 ** 20) if used else 0


def stop_server(path: str, cwd: str, timeout_s: float = 60.0) -> None:
    """The resident server's ``("stop",)`` request (its protocol: a
    length-prefixed pickle) on ``path``, relative to ``cwd``."""
    import pickle
    data = pickle.dumps(("stop",))
    here = os.getcwd()
    os.chdir(cwd)
    try:
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as c:
            c.settimeout(timeout_s)
            c.connect(path)
            c.sendall(struct.pack("<Q", len(data)) + data)
            c.recv(64)
    finally:
        os.chdir(here)


def busy_in(intervals, t0, t1) -> float:
    """Seconds of [t0, t1] covered by merged (start, end, name)
    intervals."""
    return sum(max(0.0, min(e, t1) - max(s, t0)) for s, e, _ in intervals)


def gaps_in(intervals, names, t0, t1) -> list:
    """Idle gaps of [t0, t1]: [(name, seconds)], each named by the
    operation the device last ran (or the window's opening)."""
    out, prev, name = [], t0, "window open"
    for s, e, i in intervals:
        n = names[i]
        if e <= t0 or s >= t1:
            continue
        if s > prev:
            out.append((f"idle after {name}", s - prev))
        prev, name = max(prev, e), n
    if t1 > prev:
        out.append((f"idle after {name}, to the window's close", t1 - prev))
    return out


def _env(root, port_root, cfg, tr, device):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("LARIAT_")}
    env["PYTHONPATH"] = os.pathsep.join(
        [port_root] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    env["PYTHONUNBUFFERED"] = "1"
    env.update(cfg.get("env", {}))
    env.update(tr.get("env", {}))
    if device is not None:
        env.update(device)
    return env


def run(man, workload: str, seed: int, seconds: int, trace: bool,
        t_start: float, port_root: str | None = None,
        device_env: dict | None = None, check_device: bool = True,
        keep: str | None = None, cache_root: str | None = None) -> dict:
    """One run; returns {"result": the result line, "info": the window's
    and set-up's seconds and the pair counts}. ``device_env``
    (tests) replaces the cards with a device of the port's choosing, such
    as ``{"LARIAT_TORCH_DEVICE": "cpu", ...}``; ``check_device`` False
    skips the look for cards."""
    wl = man.workload(workload)
    cfg = man.config(wl["config"])
    tr = man.traffic(wl["traffic"])
    chips = int(wl["chips"])
    root = man.root
    port_root = port_root or root
    if check_device:
        import torch
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < chips:
            raise RunError(
                f"no CUDA device, or fewer than the {chips} this cell asks "
                f"for (available {torch.cuda.is_available()}, count "
                f"{torch.cuda.device_count()})")
    work = tempfile.mkdtemp(prefix="lariat_bench_")
    procs, smi = [], Smi().start()
    try:
        return _run(man, wl, cfg, tr, chips, seed, seconds, trace, t_start,
                    root, port_root, device_env, check_device, work, procs,
                    smi, cache_root)
    finally:
        smi.stop()
        for p in procs:
            p.kill()
        if keep:
            os.makedirs(keep, exist_ok=True)
            for f in os.listdir(work):
                if f.endswith(".log") or f.endswith(".side.json"):
                    shutil.copy(os.path.join(work, f), keep)
        shutil.rmtree(work, ignore_errors=True)


def _run(man, wl, cfg, tr, chips, seed, seconds, trace, t_start, root,
         port_root, device_env, check_device, work, procs, smi, cache_root):
    env = _env(root, port_root, cfg, tr, device_env)
    cache_dir = os.path.join(cache_root or os.path.join(
        root, "benchmark", ".cache"), cfg["name"])
    with open(os.path.join(work, "genome.log"), "w") as log:
        g = genome.ensure(cfg, cache_dir, env=env, log=log)
    codes, contigs = genome.load_codes(cache_dir)
    n_bc = max(chips, round(tr["pairs_per_s_hint"] * seconds
                            / tr["pairs_per_bc"]))
    reads = sim_reads.simulate(codes, contigs, n_bc, tr, seed)
    entry = tr["entry"]
    genome_args = ["-genome", g["fa"]]
    cli_args = list(tr.get("cli_args", []))
    if cfg.get("centromeres"):
        cli_args += ["-centromeres", g["cen"]]
    workers = str(tr["workers"])
    out_dirs = []

    server = None
    if entry == "server":
        # a unix socket's path holds at most 107 bytes: both processes run
        # in the checkout, so a long temporary path goes relative
        sock = min(os.path.join(work, "srv.sock"),
                   os.path.relpath(os.path.join(work, "srv.sock"), root),
                   key=len)
        ready = os.path.join(work, "srv.ready")
        senv = dict(env)
        if trace:
            senv["LARIAT_SEED_TRACE"] = "1"
        server = Proc("server", "lariat_tpu_torch.parallel.device_server",
                      genome_args + ["-socket", sock, "-ready_file", ready],
                      senv, work, root, trace="reset" if trace else None)
        procs.append(server.start())
        while not os.path.exists(ready):
            if not server.alive():
                raise RunError("the resident server exited before it was "
                               "ready:\n" + server.text()[-4000:])
            if time.time() - t_start > 1500:
                raise RunError("the resident server was not ready in time")
            time.sleep(0.05)
        env = dict(env, LARIAT_DEVICE_SOCKET=sock)

    lock = threading.Lock()

    def opened(p):
        with lock:
            p.cpu_open = cpu.tree_cpu_s(p.p.pid)
            if server is not None and server.cpu_open is None:
                server.cpu_open = cpu.tree_cpu_s(server.p.pid)

    measured = []
    if entry in ("cli", "server"):
        path = os.path.join(work, "reads.fastq")
        sim_reads.write_fastq(path, reads)
        out = os.path.join(work, "out")
        out_dirs.append(out)
        measured.append(Proc(
            "cli", "lariat_tpu_torch.cli",
            ["-reads", path, *genome_args, "-output", out, "-threads",
             workers, "-use_device", "on", *cli_args], env, work, root,
            trace="engine" if trace and entry == "cli" else None,
            on_open=opened))
    elif entry == "multihost":
        coord = os.path.join(work, "coord")
        for h, (s, e) in enumerate(shards.shard_ranges(
                reads.group_bounds(), chips)):
            path = os.path.join(work, f"shard{h}.fastq")
            sim_reads.write_fastq(path, reads, s, e)
            out_dirs.append(os.path.join(work, "out", f"host{h:03d}"))
            henv = dict(env)
            if device_env is None:
                henv["LARIAT_TORCH_DEVICE"] = f"cuda:{h}"
            measured.append(Proc(
                f"host{h}", "lariat_tpu_torch.parallel.multihost",
                ["-coordinator", "file://" + coord, "-num_processes",
                 str(chips), "-process_id", str(h), "-reads", path,
                 *genome_args, "-output_base", os.path.join(work, "out"),
                 "-threads", workers, "-use_device", "on", *cli_args],
                henv, work, root, trace="engine" if trace else None,
                on_open=opened))
    else:
        raise RunError(f"unknown entry {entry!r}")
    for p in measured:
        procs.append(p.start())
    deadline = t_start + 1500
    for p in measured:
        try:
            rc = p.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            raise RunError(f"{p.name} did not finish in time")
        if rc != 0:
            for q in measured:
                q.kill()
            raise RunError(f"{p.name} exited {rc}:\n" + p.text()[-6000:])
    if server is not None:
        server_cpu = cpu.tree_cpu_s(server.p.pid)
        stop_server(sock, root)
        try:
            server.wait(timeout=120)
        except subprocess.TimeoutExpired:
            raise RunError("the resident server did not stop")
        if server.p.returncode != 0:
            raise RunError("the server exited "
                           f"{server.p.returncode}:\n"
                           + server.text()[-6000:])
    smi.stop()

    opens = [p.first(OPEN_MARKS) for p in measured]
    dones = [p.first((DONE_MARK,)) for p in measured]
    if None in opens or None in dones:
        raise RunError("a measured process never opened or closed its "
                       "window:\n" + measured[0].text()[-4000:])
    t_open, t_close = min(opens), max(dones)
    window_s = t_close - t_open
    texts = [p.text() for p in measured]
    sums = [lines.summary(t) for t in texts]
    processed = sum(s.get("pairs", 0) for s in sums)

    sides = [p.side() for p in measured + ([server] if server else [])]
    try:
        cpu_s = sum(s["cpu_s"] - p.cpu_open
                    for s, p in zip(sides, measured))
        if server is not None:
            cpu_s += server_cpu - server.cpu_open
        cpu_parts = {"workers": sum(s.get("cpu_children_s", 0.0)
                                    for s in sides[:len(measured)]),
                     "server": (server_cpu - server.cpu_open
                                if server is not None else 0.0)}
    except TypeError:   # no /proc: host_cpu_s_per_kpair goes unreported
        cpu_s = cpu_parts = None
    forbidden = sorted({m for s in sides for m in s.get("forbidden", [])})
    if forbidden:
        raise RunError(f"the port's processes loaded {forbidden}")

    # the comparison, after the window: the reference reads the BAMs
    t_judge = time.time()
    j = judge_mod.Judge(reads, codes, contigs, seed)
    counts = j.judge(out_dirs, processed)
    t_judge = time.time() - t_judge
    limits = dict(tr["limits"])
    checks = {k: {"value": counts[k], "limit": limits.get(k, 0)}
              for k in judge_mod.COMPARED}
    if entry == "multihost":
        checks["stats_exchange_off"] = {
            "value": _exchange_off(texts), "limit": 0}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    delivered = reads.n - counts["pairs_lost"]

    # the device
    cards = list(range(chips))
    peaks = [smi.peak_bytes(cards)]
    for t in texts + ([server.text()] if server else []):
        d = lines.path_log(t)
        if d and d.get("cuda_peak_bytes"):
            peaks.append(int(d["cuda_peak_bytes"]))
    device = {"platform": "gpu" if check_device else "cpu",
              "kind": _device_name() if check_device else "cpu",
              "count": chips, "memory_peak_bytes": max(peaks)}

    ctx = {"entry": entry, "texts": texts, "summaries": sums,
           "server": server.text() if server else None,
           "t_open": t_open, "t_close": t_close, "window_s": window_s,
           "delivered": delivered, "attempted": reads.n,
           "dones": dones, "opens": opens, "cpu_s": cpu_s,
           "finishes": [p.first((FINISH_MARK,)) for p in measured]}
    result = {"correct": correct, "attempted": reads.n,
              "failed": counts["pairs_lost"], "metrics": {},
              "device": device}
    info = {"window_s": window_s, "setup_s": t_open - t_start,
            "pairs": reads.n, "delivered": delivered,
            "processed": processed, "judge_s": t_judge,
            "pairs_per_s": delivered / window_s, "cpu_s": cpu_s,
            "cpu_s_parts": cpu_parts,
            "wrong_pct": counts["wrong_pct"],
            "off_origin_equal_pct": counts["off_origin_equal_pct"]}
    if not trace:
        values = {"pairs_per_s": delivered / window_s,
                  "setup_s": t_open - t_start}
        for name in man.metric_names(wl["name"], "end_to_end"):
            if name not in values:
                raise RunError(f"the harness has no end-to-end {name!r}")
            result["metrics"][name] = {
                "value": values[name], "unit": man.metrics[name]["unit"]}
    else:
        profs = [s["profile"] for s in sides
                 if s.get("profile", {}).get("started")]
        ctx["profiles"] = profs
        busy = [busy_in(pr["intervals"], t_open, t_close) for pr in profs
                if pr.get("device_events")]
        ctx["busy_s"] = sum(busy) / len(busy) if busy else None
        device["busy_s"] = ctx["busy_s"]
        device["window_s"] = window_s
        for name in man.metric_names(wl["name"], "per_layer"):
            v = man.reader(name).read(ctx)
            if v is not None:
                result["metrics"][name] = {
                    "value": v, "unit": man.metrics[name]["unit"]}
        result["breakdown"] = _breakdown(profs, t_open, t_close)
    result["checks"] = checks
    return {"result": result, "info": info}


def _exchange_off(texts) -> int:
    """Processes whose global stats are not the sum of every process's
    local stats (the one ``all_reduce``)."""
    outs = [lines.multihost(t) for t in texts]
    if any(o is None for o in outs):
        return len(texts)
    total = [sum(v) for v in zip(*(o["local_stats"] for o in outs))]
    return sum(o["global_stats"] != total for o in outs)


def short(name: str) -> str:
    """A device operation's trace name without its return type, template
    and parameters: ``sw_extend_kernel``, ``Memcpy DtoH``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    for stop in ("<", "(", " ("):
        if stop in name and not name.startswith("Memcpy"):
            name = name.split(stop, 1)[0]
    return name.split(" (", 1)[0]


def _breakdown(profs, t0, t1) -> dict:
    ops, gaps = {}, []
    for h, pr in enumerate(profs):
        for name, (s, _) in pr.get("kernels", {}).items():
            ops[short(name)] = ops.get(short(name), 0.0) + s
        pre = f"card {h}: " if len(profs) > 1 else ""
        names = [short(n) for n in pr.get("names", [])]
        gaps += [(pre + n, s) for n, s in
                 gaps_in(pr.get("intervals", []), names, t0, t1)]
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in
                          sorted(gaps, key=lambda g: -g[1])[:10]]}


def _device_name() -> str:
    import torch
    return torch.cuda.get_device_name(0)
