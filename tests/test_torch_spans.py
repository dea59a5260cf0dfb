"""The port's span recorder (``lariat_tpu_torch/utils/spans.py``): off it
records nothing and writes nothing; on it nests spans on a thread and
across threads, writes one file a process at exit (a forked child none),
and its clock is the one ``torch.profiler`` stamps its events on. Then the
spans where the work happens: a server in this process gives
``server.request`` > ``prime`` > ``seed.*`` / ``wave.*`` for one prime, and
a CPU CLI run records its spans and writes the same BAM bytes as the run
without them, printing the router's routes and the candidates' wall."""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import pytest
import torch

from lariat_tpu_torch.config import RFAConfig
from lariat_tpu_torch.parallel import device_server
from lariat_tpu_torch.utils import spans

from test_torch_cli import _env, _inputs
from test_torch_device_server import _pairs

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def recording(monkeypatch, tmp_path):
    """Recording on in this process, into an empty list."""
    monkeypatch.setattr(spans, "DIR", str(tmp_path / "spans"))
    monkeypatch.setattr(spans, "_records", [])
    return tmp_path / "spans"


def _within(inner, outer):
    return outer["t0"] <= inner["t0"] and inner["t1"] <= outer["t1"]


def test_off_records_nothing_and_writes_nothing(monkeypatch, tmp_path):
    monkeypatch.setattr(spans, "DIR", None)
    monkeypatch.setattr(spans, "_records", [])
    s = spans.span("wave.ext", tasks=3)
    assert s is spans.OFF and spans.span("x", parent=s) is spans.OFF
    with s as inner:
        assert inner.child("build") is spans.OFF
        assert spans.under(inner) is spans.OFF
    assert s.end(route="busy") is spans.OFF and s.kid_s("build") == 0.0
    # a site's own trace times without recording
    with spans.span("wave.ext", timed=True) as w:
        with w.child("dl"):
            time.sleep(0.002)
    assert w.kid_s("dl") >= 0.002 and w.seconds >= w.kid_s("dl")
    assert spans.records() == []
    monkeypatch.chdir(tmp_path)
    spans.write()
    assert os.listdir(tmp_path) == []


def test_nests_on_a_thread_and_across_threads(recording):
    with spans.span("outer", pairs=4) as outer:
        with spans.span("inner") as inner:
            inner.child("leaf").end(rows=8)
        handed = spans.span("queue")

    box = {}

    def work():
        handed.end()
        box["mine"] = spans.span("prime", parent=outer)
        box["mine"].end()
        with spans.under(outer):
            with spans.span("adopted") as a:
                box["adopted"] = a
        box["orphan"] = spans.span("orphan")
        box["orphan"].end()

    t = threading.Thread(target=work, name="helper")
    t.start()
    t.join()
    recs = {r["name"]: r for r in spans.records()}
    assert set(recs) == {"outer", "inner", "leaf", "queue", "prime",
                         "adopted", "orphan"}
    oid = recs["outer"]["id"]
    assert recs["outer"]["parent"] == 0
    assert recs["outer"]["attrs"] == {"pairs": 4}
    assert recs["inner"]["parent"] == oid
    assert recs["leaf"]["parent"] == recs["inner"]["id"]
    assert recs["leaf"]["attrs"] == {"rows": 8}
    assert recs["queue"]["parent"] == oid
    assert recs["prime"]["parent"] == oid and recs["adopted"]["parent"] == oid
    assert recs["orphan"]["parent"] == 0
    assert recs["prime"]["thread"] == "helper"
    assert recs["outer"]["thread"] == threading.current_thread().name
    assert _within(recs["inner"], recs["outer"])
    assert all(r["t0"] <= r["t1"] for r in recs.values())
    # the adopted parent is not ended by the thread that adopted it
    assert recs["outer"]["t1"] <= recs["queue"]["t1"]


_PROCESS = textwrap.dedent("""
    import os, sys, threading
    from lariat_tpu_torch.utils import spans
    spans.set_role("cli")
    with spans.span("outer") as outer:
        with spans.span("inner"):
            pass
    t = threading.Thread(
        target=lambda: spans.span("prime", parent=outer).end())
    t.start()
    t.join()
    pid = os.fork()
    if pid == 0:
        # a forked worker: records nothing, writes nothing at its exit
        spans.span("in_child").end()
        sys.exit(0)
    os.waitpid(pid, 0)
    print(os.getpid(), pid)
    """)


def test_writes_its_file_at_exit_and_a_fork_writes_none(tmp_path):
    out = tmp_path / "spans"
    r = subprocess.run([sys.executable, "-c", _PROCESS], cwd=REPO,
                       env=_env(LARIAT_SPANS=str(out), PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    pid, child = (int(v) for v in r.stdout.split())
    assert os.listdir(out) == [f"spans.{pid}.jsonl"]
    lines = (out / f"spans.{pid}.jsonl").read_text().splitlines()
    head = json.loads(lines[0])
    assert head == {"pid": pid, "role": "cli", "clock": "time.time_ns"}
    recs = [json.loads(x) for x in lines[1:]]
    by = {r["name"]: r for r in recs}
    assert sorted(by) == ["inner", "outer", "prime"] and child != pid
    assert by["inner"]["parent"] == by["outer"]["id"]
    assert by["prime"]["parent"] == by["outer"]["id"]


def test_profiler_events_lie_inside_their_span():
    """The clock: a ``record_function`` range run inside a span, read
    through ``kineto_results.events()`` as ``benchmark/launch.py`` reads
    the device's events, lies within the span's ns bounds."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("outer", timed=True) as s:
            for _ in range(3):
                with record_function("lariat_span_probe"):
                    torch.ones(256).cumsum(0)
    seen = 0
    for e in prof.profiler.kineto_results.events():
        if e.name() != "lariat_span_probe":
            continue
        start = int(e.start_ns()) if hasattr(e, "start_ns") \
            else int(e.start_us()) * 1000
        dur = int(e.duration_ns()) if hasattr(e, "duration_ns") \
            else int(e.duration_us()) * 1000
        assert s.t0 <= start and start + dur <= s.t1, (s.t0, start, s.t1)
        seen += 1
    assert seen == 3


def test_server_request_holds_the_prime_its_seeding_and_waves(
        tmp_path, monkeypatch, recording):
    """A server in this process on the CPU, device seeding forced, one
    prime from a client of this process: ``client.prime`` holds its send,
    wait and receive, and the server's pass ends inside the wait;
    ``server.request`` holds
    ``server.recv``, ``server.queue``, the worker thread's ``prime`` and
    ``server.reply``; ``prime`` holds ``prime.regions`` > ``seed.device``
    (the ``[seedtrace]`` phases its children) and the waves with their
    steps."""
    fasta, _ = _inputs(tmp_path)
    # a base deleted from each first mate: reg2aln's waves run
    recs = [dataclasses.replace(r, read1=r.read1[:70] + r.read1[71:] + b"A")
            for r in _pairs(fasta, 6)]
    sock, ready = str(tmp_path / "s.sock"), tmp_path / "s.ready"
    monkeypatch.setenv("LARIAT_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("LARIAT_SERVER_NO_PREWARM", "1")
    monkeypatch.setenv("LARIAT_DEVICE_SEED", "1")
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
        assert len(client.prime_regions(
            recs, RFAConfig().chain_score_delta)) == 6
        client.close()
    finally:
        if srv.is_alive():
            device_server.stop_server(sock)
        srv.join(120)
    got = spans.records()
    by_id = {r["id"]: r for r in got}

    def kids(r, name=None):
        return [k for k in got if k["parent"] == r["id"]
                and (name is None or k["name"] == name)]

    def under(r, name):
        """The descendants of ``r`` named ``name``."""
        out, todo = [], [r]
        while todo:
            for k in kids(todo.pop()):
                todo.append(k)
                if k["name"] == name or name.endswith(".*") and \
                        k["name"].startswith(name[:-1]):
                    out.append(k)
        return out

    (cp,) = [r for r in got if r["name"] == "client.prime"]
    assert cp["attrs"] == {"pairs": 6}
    assert [k["name"] for k in sorted(kids(cp), key=lambda k: k["t0"])] \
        == ["client.send", "client.wait", "client.recv"]
    (req,) = [r for r in got if r["name"] == "server.request"
              and r["attrs"].get("kind") == "prime"]
    assert req["attrs"] == {"kind": "prime", "pairs": 6}
    assert sorted(k["name"] for k in kids(req)) == [
        "prime", "server.queue", "server.recv", "server.reply"]
    (pr,) = kids(req, "prime")
    # the server's pass starts after the client's prime and ends before
    # the client's wait for the reply does
    (wait,) = kids(cp, "client.wait")
    assert cp["t0"] <= req["t0"] <= pr["t0"] and pr["t1"] <= wait["t1"]
    assert pr["thread"].startswith("lariat-serve-prime")
    assert pr["thread"] != req["thread"]
    assert sorted(k["name"] for k in kids(pr)) == [
        "prime.reg2aln", "prime.regions", "prime.rescue"]
    seeds = under(pr, "seed.*")
    assert [s["name"] for s in seeds] == ["seed.device"]
    assert by_id[seeds[0]["parent"]]["name"] == "prime.regions"
    assert [k["name"] for k in sorted(kids(seeds[0]),
                                      key=lambda k: k["t0"])][:6] == [
        "r1+r3 dispatch", "r1 pack dl", "r1 assembly", "r2", "r3 assembly",
        "merge+sort"]
    waves = under(pr, "wave.*")
    names = {w["name"] for w in waves}
    assert {"wave.ext", "wave.r2a.d", "wave.r2a.f"} <= names
    for w in waves:
        assert _within(w, pr)
        steps = {k["name"] for k in kids(w)}
        assert steps <= {"build", "disp", "dl"}
        # a rescue wave without a DP task has no step, as its [wtrace]
        # line has zeros
        if w["name"] != "wave.loc" or w["attrs"]:
            assert steps and {"rows", "dn_b"} <= set(w["attrs"])
    for r in got:
        if r["parent"] in by_id:
            assert _within(r, by_id[r["parent"]]), (r, by_id[r["parent"]])


def test_cli_records_spans_and_writes_the_same_bams(tmp_path):
    """The port's CLI on the CPU, priming in its process: with
    ``LARIAT_SPANS`` it writes one span file (role cli; the router's,
    the priming pass's and the waves' spans) and BAM files byte for byte
    those of the run without it; both print the router's routes and the
    candidates' wall."""
    fasta, fq = _inputs(tmp_path)
    out, sdir = tmp_path / "out", tmp_path / "spans"
    runs = {}
    for tag, extra in (("off", {}), ("on", {"LARIAT_SPANS": str(sdir)})):
        r = subprocess.run(
            [sys.executable, "-m", "lariat_tpu_torch.cli", "-reads",
             str(fq), "-genome", str(fasta), "-output", str(out),
             "-threads", "2", "-use_device", "on", "-first_chunk"],
            cwd=REPO, env=_env(LARIAT_TORCH_DEVICE="cpu", **extra),
            capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
        runs[tag] = ({os.path.relpath(os.path.join(d, f), out):
                      open(os.path.join(d, f), "rb").read()
                      for d, _, fs in os.walk(out) for f in fs}, r.stdout)
        os.rename(out, tmp_path / f"out_{tag}")
        if tag == "off":
            assert not sdir.exists()
    assert runs["on"][0] == runs["off"][0] and runs["on"][0]
    for _, text in runs.values():
        (routes,) = [json.loads(x.split(": ", 1)[1])
                     for x in text.splitlines()
                     if x.startswith("router routes: ")]
        assert routes["primed"] == 35 and sum(routes.values()) == 35
        assert set(routes) == {"primed", "busy", "dormant", "half",
                               "oversize", "tail_cancel", "abandoned",
                               "aborted"}
        assert any(x.startswith("candidates wall: ") and
                   x.endswith("s primed across workers")
                   for x in text.splitlines())
    (name,) = os.listdir(sdir)
    lines = (sdir / name).read_text().splitlines()
    assert json.loads(lines[0])["role"] == "cli"
    names = {json.loads(x)["name"] for x in lines[1:]}
    assert {"router.batch", "router.queue", "prime.regions",
            "prime.rescue", "prime.reg2aln", "seed.host", "wave.ext",
            "build", "disp", "dl"} <= names, names
    batches = [json.loads(x) for x in lines[1:]
               if json.loads(x)["name"] == "router.batch"]
    assert sum(b["attrs"]["pairs"] for b in batches) == 35
    assert {b["attrs"]["route"] for b in batches} == {"prime"}
