"""CPU tests of the card's idle time put down to the port's spans
(``core/idle.py``) on synthetic intervals and spans, and of the readers of
the router's routes and the candidates' wall: each cause in its order of
precedence, the five shares summing to ``device_idle_pct``, nothing read
where the port printed no such line or wrote no span file.

    python -m pytest benchmark/test_bench_spans.py -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from core import idle, lines, manifest  # noqa: E402

DATA = os.path.join(HERE, "testdata")
ROOT = os.path.dirname(HERE)


def _span(name, t0, t1, thread="lariat-serve-prime_0"):
    return {"name": name, "t0": t0, "t1": t1, "thread": thread, "id": 1,
            "parent": 0, "attrs": {}}


def _procs(*spans, role="server"):
    return [{"pid": 1, "role": role, "spans": list(spans)}]


@pytest.fixture(scope="module")
def man():
    return manifest.Manifest(ROOT)


def test_interval_arithmetic():
    a = idle.merge([(0, 2), (1, 3), (5, 6), (7, 7)])
    assert a == [[0, 3], [5, 6]]
    assert idle.intersect(a, [[2, 5.5]]) == [[2, 3], [5, 5.5]]
    assert idle.subtract(a, [[1, 2], [5.5, 9]]) == [[0, 1], [2, 3],
                                                   [5, 5.5]]
    assert idle.idle_of([(1, 2, 0), (3, 4, 1)], 0, 5) == [[0, 1], [2, 3],
                                                         [4, 5]]


@pytest.mark.parametrize("name,cause", [
    ("wave.ext", "wave"), ("wave.r2a.f", "wave"), ("seed.device", "seed"),
    ("seed.host", "seed"), ("prime", "pass"), ("prime.rescue", "pass"),
    ("server.request", "ipc"), ("client.prime", "ipc"),
    ("server.queue", None), ("router.batch", None), ("dl", None)])
def test_each_span_name_to_its_cause(name, cause):
    assert idle.cause_of(name) == cause


def test_precedence_wave_seed_pass_ipc_then_unrequested():
    """A window of 10 s, the card busy 1 s: the request open 1-9 s, the
    pass 2-8 s, a seeding call 2-4 s with a wave 3-5 s over it: each idle
    instant to the first cause that holds."""
    busy = [(0.0, 1.0, 0)]
    procs = _procs(_span("server.request", 1.0, 9.0, "conn"),
                   _span("prime", 2.0, 8.0),
                   _span("seed.device", 2.0, 4.0),
                   _span("wave.ext", 3.0, 5.0),
                   _span("server.queue", 0.0, 10.0, "conn"))
    got = idle.attribute(busy, procs, 0.0, 10.0)
    assert got == pytest.approx({"wave": 2.0, "seed": 1.0, "pass": 3.0,
                                 "ipc": 2.0, "unrequested": 1.0})
    # busy time takes nothing from any cause: the card ran 3.5-4.5 s
    got = idle.attribute(busy + [(3.5, 4.5, 1)], procs, 0.0, 10.0)
    assert got["wave"] == pytest.approx(1.0) and \
        got["unrequested"] == pytest.approx(1.0)


def test_shares_sum_to_device_idle_pct(man):
    """Two cards, as ``device_idle_pct`` averages them; spans outside
    the window count nothing."""
    from core.cell import busy_in
    profs = [{"device_events": 3, "intervals": [[10.0, 10.5, 0],
                                                [14.0, 15.0, 0]]},
             {"device_events": 1, "intervals": [[9.0, 11.0, 0]]},
             {"device_events": 0, "intervals": []}]
    procs = _procs(_span("wave.ext", 11.0, 12.0), _span("prime", 8.0, 13.0),
                   _span("client.prime", 12.5, 18.0), role="cli") + \
        _procs(_span("seed.device", 16.0, 17.0))
    t0, t1 = 10.0, 20.0
    ctx = {"profiles": profs, "spans": procs, "t_open": t0, "t_close": t1,
           "window_s": t1 - t0}
    busy = [busy_in(p["intervals"], t0, t1) for p in profs
            if p["device_events"]]
    ctx["busy_s"] = sum(busy) / len(busy)
    want = man.reader("device_idle_pct").read(ctx)
    got = idle.shares(ctx)
    assert set(got) == set(idle.CAUSES)
    assert sum(got.values()) == pytest.approx(want)
    # card 0 (idle 8.5 s): wave 1, seed 1, pass 1.5, ipc 3, unrequested 2;
    # card 1 (idle 9 s): wave 1, seed 1, pass 1, ipc 4, unrequested 2
    assert got["pass"] == pytest.approx(100.0 * 2.5 / 2 / 10)
    assert got["ipc"] == pytest.approx(100.0 * 7.0 / 2 / 10)
    assert got["wave"] == pytest.approx(100.0 * (1.0 + 1.0) / 2 / 10)
    assert got["seed"] == pytest.approx(100.0 * 1.0 / 10)


def test_nothing_without_span_files(tmp_path):
    assert idle.load(str(tmp_path)) == []
    assert idle.load(str(tmp_path / "none")) == []
    ctx = {"profiles": [{"device_events": 1, "intervals": []}],
           "t_open": 0.0, "t_close": 1.0, "window_s": 1.0}
    assert idle.shares(ctx) is None
    ctx["spans"] = []
    assert idle.shares(ctx) is None


def test_load_reads_the_port_files(tmp_path):
    head = {"pid": 7, "role": "server", "clock": "time.time_ns"}
    rec = {"name": "wave.ext", "id": 3, "parent": 2, "t0": 1_500_000_000,
           "t1": 2_000_000_000, "thread": "t", "attrs": {"rows": 8}}
    (tmp_path / "spans.7.jsonl").write_text(
        json.dumps(head) + "\n" + json.dumps(rec) + "\n")
    (got,) = idle.load(str(tmp_path))
    assert got["pid"] == 7 and got["role"] == "server"
    (s,) = got["spans"]
    assert (s["t0"], s["t1"], s["attrs"]) == (1.5, 2.0, {"rows": 8})


def test_thread_seconds_and_launches_inside_spans():
    procs = _procs(_span("prime", 0.0, 6.0), _span("wave.ext", 1.0, 2.0),
                   _span("seed.device", 3.0, 5.0),
                   _span("server.request", 0.0, 10.0, "conn"))
    got = idle.thread_seconds(procs, "server", 0.0, 10.0)
    assert got["lariat-serve-prime_0"] == pytest.approx(
        {"wave": 1.0, "seed": 2.0, "pass": 3.0, "ipc": 0.0, "none": 4.0})
    assert got["conn"]["ipc"] == pytest.approx(10.0)
    prof = {"names": ["sw_extend_kernel", "Memcpy DtoH", "twoptr_kernel"],
            "intervals": [[1.2, 1.3, 0], [1.5, 1.6, 1], [4.0, 4.1, 2],
                          [7.0, 7.1, 0]]}
    inside = idle.launched_inside(prof, procs, ("sw_extend", "twoptr"))
    assert [(k, s) for k, s, _, _ in inside] == [
        ("sw_extend_kernel", "wave.ext"), ("twoptr_kernel", "seed.device")]


ROUTES = ('router routes: {"primed": 700, "busy": 250, "dormant": 0, '
          '"half": 50, "oversize": 0, "tail_cancel": 0, "abandoned": 0, '
          '"aborted": 0}\n')
CAND = "candidates wall: 30.00s host-routed, 12.50s primed across workers\n"


def _ctx(texts):
    return {"texts": texts, "summaries": [lines.summary(t) for t in texts],
            "server": None}


def test_router_and_candidate_readers(man):
    with open(os.path.join(DATA, "port_chr20_10k.log")) as f:
        base = f.read()
    # the parent's lines: neither is printed, nothing is read
    ctx = _ctx([base])
    for name in ("busy_routed_share", "host_candidates_s_per_kpair"):
        assert man.reader(name).read(ctx) is None, name
    text = base.replace("device waves: 51  wave wall 19.4s  busy fraction "
                        "1.00  primed pairs 10000  host pairs 0",
                        "device waves: 51  wave wall 19.4s  busy fraction "
                        "1.00  primed pairs 700  host pairs 300")
    assert text != base
    ctx = _ctx([text + ROUTES + CAND, text + ROUTES + CAND])
    assert man.reader("busy_routed_share").read(ctx) == pytest.approx(25.0)
    assert man.reader("host_candidates_s_per_kpair").read(ctx) == \
        pytest.approx(60.0 / 0.6)
    # no host-routed pair: nothing to divide by
    ctx = _ctx([base + CAND])
    assert man.reader("host_candidates_s_per_kpair").read(ctx) is None


def test_spanrun_on_the_tiny_server_cell(tmp_path):
    """``spanrun.py`` on the CPU: the tiny server cell, traced, with every
    process of the port recording: span files of the CLI and the server,
    the requests and passes inside the window, the run still correct, the
    router's two readers reported. No device events on the CPU, so no idle
    shares."""
    import time

    import spanrun
    import tinycell
    root = tinycell.make(str(tmp_path))
    keep = str(tmp_path / "keep")
    out = spanrun.run(root, "tiny.server", 2147485202, 2, True, time.time(),
                      keep=keep, port_root=ROOT,
                      device_env=tinycell.CPU_ENV, check_device=False)
    assert out["result"]["correct"]
    sp = out["spans"]
    assert sorted(r for r, n in sp["span_files"]) == ["cli", "server"]
    assert all(n for _, n in sp["span_files"])
    seen = sp["in_window"]
    for key in ("cli:router.batch", "cli:client.prime", "cli:client.wait",
                "server:server.request", "server:prime",
                "server:prime.regions", "server:wave.ext"):
        assert seen.get(key, [0])[0] > 0, (key, seen)
    assert "idle_pct" not in sp
    assert sp["server_thread_kinds"]["prime"]["wave"] > 0
    m = out["result"]["metrics"]
    assert "busy_routed_share" in m
    assert len(os.listdir(os.path.join(keep, "spans"))) == 2
    # the recorder off: the same run writes no span file
    keep0 = str(tmp_path / "keep0")
    out = spanrun.run(root, "tiny.server", 2147485203, 2, False,
                      time.time(), keep=keep0, port_root=ROOT,
                      device_env=tinycell.CPU_ENV, check_device=False)
    assert out["result"]["correct"] and out["spans"]["span_files"] == []
    assert os.listdir(os.path.join(keep0, "spans")) == []
