"""The card's idle time put down to what the port's host threads were doing,
from the port's span files (``LARIAT_SPANS``, ``lariat_tpu_torch/utils/
spans.py``) and the device trace's busy intervals, both on Unix-epoch
time.

Each idle instant of the window [t_open, t_close] goes to the first cause
that holds:

1. ``wave``: a thread is inside a ``wave.*`` span (a DP wave's build,
   dispatch and download);
2. ``seed``: inside a ``seed.*`` span (one seeding call);
3. ``pass``: inside a priming pass elsewhere (``prime``, ``prime.*``);
4. ``ipc``: a ``server.request`` or a CLI's ``client.prime`` is open;
5. ``unrequested``: none of these.

Per card, as ``device_idle_pct`` counts: each profile with device events
is a card, its idle seconds split over the five causes by every process's
spans, then averaged over the cards and given as a share of the window, so
the five shares sum to ``device_idle_pct``.
"""

from __future__ import annotations

import glob
import json
import os

CAUSES = ("wave", "seed", "pass", "ipc", "unrequested")


def cause_of(name: str):
    """The cause a span's name stands for (None: no cause of its own)."""
    if name.startswith("wave."):
        return "wave"
    if name.startswith("seed."):
        return "seed"
    if name == "prime" or name.startswith("prime."):
        return "pass"
    if name in ("server.request", "client.prime"):
        return "ipc"
    return None


def load(directory: str) -> list:
    """Every span file of ``directory``: [{"pid", "role", "spans"}], each
    span's times in seconds (``t0``, ``t1``); [] where there is none."""
    out = []
    for path in sorted(glob.glob(os.path.join(directory,
                                              "spans.*.jsonl"))):
        with open(path) as f:
            lines = [json.loads(x) for x in f if x.strip()]
        if not lines:
            continue
        recs = []
        for r in lines[1:]:
            r = dict(r)
            r["t0"], r["t1"] = r["t0"] / 1e9, r["t1"] / 1e9
            recs.append(r)
        out.append({"pid": lines[0].get("pid"), "role": lines[0].get("role"),
                    "spans": recs})
    return out


def merge(intervals) -> list:
    """Sorted, disjoint [s, e] covering the given (s, e, ...)."""
    out = []
    for s, e, *_ in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def intersect(a, b) -> list:
    """The overlap of two merged interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append([s, e])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a, b) -> list:
    """``a`` less ``b``, both merged."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, cur = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append([cur, b[k][0]])
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append([cur, e])
    return out


def length(a) -> float:
    return sum(e - s for s, e in a)


def idle_of(busy, t0: float, t1: float) -> list:
    """The idle part of [t0, t1]: the window less the merged busy
    intervals."""
    return subtract([[t0, t1]], merge(busy))


def attribute(busy, procs, t0: float, t1: float) -> dict:
    """{cause: idle seconds} of one card: its busy intervals (s, e, ...)
    in seconds, the processes' spans (``load``'s), the window."""
    idle = idle_of(busy, t0, t1)
    by = {c: [] for c in CAUSES[:-1]}
    for p in procs:
        for r in p["spans"]:
            c = cause_of(r["name"])
            if c is not None:
                by[c].append((r["t0"], r["t1"]))
    out = {}
    for c in CAUSES[:-1]:
        got = intersect(idle, merge(by[c]))
        out[c] = length(got)
        idle = subtract(idle, got)
    out["unrequested"] = length(idle)
    return out


def shares(ctx) -> dict | None:
    """{cause: % of the window} averaged over the cards, as
    ``device_idle_pct`` averages; None without span files or device
    events."""
    procs = ctx.get("spans")
    profs = [p for p in ctx.get("profiles") or [] if p.get("device_events")]
    if not procs or not profs:
        return None
    t0, t1, w = ctx["t_open"], ctx["t_close"], ctx["window_s"]
    parts = [attribute(p["intervals"], procs, t0, t1) for p in profs]
    return {c: 100.0 * sum(q[c] for q in parts) / len(parts) / w
            for c in CAUSES}


def thread_seconds(procs, role: str, t0: float, t1: float) -> dict:
    """Of each thread of the processes of ``role``: the window's seconds
    inside each cause (the same precedence, on that thread's spans alone)
    and in none. {thread: {cause: s}}."""
    out = {}
    for p in procs:
        if p["role"] != role:
            continue
        threads = {}
        for r in p["spans"]:
            c = cause_of(r["name"])
            if c is not None:
                threads.setdefault(r["thread"], {k: [] for k in
                                                 CAUSES[:-1]})[c].append(
                    (r["t0"], r["t1"]))
        for th, by in threads.items():
            rest, row = [[t0, t1]], {}
            for c in CAUSES[:-1]:
                got = intersect(rest, merge(by[c]))
                row[c] = length(got)
                rest = subtract(rest, got)
            row["none"] = length(rest)
            out[th] = row
    return out


def launched_inside(profile, procs, kernels, kinds=("wave.", "seed.")):
    """The device intervals whose last operation is one of ``kernels`` and
    that lie inside a ``wave.*`` or ``seed.*`` span: [(kernel, span,
    s, e)] (the shared clock on the card)."""
    names = profile.get("names", [])
    spans = sorted((r["t0"], r["t1"], r["name"]) for p in procs
                   for r in p["spans"] if r["name"].startswith(kinds))
    out = []
    for s, e, i in profile.get("intervals", []):
        n = names[i] if i < len(names) else ""
        if not any(k in n for k in kernels):
            continue
        for a, b, name in spans:
            if a > s:
                break
            if e <= b:
                out.append((n, name, s, e))
                break
    return out
