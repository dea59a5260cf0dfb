"""The port's printed counts and spans, parsed. The summary's expressions
are those of the port's ``tools/bench.py`` ``parse_summary``; the rest
follow the CLI's and the resident server's own lines."""

from __future__ import annotations

import json
import re

RATE = re.compile(r"Processed (\d+) read pairs across (\d+) barcodes "
                  r"in ([0-9.]+)s \(([0-9.]+) pairs/s\)")
WAVES = re.compile(r"^device waves: (\d+)\s+wave wall ([0-9.]+)s\s+"
                   r"busy fraction ([0-9.]+)(?:\s+primed pairs (\d+)\s+"
                   r"host pairs (\d+))?", re.M)
RFA = re.compile(r"rfa wall: ([0-9.]+)s across workers \(rows: (\w+)\)")
INDEX = re.compile(r"^index load: ([0-9.]+)s", re.M)
SERVER_SETUP = re.compile(r"\[device_server\] set-up: imports ([0-9.]+)s, "
                          r"load ([0-9.]+)s .*?upload ([0-9.]+)s")
SERVER_PREWARM = re.compile(r"\[device_server\] prewarm ([0-9.]+)s")
SERVER_WAVES = re.compile(r"\[device_server\] device waves (\d+)\s+"
                          r"wave wall ([0-9.]+)s")
SEEDTRACE = re.compile(r"^\[seedtrace\] (.+?)\s+([0-9.]+)ms\s*$", re.M)
PATH = re.compile(r"^(?:\[device_server\] )?device path: (\{.*\})\s*$",
                  re.M)
MULTIHOST = re.compile(r"^(\{\"host\": .*\})\s*$", re.M)


def summary(text: str) -> dict:
    """{pairs, pairs_s, steady_s} and, where printed, the device line
    (waves, wave wall, primed and host pairs), the RFA wall and the index
    load."""
    m = RATE.search(text)
    out = {} if not m else {"pairs": int(m.group(1)),
                            "steady_s": float(m.group(3)),
                            "pairs_s": float(m.group(4))}
    b = WAVES.search(text)
    if b:
        out["waves"] = int(b.group(1))
        out["wave_wall_s"] = float(b.group(2))
        if b.group(4) is not None:
            out["primed_pairs"] = int(b.group(4))
            out["host_pairs"] = int(b.group(5))
    r = RFA.search(text)
    if r:
        out["rfa_wall_s"] = float(r.group(1))
    i = INDEX.search(text)
    if i:
        out["index_load_s"] = float(i.group(1))
    return out


def server(text: str) -> dict:
    """The resident server's set-up seconds, its waves and its device
    path."""
    out = {}
    s = SERVER_SETUP.search(text)
    if s:
        out["imports_s"], out["load_s"], out["upload_s"] = (
            float(s.group(1)), float(s.group(2)), float(s.group(3)))
    p = SERVER_PREWARM.search(text)
    if p:
        out["prewarm_s"] = float(p.group(1))
    w = SERVER_WAVES.search(text)
    if w:
        out["waves"], out["wave_wall_s"] = int(w.group(1)), float(w.group(2))
    d = path_log(text)
    if d is not None:
        out["path"] = d
    return out


def path_log(text: str):
    m = PATH.findall(text)
    return json.loads(m[-1]) if m else None


def seedtrace_ms(text: str) -> tuple:
    """(total ms of every ``[seedtrace]`` line, lines)."""
    vals = [float(v) for _, v in SEEDTRACE.findall(text)]
    return sum(vals), len(vals)


def multihost(text: str):
    m = MULTIHOST.findall(text)
    return json.loads(m[-1]) if m else None
