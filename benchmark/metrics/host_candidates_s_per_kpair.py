"""Seconds the host workers (``parallel/host_pipeline.py``, ``rfa/``) spent
on the candidates of host-routed barcodes, a thousand host-routed pairs:
the host-routed part of each CLI's ``candidates wall: H s host-routed, P s
primed across workers`` (``get_chains`` and ``get_alignments``: seeding,
chaining, DP and rescue) over the host pairs of its ``device waves:``
line. Missing where no CLI printed the line or no pair was host-routed."""
import re

from core import counts

UNIT = "s/kpair"
CAND = re.compile(r"^candidates wall: ([0-9.]+)s host-routed, ([0-9.]+)s "
                  r"primed across workers", re.M)


def read(ctx):
    walls = [float(m[0]) for t in ctx["texts"] for m in CAND.findall(t)]
    pairs = counts.host_pairs(ctx)
    return sum(walls) / (pairs / 1000.0) if walls and pairs else None
