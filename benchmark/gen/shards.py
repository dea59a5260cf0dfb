"""Barcode-complete shards, by the rule of the four-card smoke phase: the
barcode groups in input order, ``ceil(groups / n)`` whole groups a shard,
so no barcode is split and every shard but the last is equally full."""

from __future__ import annotations

import numpy as np


def shard_ranges(group_bounds: np.ndarray, n: int) -> list:
    """[(start, end)] pair ranges of ``n`` shards, from the (G + 1,)
    offsets of the barcode groups."""
    groups = len(group_bounds) - 1
    per = -(-groups // n)
    out = []
    for h in range(n):
        g0, g1 = min(h * per, groups), min((h + 1) * per, groups)
        out.append((int(group_bounds[g0]), int(group_bounds[g1])))
    return out
