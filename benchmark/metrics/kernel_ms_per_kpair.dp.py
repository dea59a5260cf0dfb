"""Device milliseconds of the DP kernels K1, K2, K2b and K3
(``csrc/`` via ``ops/_build.py``) a thousand primed pairs, from the
profiler's trace of the priming process."""
from core import counts, kernels

UNIT = "ms/kpair"


def read(ctx):
    primed = counts.primed_pairs(ctx)
    s = kernels.device_s(ctx.get("profiles", []), kernels.DP)
    return 1000.0 * s / (primed / 1000.0) if primed and s else None
