"""Device milliseconds of the seeding kernels K4a-K4c, K5 and K9 a
thousand device-seeded pairs, from the profiler's trace."""
from core import counts, kernels

UNIT = "ms/kpair"


def read(ctx):
    pairs = counts.device_seeded_pairs(ctx)
    s = kernels.device_s(ctx.get("profiles", []), kernels.SEED)
    return 1000.0 * s / (pairs / 1000.0) if pairs and s else None
