"""Host milliseconds of device seeding's collects (``ops/smem_device.py``)
a thousand device-seeded pairs: the server's ``[seedtrace]`` lines
(``LARIAT_SEED_TRACE=1`` in the traced run), all tags summed, printed
after its ``[device_server] prewarm`` line. The server resets its path
log, whose device-seeded pairs are the denominator, after the prewarm, so
both count the clients' batches alone."""
from core import counts, lines

UNIT = "ms/kpair"
PREWARM = "[device_server] prewarm"


def read(ctx):
    srv = ctx.get("server")
    at = srv.find(PREWARM) if srv else -1
    if at < 0:
        return None
    ms, n = lines.seedtrace_ms(srv[at:])
    pairs = counts.device_seeded_pairs(ctx)
    return ms / (pairs / 1000.0) if n and pairs else None
