"""Wave wall of the priming pass (``align/batch_engine.py``) a thousand
primed pairs: the server's ``[device_server] device waves ... wave wall``
where priming ran there, else the CLIs' ``device waves: ... wave wall``."""
from core import counts, lines

UNIT = "s/kpair"


def read(ctx):
    primed = counts.primed_pairs(ctx)
    if not primed:
        return None
    if ctx.get("server"):
        wall = lines.server(ctx["server"]).get("wave_wall_s")
    else:
        wall = sum(s.get("wave_wall_s", 0.0) for s in ctx["summaries"])
    return None if wall is None else wall / (primed / 1000.0)
