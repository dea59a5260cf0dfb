"""RFA seconds summed over the host workers (``parallel/host_pipeline.py``,
``rfa/``) a thousand processed pairs: the CLIs' ``rfa wall: X s across
workers``."""
UNIT = "s/kpair"


def read(ctx):
    pairs = sum(s.get("pairs", 0) for s in ctx["summaries"])
    walls = [s["rfa_wall_s"] for s in ctx["summaries"] if "rfa_wall_s" in s]
    return sum(walls) / (pairs / 1000.0) if walls and pairs else None
