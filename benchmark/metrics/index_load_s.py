"""Seconds the CLI takes to load the index (``index/fmindex.py``): its
``index load:`` line (the slowest process where there are several)."""
UNIT = "s"


def read(ctx):
    v = [s["index_load_s"] for s in ctx["summaries"] if "index_load_s" in s]
    return max(v) if v else None
