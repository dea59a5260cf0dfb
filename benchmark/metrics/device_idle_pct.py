"""Share of the window in which no operation ran on the card: 100 x (1 -
busy / window), busy the union of the profiler's kernels, copies and sets
inside the window, averaged over the cards."""
UNIT = "%"


def read(ctx):
    b = ctx.get("busy_s")
    return None if b is None else 100.0 * (1.0 - b / ctx["window_s"])
