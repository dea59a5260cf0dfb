"""Share of the window's pairs whose DP ran in a priming pass: primed /
(primed + host) from each CLI's ``device waves:`` line (the router,
``cli.py`` ``_primed_iter``)."""
from core import counts

UNIT = "%"


def read(ctx):
    p, h = counts.primed_pairs(ctx), counts.host_pairs(ctx)
    return 100.0 * p / (p + h) if p + h else None
