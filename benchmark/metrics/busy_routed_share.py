"""Share of the routed pairs that the router (``cli.py`` ``_primed_iter``)
sent to the host workers because every priming thread was busy: 100 x
``busy`` / every pair of each CLI's ``router routes: {...}`` line (the
pairs primed and those host-routed by each reason). Missing where no CLI
printed the line."""
import json
import re

UNIT = "%"
ROUTES = re.compile(r"^router routes: (\{.*\})\s*$", re.M)


def read(ctx):
    busy = total = 0
    seen = False
    for text in ctx["texts"]:
        for m in ROUTES.findall(text):
            routes = json.loads(m)
            busy += routes.get("busy", 0)
            total += sum(routes.values())
            seen = True
    return 100.0 * busy / total if seen and total else None
