"""Seconds the resident server (``parallel/device_server.py``) takes to be
ready: its ``[device_server] set-up:`` imports, load and upload, and its
prewarm."""
from core import lines

UNIT = "s"


def read(ctx):
    if not ctx.get("server"):
        return None
    s = lines.server(ctx["server"])
    parts = ("imports_s", "load_s", "upload_s", "prewarm_s")
    return sum(s[k] for k in parts) if all(k in s for k in parts) else None
