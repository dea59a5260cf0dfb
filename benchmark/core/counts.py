"""Counts the per-layer readers share."""

from . import lines


def primed_pairs(ctx) -> int:
    return sum(s.get("primed_pairs", 0) for s in ctx["summaries"])


def host_pairs(ctx) -> int:
    return sum(s.get("host_pairs", 0) for s in ctx["summaries"])


def device_seeded_pairs(ctx) -> float:
    """Primed pairs times the share of priming batches that seeded on the
    device (by the server's device path, else each CLI's)."""
    logs = ([lines.path_log(ctx["server"])] if ctx.get("server")
            else [lines.path_log(t) for t in ctx["texts"]])
    dev = sum((d or {}).get("seed_device_batches", 0) for d in logs)
    host = sum((d or {}).get("seed_host_batches", 0) for d in logs)
    return primed_pairs(ctx) * dev / (dev + host) if dev else 0.0
