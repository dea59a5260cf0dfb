"""Host CPU seconds (user and system) that the port's processes spend over
the window, a thousand delivered pairs: each measured process with the
workers it reaped, and the resident server (``core/cpu.py``; the harness
reads them at the window's opening and close)."""

UNIT = "cpu-s/kpair"


def read(ctx):
    d = ctx.get("delivered")
    return ctx["cpu_s"] / (d / 1000.0) if d and ctx.get("cpu_s") else None
