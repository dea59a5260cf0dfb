"""The port's span recorder: where the host's time goes, on the clock the
device trace uses.

``LARIAT_SPANS=DIR`` (read once, at import) turns recording on. Each
process then keeps its spans in memory and writes ``DIR/spans.<pid>.jsonl``
when it exits: a header line ``{"pid", "role", "clock"}``, then a line a
finished span ``{"name", "id", "parent", "t0", "t1", "thread", "attrs"}``.
``t0`` and ``t1`` are ``time.time_ns()``: Unix-epoch nanoseconds, the
clock on which ``torch.profiler`` (Kineto) stamps its host and device
events, so a span and the kernels it launched can be laid on one line.
Forked children (the CLI's host workers) record nothing.

    with span("wave.ext", tasks=n) as w:     # parent: the thread's open span
        with w.child("build"):
            ...
    q = span("server.queue")                 # ended on another thread
    pool.submit(work, q)                     # there: q.end()

Off, ``span`` returns one shared object (``OFF``) whose methods do nothing:
no allocation and no clock read. A site that prints its own trace line
(``[wtrace]``, ``[seedtrace]``) asks for ``timed=True`` when that trace is
on: the span then reads the clock without being recorded, and the line is
printed from its seconds, so each site has one timing path.
"""

from __future__ import annotations

import atexit
import itertools
import json
import os
import threading
import time

DIR = os.environ.get("LARIAT_SPANS") or None
CLOCK = "time.time_ns"

_role = ["process"]
_records: list = []
_ids = itertools.count(1)
_local = threading.local()
_pid = os.getpid()


class _Off:
    """The span that is neither recorded nor timed."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def end(self, **attrs):
        return self

    def set(self, **attrs):
        return self

    def child(self, name, **attrs):
        return self

    def kid_s(self, name) -> float:
        return 0.0


OFF = _Off()


class Span:
    """One timed interval; recorded at ``end`` when recording is on. Its
    children's seconds are summed by name (``kid_s``) for the sites that
    print them."""

    __slots__ = ("name", "id", "up", "rec", "attrs", "thread", "t0", "t1",
                 "kids")

    def __init__(self, name, up, rec, attrs):
        self.name, self.up, self.rec, self.attrs = name, up, rec, attrs
        self.id = next(_ids)
        self.thread = threading.current_thread().name
        self.kids = None
        self.t1 = None
        self.t0 = time.time_ns()

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *exc):
        st = _stack()
        if self in st:
            st.remove(self)
        self.end()
        return False

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def child(self, name, **attrs):
        """A span under this one, timed or recorded as this one is."""
        return Span(name, self, self.rec, attrs)

    def end(self, **attrs):
        """Close the span (once; later calls do nothing)."""
        if self.t1 is not None:
            return self
        self.t1 = time.time_ns()
        if attrs:
            self.attrs.update(attrs)
        up = self.up
        if up is not None:
            kids = up.kids if up.kids is not None else {}
            kids[self.name] = kids.get(self.name, 0) + self.t1 - self.t0
            up.kids = kids
        if self.rec:
            _records.append(self)
        return self

    @property
    def seconds(self) -> float:
        t1 = self.t1 if self.t1 is not None else time.time_ns()
        return (t1 - self.t0) / 1e9

    def kid_s(self, name) -> float:
        """Seconds of this span's finished children named ``name``."""
        return (self.kids or {}).get(name, 0) / 1e9


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def span(name: str, parent=None, timed: bool = False, **attrs):
    """A span named ``name``, started now; ``OFF`` when recording is off
    and ``timed`` is False. Its parent is ``parent`` (a span of another
    thread) or else the innermost span this thread has entered. ``with``
    enters it as the thread's parent and ends it; ``end()`` ends it
    anywhere."""
    if DIR is None and not timed:
        return OFF
    if parent is None:
        st = _stack()
        parent = st[-1] if st else None
    return Span(name, parent if parent is not OFF else None,
                DIR is not None, attrs)


class _Under:
    __slots__ = ("parent",)

    def __init__(self, parent):
        self.parent = parent

    def __enter__(self):
        _stack().append(self.parent)
        return self.parent

    def __exit__(self, *exc):
        st = _stack()
        if self.parent in st:
            st.remove(self.parent)
        return False


def under(parent):
    """Make ``parent``, a span opened on another thread, this thread's
    parent for the spans opened inside the ``with``; it is not ended."""
    return OFF if parent is OFF else _Under(parent)


def set_role(role: str) -> None:
    """Name the process in its file's header (cli, server, multihost)."""
    _role[0] = role


def records() -> list:
    """The finished spans as the file's lines hold them."""
    return [{"name": s.name, "id": s.id,
             "parent": s.up.id if s.up is not None else 0,
             "t0": s.t0, "t1": s.t1, "thread": s.thread, "attrs": s.attrs}
            for s in list(_records)]


def write() -> None:
    """Write this process's spans to ``DIR/spans.<pid>.jsonl``."""
    if DIR is None or os.getpid() != _pid:
        return
    os.makedirs(DIR, exist_ok=True)
    with open(os.path.join(DIR, f"spans.{_pid}.jsonl"), "w") as f:
        f.write(json.dumps({"pid": _pid, "role": _role[0],
                            "clock": CLOCK}) + "\n")
        for r in records():
            f.write(json.dumps(r) + "\n")


def _forked() -> None:
    global DIR
    DIR = None
    _records.clear()


if DIR is not None:
    atexit.register(write)
    os.register_at_fork(after_in_child=_forked)
