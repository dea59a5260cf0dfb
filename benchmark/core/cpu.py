"""Host CPU time of a process tree, from Linux's accounting under
``/proc`` (read only).

A tree's CPU seconds are the user and system time of every live process
in it, each with what its reaped children spent (``cutime``/``cstime``).
Read once more after the tree's root has reaped all of its children, the
root's own ``getrusage`` of itself and its children gives the same total,
so the two readings bracket what the tree spent between them.
"""

from __future__ import annotations

import os

TICK = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100


def _stat(pid: int) -> list | None:
    """The fields of ``/proc/<pid>/stat`` after the command's name."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            s = f.read()
    except OSError:
        return None
    return s[s.rindex(")") + 2:].split()


def _parents() -> dict:
    """{pid: parent pid} of every live process."""
    out = {}
    for d in os.listdir("/proc"):
        if d.isdigit():
            f = _stat(int(d))
            if f is not None:
                out[int(d)] = int(f[1])
    return out


def tree_cpu_s(pid: int) -> float | None:
    """CPU seconds spent so far by ``pid`` and its descendants; None
    where ``/proc`` has no such process."""
    if _stat(pid) is None:
        return None
    parents = _parents()
    tree, todo = set(), [pid]
    while todo:
        p = todo.pop()
        tree.add(p)
        todo += [c for c, pp in parents.items() if pp == p and c not in tree]
    total = 0
    for p in tree:
        f = _stat(p)
        if f is not None:
            # utime, stime, cutime, cstime: fields 14-17 of stat(5)
            total += sum(int(x) for x in f[11:15])
    return total / TICK

