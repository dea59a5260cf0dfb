"""Runs one of the port's entry modules in this process, as ``python -m``
would, and writes what the harness reads of it to a side file.

    python benchmark/launch.py --side SIDE.json [--trace-at engine] \\
        --module lariat_tpu_torch.cli -- ARGS...

- It prints ``[bench] module done rc=N`` the moment the module returns, so
  the harness's clock closes the window there and not after the work
  below.
- With ``--trace-at`` it starts ``torch.profiler`` (CUDA activity only)
  at the first call of one of the port's functions: ``engine``, the
  priming engine's constructor (in the CLI after the worker pool forked
  and before the window opens, so the profiler's own start-up falls in
  set-up); ``reset``, ``_build.reset_launches`` (in the resident server
  after its prewarm). The trace ends when the module returns. The side
  file then holds the device's busy intervals (every kernel, copy and
  set, merged, on the host's wall clock, each with the index in ``names``
  of the last operation in it), each operation's device time and count,
  and the profiler's own start and stop.
- The side file also names every loaded module whose top-level name is
  ``jax``, ``jaxlib``, ``flax`` or ``lariat_tpu``; the harness fails the
  run on any.
- It holds ``cpu_s`` too: the user and system seconds of this process
  and of every child it reaped (the CLI's workers), read the moment the
  module returns.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import runpy
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "lariat_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Trace:
    """``torch.profiler`` over the CUDA activity of this process."""

    def __init__(self):
        self.prof = self.error = None
        self.t_start = self.t_stop = None

    def start(self) -> None:
        """Starts once; a profiler that cannot start is recorded, and the
        module runs on untraced. Without CUDA (rehearsals on the CPU) it
        traces the CPU, so no device events come."""
        if self.prof is not None or self.error is not None:
            return
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
            act = (ProfilerActivity.CUDA if torch.cuda.is_available()
                   else ProfilerActivity.CPU)
            self.prof = profile(activities=[act])
            self.prof.start()
            self.t_start = time.time()
        except Exception as e:  # noqa: BLE001 -- reported in the side file
            self.prof, self.error = None, repr(e)

    def stop(self) -> dict:
        if self.prof is None:
            return {"started": False, "error": self.error}
        self.prof.stop()
        self.t_stop = time.time()
        return self.reduce()

    def reduce(self) -> dict:
        events = []
        for e in self.prof.profiler.kineto_results.events():
            if "CUDA" not in str(e.device_type()):
                continue
            s = int(e.start_ns()) if hasattr(e, "start_ns") \
                else int(e.start_us()) * 1000
            d = int(e.duration_ns()) if hasattr(e, "duration_ns") \
                else int(e.duration_us()) * 1000
            events.append((s, s + max(d, 0), e.name()))
        events.sort()
        merged, kernels = [], {}
        for s, t, name in events:
            k = kernels.setdefault(name, [0, 0])
            k[0] += t - s
            k[1] += 1
            if merged and s <= merged[-1][1]:
                if t > merged[-1][1]:
                    merged[-1][1], merged[-1][2] = t, name
            else:
                merged.append([s, t, name])
        names = sorted(kernels)
        at = {n: i for i, n in enumerate(names)}
        return {"started": True, "t_start": self.t_start,
                "t_stop": self.t_stop, "device_events": len(events),
                "names": names,
                "intervals": [[s / 1e9, t / 1e9, at[n]]
                              for s, t, n in merged],
                "kernels": {n: [v[0] / 1e9, v[1]]
                            for n, v in kernels.items()}}


# where the trace starts: (module, attribute, method or None, start
# before the call)
TRACE_AT = {
    "engine": ("lariat_tpu_torch.align.batch_engine",
               "TorchBatchAlignmentEngine", "__init__", True),
    "reset": ("lariat_tpu_torch.ops._build", "reset_launches", None, False),
}


class _StartTrace:
    """An import hook that, once the port's module of ``TRACE_AT[at]`` has
    loaded, wraps its function so that the first call starts the trace.
    The port's own imports stay where they are, so the spans it prints
    (the server's ``set-up: imports``) keep their meaning."""

    def __init__(self, trace, at):
        self.trace = trace
        self.module, self.attr, self.method, self.before = TRACE_AT[at]

    def find_spec(self, name, path=None, target=None):
        if name != self.module:
            return None
        sys.meta_path.remove(self)
        import importlib.util
        spec = importlib.util.find_spec(name)
        exec_module, hook = spec.loader.exec_module, self

        def exec_and_wrap(module):
            exec_module(module)
            hook.wrap(module)
        spec.loader.exec_module = exec_and_wrap
        return spec

    def wrap(self, module):
        owner = getattr(module, self.attr) if self.method else module
        name = self.method or self.attr
        fn, trace, before = getattr(owner, name), self.trace, self.before

        def traced(*x, **k):
            if before:
                trace.start()
            r = fn(*x, **k)
            trace.start()
            return r
        setattr(owner, name, traced)


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--side", required=True)
    p.add_argument("--module", required=True)
    p.add_argument("--trace-at", choices=sorted(TRACE_AT), default=None,
                   help="start the profiler when the module first calls "
                        "this (engine: the priming engine's constructor; "
                        "reset: _build.reset_launches)")
    p.add_argument("args", nargs=argparse.REMAINDER)
    a = p.parse_args()
    args = a.args[1:] if a.args[:1] == ["--"] else a.args
    # the module sees the checkout, not this folder's modules
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [q for q in sys.path if os.path.abspath(q or ".") != here]
    trace = Trace()
    if a.trace_at:
        sys.meta_path.insert(0, _StartTrace(trace, a.trace_at))
    sys.argv = [a.module, *args]
    rc = 0
    try:
        runpy.run_module(a.module, run_name="__main__", alter_sys=True)
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else (0 if e.code is None
                                                       else 1)
    except Exception as e:  # noqa: BLE001 -- reported, then nonzero
        import traceback
        traceback.print_exc()
        print(f"[bench] module raised {e!r}", flush=True)
        rc = 1
    ru = [resource.getrusage(w) for w in (resource.RUSAGE_SELF,
                                          resource.RUSAGE_CHILDREN)]
    print(f"[bench] module done rc={rc}", flush=True)
    side = {"rc": rc, "t_done": time.time(),
            "cpu_s": sum(r.ru_utime + r.ru_stime for r in ru),
            "cpu_children_s": ru[1].ru_utime + ru[1].ru_stime}
    try:
        side["profile"] = trace.stop()
    except Exception as e:  # noqa: BLE001 -- the harness reports it
        side["profile"] = {"started": True, "error": repr(e)}
    side["forbidden"] = forbidden_modules()
    with open(a.side, "w") as f:
        json.dump(side, f)
    sys.stdout.flush()
    return rc


if __name__ == "__main__":
    sys.exit(main())
