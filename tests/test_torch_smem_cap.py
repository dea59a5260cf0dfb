"""A kernel's dynamic shared-memory cap is one per kernel and device,
shared by every host thread, and only ever rises.

The CLI primes on several threads at once, each wave of its own target
width. When each launch set the cap to its own need, a thread with a
narrow wave lowered it under another's wider launch in flight, which then
failed with cudaErrorInvalidValue ("invalid argument"): messy reads, whose
waves differ in width, made K1 fail so on the card. On the CPU: every
``cudaFuncSetAttribute`` of the sources goes through
``lariat::raise_smem_cap`` (csrc/common.cuh), which sets the cap only above
the largest one set, and ``emulate_caps`` replays its rule against the old
one. ``-m cuda``: eight threads launch K1, K2 and K3 with narrow and wide
targets at once, 200 times each, every result equal to the twin's.
"""

import os
import re
import threading

import numpy as np
import pytest
import torch

from lariat_tpu_torch.ops import sw_extend, sw_global, sw_local

from test_torch_sw_extend import _fuzz, _t, cuda_device  # noqa: F401

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "lariat_tpu_torch", "csrc")


def _sources():
    out = {}
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC, name)) as f:
                out[name] = f.read()
    return out


def test_every_shared_memory_cap_only_rises():
    """cudaFuncSetAttribute appears once, inside raise_smem_cap, behind the
    check that the new cap is above the last one set; every kernel that
    sets its cap (K1, T1, K2, K2b, K3, K4a, K4c) calls raise_smem_cap."""
    src = _sources()
    sets = {n: s.count("cudaFuncSetAttribute(") for n, s in src.items()}
    assert {n: c for n, c in sets.items() if c} == {"common.cuh": 1}
    body = src["common.cuh"][src["common.cuh"].index(
        "cudaError_t raise_smem_cap"):]
    body = body[:body.index("\n}\n")]
    assert re.search(r"if \(smem <= cap\) return cudaSuccess;", body)
    assert body.index("smem <= cap") < body.index("cudaFuncSetAttribute")
    assert "lock_guard" in body and "cudaGetDevice" in body
    users = sorted(n for n, s in src.items()
                   if "raise_smem_cap(" in s and n != "common.cuh")
    assert users == ["extend_ablate.cu", "smem.cu", "sw_extend.cu",
                     "sw_global.cu", "sw_local.cu", "traceback.cu"]


def emulate_caps(events, rising: bool):
    """Replay (thread, 'set' | 'launch', smem) events against one kernel's
    cap on the card (48 KB until first set): the launches that fail, as
    the card fails a launch asking for more than the cap. ``rising`` is
    raise_smem_cap's rule (set only above the largest set so far, the
    check and the set under one lock); else each set is the launch's own
    need, as before."""
    attr, known, failed = 48 * 1024, 0, []
    for i, (_, kind, smem) in enumerate(events):
        if kind == "set":
            if not rising:
                attr = smem
            elif smem > known:
                attr = known = smem
        elif smem > attr:
            failed.append(i)
    return failed


def test_cap_rule_survives_interleaved_threads():
    """Two threads' set-then-launch pairs, interleaved at random 200
    times: the old rule (each launch sets its own need) fails the
    wide launch whenever the narrow thread's set falls between the wide
    thread's set and launch; the rising cap fails none."""
    rng = np.random.default_rng(3)
    lost = 0
    for _ in range(200):
        widths = {"a": int(rng.integers(64, 4096)),
                  "b": int(rng.integers(64, 4096))}
        events = []
        pending = {t: [(t, "set", w), (t, "launch", w)] * 3
                   for t, w in widths.items()}
        while any(pending.values()):
            t = rng.choice([k for k, v in pending.items() if v])
            events.append(pending[t].pop(0))
        assert emulate_caps(events, rising=True) == []
        lost += bool(emulate_caps(events, rising=False))
    assert lost > 0


def _k1(Lt, seed):
    return _t(*_fuzz(seed, B=16, Lq=96, Lt=Lt))


def _k2(Lt, seed):
    qa, qlen, ta, tlen, w, _ = _fuzz(seed, B=16, Lq=96, Lt=Lt)
    return _t(qa, qlen, ta, np.minimum(tlen, qlen + w), w)


def _k3(Lt, seed):
    qa, qlen, ta, tlen, _, _ = _fuzz(seed, B=16, Lq=96, Lt=Lt)
    return _t(qa, qlen, ta, tlen, np.full(len(qlen), 19, np.int32))


CASES = {"K1": (_k1, sw_extend.extend_batch),
         "K2": (_k2, lambda *a: sw_global.global_batch(*a)[0]),
         "K3": (_k3, sw_local.local_two_pass)}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", sorted(CASES))
def test_threads_with_other_widths_launch(cuda_device, kernel):  # noqa: F811
    """Eight host threads, half with 128-row targets and half with
    2,048-row ones, each launching 200 times on a stream of its own
    without waiting: no launch fails, every result equals the twin's."""
    make, fn = CASES[kernel]
    inputs = {Lt: make(Lt, Lt) for Lt in (128, 2048)}
    want = {Lt: fn(*x).to(cuda_device) for Lt, x in inputs.items()}
    errors = []

    def worker(Lt):
        try:
            x = [a.to(cuda_device) for a in inputs[Lt]]
            stream = torch.cuda.Stream(cuda_device)
            with torch.cuda.stream(stream):
                outs = [fn(*x) for _ in range(200)]
            stream.synchronize()
            bad = sum(not torch.equal(o, want[Lt]) for o in outs)
            if bad:
                errors.append(f"Lt {Lt}: {bad} results differ from the twin")
        except RuntimeError as e:
            errors.append(f"Lt {Lt}: {e}")

    threads = [threading.Thread(target=worker, args=(Lt,))
               for Lt in (128, 2048) * 4]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
