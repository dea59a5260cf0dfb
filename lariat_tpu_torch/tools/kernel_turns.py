"""K1, K2, K2b, K3, T1, K4a, K4b, K4c, K9, the SA lookup (K5), K7 and the
align step's extension timed on the card, to compare two trees of the port in
one call, in turns (parent, new, new, parent):

    git archive <parent> lariat_tpu_torch | tar -x -C build/parent
    for t in build/parent . . build/parent; do
      PYTHONPATH=$t python3 lariat_tpu_torch/tools/kernel_turns.py \\
          <genome.fa> <reads.fastq.gz> \\
          [k1,k2,k2b,k3,t1,launch,k4a,k4b,k4c,k9,lookup,k7,step]
    done

The third argument picks the sections (all by default). A tuning variant
is one more tree, a copy of the package with one string of one file
replaced (it must occur exactly once there):

    python3 lariat_tpu_torch/tools/kernel_turns.py variant build/var/c32 \\
        csrc/traceback.cu 'kWinCols = 64;' 'kWinCols = 32;'

Run by its path, the script times the ``lariat_tpu_torch`` that PYTHONPATH
puts first, through entry points that every tree of the port has had since
device seeding came in:
- K1, ``sw_extend.extend_batch``, on chip_smoke.py phase 3's inputs
  (``k1_inputs``: 8192 x 192 x 576, seed 1), checked against its twin;
- K2, ``sw_global.global_batch``, on ``k2_inputs`` (2,048 x 192 x 384),
  checked against its twin;
- K3, ``sw_local.local_batch``, at chip_smoke.py phase 3's rescue-wave shape
  (``k3_inputs``: 4,096 x 192 x 704, qlen 151, tlen 686, minsc 19),
  checked against its twin;
- T1, ``extend_ablate.run_variant``, its baseline and its three single
  ablations (no_cummax, no_trow, no_writeback) on planted tasks of
  chip_smoke.py phase 3's T1 shape (``t1_inputs``: 8192 x 192 x 576, seed
  2), each checked against its twin, in device time alone
  (``events_ms``);
- the launch path's host cost: ``sw_local.local_batch`` on 32 tasks of 64
  x 128 (a kernel of a few us, so the host's work leads), in us a call
  from one thread and from 20 threads at once, as the CLI's priming
  threads call it (``launch_us``; the GIL held by the others included);
- K4a, ``smem_device.min_starts_twoptr``, at round 1's phase-A budget (3L)
  on the first 4,096 reads of the FASTQ (``seed_batch``), checked against
  its twin, with the transitions of its longest lane (flags bits 2+);
- K4c, ``smem_device.strategy1``, on the same reads at the collect's
  max_intv, min_len and cap, checked against its twin;
- K9, ``smem_device.compact_starts`` and ``compact_starts_packed``, on
  round 1's planes of those reads (K4a's planes entry at 8L; start 0, mid
  L + 2, min_seed 19, cap 32) in int32 and int64 indices, checked against
  its twins; besides the medians, its device time as a spun single call
  (``events_ms``) and as the mean of 200 back-to-back calls replayed
  from a CUDA graph (``backtoback_ms``), and what one call enqueues on
  the card, by kernel, with each kernel's device time (``device_split``,
  torch.profiler);
- K2b, ``sw_global.traceback_ops_fused``, on K2's z of chip_smoke.py
  phase 3's reg2aln chunk (``k2_inputs``: 2,048 x 192 x 384, S 576),
  checked against its twin; in device time also with a cold L2, over the
  first quarter of the tasks, and with no walk (tlen 0);
- K4b, ``smem_device.min_starts_kernel``, over every (read, e) lane of
  those reads (786,432 at L 192, min_intv 1, as the collect's fallback
  runs it), checked against its twin; in device time also over the first
  half of the lanes and with a cold L2 (256 MB read between calls);
- the SA lookup, ``align_step.sa_lookup_batch_host``, on chip_smoke.py
  phase 5's 65,536 random rows (seed 3), checked against the positions of
  the twin's walk;
- K7, ``fm_batch.backward_search``, on the seed suffixes of the align
  step's 8,192 x 151 reads (``device_step.step_reads``; lens 151, so the
  seed mask changes no base and both trees search the same bases),
  checked against its twin; in device time also with a cold L2;
- the align step's extension: each tree's path from the step's hits (K7,
  K5's lookup entry, the forward projection) to its scores -- K8, the
  orientation and K1's tile entry where the tree has no
  ``sw_extend.extend_step``, else that one launch -- checked against the
  twins; and ``align_step`` whole, with its parts (``StepClock``, median of
  21 calls of each part's CUDA-event ms).
Each time is the median of 21 calls (CUDA events around the call, its host
time included), taken three times; K2b, K4a, K4b, K4c, K9, K7 and the
step's extension also once in device time alone (``events_ms``). Prints the
card and, last, one JSON line. chip_smoke.py builds its K1 and seeding
inputs with the same functions; ``sa_walks.py`` times K5 alone.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

import numpy as np


def planted(rng, qlen, tlen, Lq, Lt, n_frac=0.01):
    """Random queries planted in random targets (2% substitutions, n_frac
    N codes) for the given lengths, as numpy arrays (q, t)."""
    B = len(qlen)
    q = rng.integers(0, 4, (B, Lq)).astype(np.uint8)
    t = rng.integers(0, 4, (B, Lt)).astype(np.uint8)
    for b in range(B):
        n = int(min(qlen[b], tlen[b]))
        off = int(rng.integers(0, max(1, int(tlen[b]) - n + 1)))
        t[b, off:off + n] = q[b, :n]
    mut = rng.random((B, Lt)) < 0.02
    t[mut] = (t[mut] + 1) % 4
    q[rng.random((B, Lq)) < n_frac] = 4
    t[rng.random((B, Lt)) < n_frac] = 4
    return q, t


def k1_inputs(rng, B=8192, Lq=192, Lt=576):
    """K1 at the production extend tier: mixed lengths (qlen 0-151, tlen up
    to qlen + 299), 64 tasks with qlen 0 and 64 with tlen 0, w 100, h0
    19-151, planted targets -> (q, qlen, t, tlen, w, h0) numpy arrays."""
    qlen = rng.integers(0, 152, B).astype(np.int32)
    tlen = np.minimum(qlen + rng.integers(0, 300, B), Lt).astype(np.int32)
    qlen[:64], tlen[64:128] = 0, 0
    q, t = planted(rng, qlen, tlen, Lq, Lt)
    w = np.full(B, 100, np.int32)
    h0 = rng.integers(19, 152, B).astype(np.int32)
    return q, qlen, t, tlen, w, h0


def t1_inputs(rng, B=8192, Lq=192, Lt=576, qmax=151):
    """T1 at K1's production tier, planted: qlen 0-qmax (64 tasks 0), tlen
    up to qlen + 449 (64 tasks 0), w 100, h0 19-151 -> (q, t, params)
    numpy arrays, params' rows qlen, tlen, w, h0."""
    qlen = rng.integers(0, qmax + 1, B).astype(np.int32)
    tlen = np.minimum(qlen + rng.integers(0, 450, B), Lt).astype(np.int32)
    qlen[:64], tlen[64:128] = 0, 0
    q, t = planted(rng, qlen, tlen, Lq, Lt)
    params = np.zeros((B, 8), np.int32)
    params[:, 0], params[:, 1], params[:, 2] = qlen, tlen, 100
    params[:, 3] = rng.integers(19, 152, B)
    return q, t, params


def k2_inputs(rng, B=2048, Lq=192, Lt=384):
    """K2 and K2b at the reg2aln chunk: qlen 30-151, tlen qlen +- 10, w at
    least |qlen - tlen| (1-59), planted targets -> (q, qlen, t, tlen, w)
    numpy arrays. chip_smoke.py phase 3 draws them from its rng (seed 1)
    after ``k1_inputs``."""
    qlen = rng.integers(30, 152, B).astype(np.int32)
    tlen = np.clip(qlen + rng.integers(-10, 11, B), 1, Lt).astype(np.int32)
    q, t = planted(rng, qlen, tlen, Lq, Lt)
    w = np.maximum(np.abs(qlen - tlen),
                   rng.integers(1, 60, B)).astype(np.int32)
    return q, qlen, t, tlen, w


def k3_inputs(rng, B=4096, Lq=192, Lt=704, ql=151, tl=686):
    """K3 at a rescue wave: reads of 151 (Lq 192) in the pestat window
    high - low + 151 = 686 (Lt 704), planted, minsc 19 -> (q, qlen, t,
    tlen, minsc) numpy arrays."""
    qlen = np.full(B, ql, np.int32)
    tlen = np.full(B, tl, np.int32)
    q, t = planted(rng, qlen, tlen, Lq, Lt)
    return q, qlen, t, tlen, np.full(B, 19, np.int32)


def launch_us(fn, threads: int, n: int, sync=lambda: None) -> float:
    """Wall us a call of ``fn`` when ``threads`` threads each call it ``n``
    times at once (after one warm call), ``sync`` closing the run."""
    fn()
    sync()
    ready = threading.Barrier(threads + 1)

    def work():
        ready.wait()
        for _ in range(n):
            fn()

    ts = [threading.Thread(target=work) for _ in range(threads)]
    for t in ts:
        t.start()
    ready.wait()
    t0 = time.perf_counter()
    for t in ts:
        t.join()
    sync()
    return (time.perf_counter() - t0) * 1e6 / (threads * n)


def seed_batch(reads_path, n):
    """The first n reads (read 1 and read 2 of each pair, in file order) of
    a barcode-grouped FASTQ as one seeding batch -> (codes (R, L) uint8
    padded with N to a multiple of 64, lens (R,) int32, the reads' codes)."""
    from lariat_tpu_torch.align.engine import encode_read
    from lariat_tpu_torch.io.fastq import FastQReader
    reader = FastQReader(reads_path)
    seqs = []
    while len(seqs) < n:
        recs, _ = reader.read_barcode_set(0)
        if recs is None:
            break
        seqs += [s for r in recs for s in (r.read1, r.read2)]
    qs = [encode_read(s) for s in seqs[:n]]
    L = -(-max(len(q) for q in qs) // 64) * 64
    rmat = np.full((len(qs), L), 4, np.uint8)
    lens = np.zeros(len(qs), np.int32)
    for i, q in enumerate(qs):
        rmat[i, :len(q)] = q
        lens[i] = len(q)
    return rmat, lens, qs


def lookup_rows(seq_len, n=1 << 16, seed=3):
    """chip_smoke.py phase 5's SA lookup rows: n random BWT rows."""
    return np.random.default_rng(seed).integers(0, seq_len, n)


def events_ms(fn, prep=None, n=21):
    """Median device ms of ``n`` calls of ``fn`` between CUDA events, after
    one warm call. Before each call ``prep`` (an L2 flush) runs, then a
    0.1 ms spin of the card, both outside the events: the host enqueues the
    launch while the card spins, so the wrapper's host time is not
    counted (for a ``fn`` that syncs, its host time still is)."""
    import torch
    fn()
    times = []
    for _ in range(n):
        if prep is not None:
            prep()
        torch.cuda._sleep(200_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def backtoback_ms(fn, n=200):
    """Mean device ms of ``n`` calls of ``fn`` back to back: the calls are
    captured in one CUDA graph (``fn`` must not wait for the card), which
    replays between two CUDA events, so no host time falls between them;
    the median of five replays."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
    del g
    times.sort()
    return times[2]


def short_kernel_name(name: str) -> str:
    """A profiler event's name without its signature: "void (anonymous
    namespace)::twoptr_kernel<int>(...)" -> "twoptr_kernel", "Memcpy DtoH
    (Device -> Pageable)" -> "Memcpy DtoH"."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].strip().removeprefix("void ")


def device_split(fn, n=20):
    """What one call of ``fn`` runs on the card, from torch.profiler over
    ``n`` calls after a warm one: {kernel or memset name: [launches a call,
    mean device us a launch]}; {} when the profiler saw no device work."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    acc: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            c = acc.setdefault(short_kernel_name(e.name), [0, 0.0])
            c[0] += 1
            c[1] += e.time_range.elapsed_us()
    return {k: [c / n, us / c] for k, (c, us) in sorted(acc.items())}


SECTIONS = ("k1", "k2", "k2b", "k3", "t1", "launch", "k4a", "k4b", "k4c", "k9", "lookup", "k7", "step")


def make_variant(dest, rel, old, new) -> str:
    """Copy this tree's package to ``dest``/lariat_tpu_torch with ``old``
    replaced by ``new`` in its file ``rel``; returns the copy's path."""
    import shutil
    import lariat_tpu_torch
    src = os.path.dirname(os.path.abspath(lariat_tpu_torch.__file__))
    pkg = os.path.join(dest, "lariat_tpu_torch")
    shutil.rmtree(pkg, ignore_errors=True)
    shutil.copytree(src, pkg, ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(pkg, rel)
    with open(path) as f:
        text = f.read()
    if text.count(old) != 1:
        raise SystemExit(f"{rel}: {old!r} occurs {text.count(old)} times")
    with open(path, "w") as f:
        f.write(text.replace(old, new))
    return pkg


def main(argv=None) -> int:
    import torch
    from lariat_tpu_torch.cli import load_reference
    from lariat_tpu_torch.ops import fm_batch, smem_device as sd
    from lariat_tpu_torch.ops import sw_batch, sw_extend, sw_global, sw_local
    from lariat_tpu_torch.parallel import align_step
    from lariat_tpu_torch.tools import card, median_ms
    import lariat_tpu_torch
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["variant"] and len(argv) == 5:
        print(make_variant(*argv[1:]))
        return 0
    if len(argv) not in (2, 3):
        raise SystemExit("usage: kernel_turns.py <genome.fa> "
                         "<reads.fastq.gz> [k1,k2,k2b,k3,t1,launch,k4a,k4b,"
                         "k4c,k9,lookup,k7,step]")
    want_s = set(argv[2].split(",")) if len(argv) == 3 else set(SECTIONS)
    if not want_s <= set(SECTIONS):
        raise SystemExit(f"sections: {sorted(want_s - set(SECTIONS))}?")
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_turns needs CUDA")
    dev = torch.device("cuda")
    out = {"package": os.path.dirname(os.path.abspath(
        lariat_tpu_torch.__file__)), "card": card(dev)}
    print(out["card"], flush=True)

    def put(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    def medians(fn):
        return [median_ms(fn, dev, 21) for _ in range(3)]

    def err(got, want):
        return max(int((a.long() - b.long()).abs().max())
                   for a, b in zip(got, want))

    flush = torch.ones(1 << 26, dtype=torch.int32, device=dev)  # 256 MB
    rng = np.random.default_rng(1)
    q, qlen, t, tlen, w, h0 = (put(a) for a in k1_inputs(rng))
    ext = dict(o_del=6, e_del=1, o_ins=6, e_ins=1, end_bonus=5, zdrop=100)

    def k1():
        return sw_extend.extend_batch(q, qlen, t, tlen, w, h0, **ext)

    if "k1" in want_s:
        got = k1()
        want = sw_batch.extend_batch(q, qlen, t, tlen,
                                     sw_extend.score_matrix(1, -4, -1, dev),
                                     w, h0, packed=True, **ext)
        out["k1_max_abs_err"] = int((got[:6].long() - want.long()).abs()
                                    .max())
        out["k1_ms"] = medians(k1)

    if want_s & {"k2", "k2b"}:
        q2, ql2, t2, tl2, w2 = (put(a) for a in k2_inputs(rng))
        S = q2.shape[1] + t2.shape[1]
        score, z = sw_global.global_batch(q2, ql2, t2, tl2, w2)

    if "k2" in want_s:
        out["k2_max_abs_err"] = err(
            [score, z], sw_global.global_batch_plain(q2, ql2, t2, tl2, w2))
        out["k2_ms"] = medians(
            lambda: sw_global.global_batch(q2, ql2, t2, tl2, w2))

    if "k2b" in want_s:

        def k2b():
            return sw_global.traceback_ops_fused(z, ql2, tl2, w2, score, S)

        out["k2b_max_abs_err"] = err([k2b()], [
            sw_global.traceback_ops_fused_plain(z, ql2, tl2, w2, score, S)])
        out["k2b_tasks"] = [int(z.shape[0]), S]
        out["k2b_ms"] = medians(k2b)
        out["k2b_dev_ms"] = events_ms(k2b)
        out["k2b_cold_dev_ms"] = events_ms(k2b, prep=lambda: flush.max())
        # a quarter of the tasks (the longest walk stays about as long),
        # and the launch with no walk (tlen 0: the fill and the blob rows)
        n4 = int(z.shape[0]) // 4
        out["k2b_quarter_dev_ms"] = events_ms(
            lambda: sw_global.traceback_ops_fused(
                z[:n4], ql2[:n4], tl2[:n4], w2[:n4], score[:n4], S))
        tl0 = torch.zeros_like(tl2)
        out["k2b_nowalk_dev_ms"] = events_ms(
            lambda: sw_global.traceback_ops_fused(z, ql2, tl0, w2, score, S))

    if "k3" in want_s:
        q3, ql3, t3, tl3, m3 = (put(a) for a in k3_inputs(
            np.random.default_rng(3)))
        out["k3_max_abs_err"] = err(
            [sw_local.local_batch(q3, ql3, t3, tl3, m3)],
            [sw_local.local_batch_plain(q3, ql3, t3, tl3, m3)])
        out["k3_ms"] = medians(
            lambda: sw_local.local_batch(q3, ql3, t3, tl3, m3))

    if "t1" in want_s:
        from lariat_tpu_torch.ops import extend_ablate
        tq, tt, tp = (put(a) for a in t1_inputs(np.random.default_rng(2)))
        Lt1 = tt.shape[1]
        out["t1_max_abs_err"] = 0
        for name in ("baseline", "no_cummax", "no_trow", "no_writeback"):
            kw = extend_ablate.VARIANTS[name][1]

            def t1():
                return extend_ablate.run_variant(tq, tt, tp, Lt1, **kw)

            out["t1_max_abs_err"] = max(out["t1_max_abs_err"], err(
                [t1()], [extend_ablate.run_variant_plain(tq, tt, tp, Lt1,
                                                         **kw)]))
            out[f"t1_{name}_dev_ms"] = [events_ms(t1) for _ in range(3)]

    if "launch" in want_s:
        small = [put(a) for a in k3_inputs(np.random.default_rng(4), B=32,
                                           Lq=64, Lt=128, ql=60, tl=120)]

        def one():
            return sw_local.local_batch(*small)

        out["launch_us"] = {
            str(k): [launch_us(one, k, 2000 // k,
                               lambda: torch.cuda.synchronize(dev))
                     for _ in range(3)] for k in (1, 20)}

    if not want_s & {"k4a", "k4b", "k4c", "k9", "lookup", "k7", "step"}:
        return _finish(out)
    fm = load_reference(argv[0])
    fmd = fm_batch.DeviceFMIndex.from_host(fm, dev)
    if want_s & {"k7", "step"}:
        _step_sections(out, want_s, fm, fmd, dev, medians,
                       lambda: flush.max())
    if not want_s & {"k4a", "k4b", "k4c", "k9", "lookup"}:
        return _finish(out)
    rmat, lens, _ = seed_batch(argv[1], 4096)
    R, L = rmat.shape
    args = (fmd, put(rmat), put(np.zeros(R), np.int32), put(lens),
            put(np.ones(R), np.int64), L)
    mid = put(np.full(R, L + 2), np.int32)

    def k4a():
        return sd.min_starts_twoptr(*args, max_steps=3 * L, min_seed=19,
                                    cap=sd.CAP1, mid=mid)

    if "k4a" in want_s:
        meta, big = k4a()[:2]   # newer trees also return the lanes' aux
        pm, pb, aux = sd.min_starts_twoptr_plain(
            *args[:5], mid, L, sd._budget(3 * L), False, 19, sd.CAP1)
        sd._twoptr_flags(pm, aux, sd.CAP1)
        out["k4a_max_abs_err"] = err((meta, big), (pm, pb))
        out["k4a_reads"] = [R, L]
        out["k4a_transitions_max"] = int(meta[0, -1]) >> 2
        out["k4a_ms"] = medians(k4a)
        out["k4a_dev_ms"] = events_ms(k4a)

    if "k4b" in want_s:
        ri = put(np.repeat(np.arange(R), L), np.int32)
        ee = put(np.tile(np.arange(1, L + 1), R), np.int32)
        mi = put(np.ones(R * L), np.int64)
        half = R * L // 2

        def k4b(n=R * L):
            return sd.min_starts_kernel(fmd, args[1], ri[:n], ee[:n], mi[:n],
                                        L)

        out["k4b_max_abs_err"] = err(k4b(), sd.min_starts_kernel_plain(
            fmd, args[1], ri, ee, mi, L))
        out["k4b_lanes"] = R * L
        out["k4b_ms"] = medians(k4b)
        out["k4b_dev_ms"] = events_ms(k4b)
        out["k4b_half_dev_ms"] = events_ms(lambda: k4b(half))
        out["k4b_cold_dev_ms"] = events_ms(k4b, prep=lambda: flush.max())

    s1 = (fmd, args[1], args[3], 20, L, 19, L // 19 + 2)

    def k4c():
        return sd.strategy1(*s1)

    if "k4c" in want_s:
        out["k4c_max_abs_err"] = err(k4c(),
                                     sd.pack_r3(*sd.strategy1_plain(*s1)))
        out["k4c_ms"] = medians(k4c)
        out["k4c_dev_ms"] = events_ms(k4c)

    if "k9" in want_s:
        _k9_section(out, fmd, args, mid, medians, err)

    if "lookup" in want_s:
        g = align_step.DeviceGenome.from_host(fm, fmd)
        rows = lookup_rows(fm.seq_len)

        def lookup():
            return align_step.sa_lookup_batch_host(g, fm, rows)

        kd = torch.from_numpy(rows).to(dev, fmd.idx_dtype)
        zk = torch.zeros_like(kd)
        walk = align_step.sa_walk_chunk_plain(g, kd, zk, zk.bool(),
                                              512).cpu()
        want = (np.asarray(fm.sa_samples)[(walk[0].numpy() // fm.sa_intv)
                                          .astype(np.int64)]
                + walk[1].numpy().astype(np.int64))
        out["lookup_max_abs_err"] = int(np.abs(lookup() - want).max())
        out["lookup_rows"] = len(rows)
        out["lookup_ms"] = medians(lookup)
    return _finish(out)


def _k9_section(out, fmd, args, mid, medians, err) -> None:
    """K9 on round 1's planes (K4a's planes entry at 8L) in int32 and int64
    indices, both layouts, cap 32, min_seed 19: checked against the twins,
    then the medians, ``events_ms``, ``backtoback_ms`` and
    ``device_split`` of each call."""
    import torch
    from lariat_tpu_torch.ops import fm_batch, smem_device as sd
    _, rd, start, lens, mi, L = args
    fmd64 = fm_batch.DeviceFMIndex(fmd.fused, fmd.L2.long(), fmd.primary,
                                   fmd.seq_len)
    for tag, f in (("int32", fmd), ("int64", fmd64)):
        b, x0, x1, s, v, done = sd.min_starts_twoptr_planes(
            f, rd, start, lens, mi, L, max_steps=8 * L)[:6]
        a = (b, x0, x1, s, v, start, lens, mid)
        calls = {"slots": (lambda: sd.compact_starts(*a, 19, 32),
                           lambda: sd.compact_starts_plain(*a, 19, 32)),
                 "packed": (lambda: [sd.compact_starts_packed(
                     *a, done, 19, 32)], lambda: [
                         sd.compact_starts_packed_plain(*a, done, 19, 32)])}
        for lay, (fn, twin) in calls.items():
            key = f"k9_{tag}_{lay}"
            out[key + "_max_abs_err"] = err(fn(), twin())
            out[key + "_ms"] = medians(fn)
            out[key + "_dev_ms"] = events_ms(fn)
            out[key + "_b2b_ms"] = backtoback_ms(fn)
            out[key + "_split"] = device_split(fn)
        out[f"k9_{tag}_seeds"] = int(sd.compact_starts(*a, 19, 32)[5]
                                     .long().sum())
        out["k9_lanes"] = [int(b.shape[0]), L]
        del b, x0, x1, s, v
        torch.cuda.empty_cache()


def _step_sections(out, want_s, fm, fmd, dev, medians, flush) -> None:
    """The ``k7`` and ``step`` sections at the align step's shape; ``flush``
    evicts the L2 (K7's cold variant)."""
    import torch
    from lariat_tpu_torch.align.ksw import fill_score_matrix
    from lariat_tpu_torch.ops import fm_batch, sw_extend
    from lariat_tpu_torch.parallel import align_step as st
    from lariat_tpu_torch.tools.device_step import step_reads
    reads_np, _ = step_reads(fm, 8192, 151)
    B, L = reads_np.shape
    rd = torch.from_numpy(reads_np).to(dev)
    lens = torch.full((B,), L, dtype=torch.int32, device=dev)
    s0 = torch.clamp(lens - 32, min=0)
    k7 = (fmd, rd, lens, s0, 32, True)

    def err(got, want):
        return max(int((a.long() - b.long()).abs().max())
                   for a, b in zip(got, want))

    if "k7" in want_s:
        out["k7_max_abs_err"] = err(fm_batch.backward_search(*k7),
                                    fm_batch.backward_search_plain(*k7))
        out["k7_reads"] = [B, L, 32]
        out["k7_ms"] = medians(lambda: fm_batch.backward_search(*k7))
        out["k7_dev_ms"] = events_ms(lambda: fm_batch.backward_search(*k7))
        out["k7_cold_dev_ms"] = events_ms(
            lambda: fm_batch.backward_search(*k7), prep=flush)
    if "step" not in want_s:
        return
    g = st.DeviceGenome.from_host(fm, fmd)
    k, l = fm_batch.backward_search(*k7)
    pos = st.sa_lookup_batch(g, torch.where(k <= l, k, 0))
    dstart = pos - s0.long()
    isr = pos >= g.l_pac
    fwd = torch.where(isr, 2 * g.l_pac - dstart - lens.long(), dstart)
    W = 32
    sc = dict(match_sc=1, mismatch_sc=-4, n_sc=-1, **st.STEP_SCORING)
    full = [torch.full((B,), v, dtype=torch.int32, device=dev)
            for v in (L + W, W, st.STEP_H0)]
    if hasattr(sw_extend, "extend_step"):
        out["step_path"] = "extend_step"

        def tail():
            return sw_extend.extend_step(rd, lens, fwd, isr, g.pac(),
                                         g.l_pac, W, h0=st.STEP_H0, **sc)
    else:
        out["step_path"] = "fetch_window + orientation + extend_batch"

        def tail():
            t = st.fetch_window_batch(g, fwd, L + W)
            idx = torch.arange(L, device=dev)[None, :]
            ln = lens.long()[:, None]
            rc = rd.gather(1, torch.clamp(ln - 1 - idx, 0, L - 1)).long()
            revcomp = torch.where(idx < ln, torch.where(rc < 4, 3 - rc, 4), 4)
            q = torch.where(isr[:, None], revcomp, rd.long()).to(torch.uint8)
            return sw_extend.extend_batch(q, lens, t, *full, **sc)

    mat = fill_score_matrix(1, 4)
    want = st.align_step(g, rd, lens, mat, plain=True)
    out["step_max_abs_err"] = max(
        err([tail()[0]], [want.score]),
        err(st.align_step(g, rd, lens, mat), want))
    out["step_tail_ms"] = medians(tail)
    out["step_tail_dev_ms"] = events_ms(tail)
    out["align_step_ms"] = medians(lambda: st.align_step(g, rd, lens, mat))
    out["align_step_dev_ms"] = events_ms(
        lambda: st.align_step(g, rd, lens, mat))
    parts = {}
    for _ in range(21):
        clock = st.StepClock(dev)
        st.align_step(g, rd, lens, mat, clock=clock)
        for name, ms in clock.ms().items():
            parts.setdefault(name, []).append(ms)
    out["align_step_parts_ms"] = {n: sorted(v)[len(v) // 2]
                                  for n, v in parts.items()}


def _finish(out) -> int:
    print(json.dumps(out), flush=True)
    errs = [out[k] for k in out if k.endswith("max_abs_err")]
    return 0 if not any(errs) else 1


if __name__ == "__main__":
    sys.exit(main())
