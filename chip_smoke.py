#!/usr/bin/env python3
"""Drive lariat_tpu_torch once on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases (one line each with its seconds, failures end the run nonzero):
  1. environment: the card (nvidia-smi name, power limit), torch, nvcc;
     requires torch.cuda.is_available();
  2. build: every kernel from lariat_tpu_torch/csrc with nvcc (sm_90a),
     ptxas's registers and spills, and each kernel's instructions, with
     its DPX, PRMT and POPC instructions, as `cuobjdump -sass` finds them;
  3. kernels: each kernel's wrapper on the card at main-path shapes against
     its plain PyTorch version on the same inputs, exact (tolerance 0:
     integer DP), with kernel and plain times (CUDA events, median of 7;
     T1's plain times median of 3) and the kernel's bound (the larger of
     its operations over the int32 peak and its bytes over the memory
     peak, both from the card's attributes; tools/kernel_roofline.py):
     K1-K3 (K1's rows run, warp steps and band cells printed), K2b on
     K2's z and on random z (walk steps and windows staged printed), K1,
     K3 and K2 (with K2b on its z) again on their edge shapes (the tiled path
     past 256 or 192 query columns, qlen 0, tlen 0, tlen < 32, qlen not a
     multiple of C, N codes, minsc 0; w 0, w >= qlen, rows past qlen + w;
     K1 also at zdrop 5, 0 and -1, z-drops at rows 0-3, h0 <= o_ins +
     e_ins), and T1 in all six variants at 8192 x 192 x 576 on planted
     inputs and on the ablation tool's random ones;
  4. data: a chr20-scale synthetic genome (tools/synth_genome.py --scale
     0.0208 --seed 7, ~64 Mbp), 10,000 read pairs of 151 bp
     (tools/sim_reads.py) and the index, under build/smoke/ (reused);
  5. seeding kernels: K4a-K4c and K5 on that index (fused occ table about
     1.0 M rows x 48 B) and 4,096 reads of the FASTQ against their twins,
     exact, with kernel and plain times (CUDA events, median of 7; the
     twins' median of 3): K4a at round 1's phase-A budget, at phase B's
     budget and at round 2, each in int32 and int64 indices, with its
     lanes' transition counts; K4b over every (read, e) lane in int32 and
     int64, with its extensions and rows fetched beside the distinct rows;
     K4c in int32 and int64; K5 as the SA lookup runs it (one launch of 512 steps over
     65,536 rows, int32 and int64) with its longest walk, beside its
     phase-1 shape (64 steps) and the whole lookup (sa_lookup_batch_host);
     K1's descriptor entry on a wave of 8,192 extensions of
     reads from that genome, against build_qt plus the twin; then the
     device collect (collect_seeds_rbegs_device) on 250 reads of the
     FASTQ and six low-complexity ones, which blow K4a's step cap, so it
     runs K4b: seeds and rbegs equal to the native C++ seeder's, with no
     SA sample uploaded; then, off every path, K4a's planes entry (round 1
     at an 8L budget, round 2 with bwd_init at 32L, int32 and int64) and K9
     on its planes (both layouts, round 1's mid L + 2 and round 2's mids,
     the collect's caps, caps that overflow and then L, whose flags must
     read 0) against their twins, exact, timed with their byte bounds (K9
     with its wrapper in both layouts and int64, in device time as a spun
     single call and as the mean of 200 back-to-back calls from a CUDA
     graph, with what one call enqueues -- K9 and at most one memset -- by
     torch.profiler; its twin, the stable argsort and gathers, is also its
     library yardstick: one timing under both names), one packed call
     captured in a CUDA graph and replayed, K9's round-1 slots against
     K4a's direct slots, and the launches of one planes-then-compaction
     pass;
 5b. align step on that index: K7 (the exact match on the reads as they
     are, the seed mask in the kernel; both N rules, int32 and int64, on
     reads with N, lens 0, under the seed length, L and past L + 31; its
     occ1 entry on rows around primary), K8 (the window fetch: negative
     starts, starts near and past l_pac, every in-word offset), K1's step
     entry (reverse hits, windows across 0 and l_pac, unmapped lanes, N)
     and K5's lookup entry (the samples added on the card) against their
     twins and the lookup against sa_lookup_batch_host, each timed at the
     step's shapes with its bound (K7 and the step entry also in device
     time alone; K7 with its longest chain and device us a step; the step
     entry beside K8 + orientation + the tile entry, the path it
     replaces); K7, K8 and the step entry again at positions and
     rows on both sides of 2^31 (int64; a rank table and a pac of 2.4e9
     bases made on the card, the text's halves complementary), and there
     too K4a's slots and planes entries (rounds 1 and 2), K9 on those
     planes, K4b, K4c, K5's walk and K1's descriptor entry, each kernel's
     fused rows (K9: kept x0, K1: target positions) below and above 2^31
     printed, both sides required; then align_step and align_step_smem at
     8,192 x 151 (launches counted over that run: every extension through
     the step entry, no K8 launch), every field equal to the same steps on
     the twins on the card (int32 and int64); then tools/device_step.py to
     a complete JSON line;
  6. host-native lariat_tpu (-use_device off -threads 8), a subprocess;
  7. the port (-use_device on -threads 8), a subprocess whose CLI resets
     the kernel launch counts before its main loop and prints them after,
     with the router's knobs set so that it has no reason to host-route
     (LARIAT_PRIME_THREADS at the run's most batches, a 600 s
     LARIAT_PRIME_TAIL_GRACE, LARIAT_PRIME_MIN_FRAC=0; printed);
  8. the port again with LARIAT_DEVICE_SEED=1 and the same knobs: seeding
     and its SA walks on the device (K4a, K4c, K5), each K5 launch logged
     (rows, max_steps, longest walk, walks past 64 steps), one launch a
     lookup;
 8b. the port at the router's defaults: its primed / host-routed split;
 8c. the port through the resident server (parallel/device_server.py) on
     the card: the server starts as a subprocess and writes its ready file
     after its build, upload and prewarm; the CLI primes through it
     (LARIAT_DEVICE_SOCKET) and must not initialise CUDA; the server stops
     on request, exits 0 and logs its kernel launches;
  9. tools: two measurement entry points as subprocesses -- the T1
     ablation at full size and the priming profile over 2,000 pairs of the
     data above, once with host and once with device seeding -- each to a
     complete final JSON line (the kernel roofline runs in the bench);
 10. checks: BAM records of the four port runs identical to host-native
     file for file; every pair primed in runs 7 and 8, primed plus
     host-routed pairs all the pairs and some primed in 8b and 8c; K1-K3
     and K2b launched in the server; every kernel launched on
     its own path (K1-K3 in the port run, K4a, K4c and K5 in the
     device-seeded run, K4b -- which runs only when K4a blows its step cap
     -- in phase 5's collect, T1 in the ablation tool, K7 in the align
     steps of phase 5b; K8, which no path launches since the steps stage
     their windows in K1's step entry, is only held against its twin; the
     planes entry and K9, off every path in the reference too, in phase
     5's pass);
 11. whole BAM: every BAM of the four port runs against host-native's as a
     whole file (lariat_tpu_torch/io/bamcompare.py): the decompressed
     streams equal with only the @PG CL field set to one value, every BGZF
     block past the header that covers the same stream range equal byte
     for byte, the EOF block; blocks and bytes compared printed per file;
 12. bench: python -m lariat_tpu_torch.tools.bench (the 4.6 Mb genome,
     320 x 100 pairs, 5 workers, host-native and device-primed through
     the resident server, a warm-up and the median of 3 each; the RFA row
     probe, the record diff rate, the roofline and the device step), its
     JSON line printed and held: both rates, primed pairs in the device
     median, a diff rate of 0, the torch rows in the probe, the device
     step present, the roofline's sections with every share of a peak in
     (0, 100%] and K6's bound (fm_rank), hg38 said skipped without
     data_big/, K1 (every launch through its descriptor entry), K2 and
     K2b launched in its server (K3's count printed: no rescue window
     survives on its proper pairs), K4b, K5 and K1 in its device step;
 13. probe and entry: python -m lariat_tpu_torch.tools.probe_device (launch
     latency, 8 MB transfers pageable and pinned, K1 at B 128 and 1,024,
     its twin at 1,024 and 8,192), its lines printed; then tools/entry.py's
     align_step_smem on the card (64 x 100, a 20 kb index), its launches
     counted (K4b, K5's lookup entry, K1's step entry), every field equal
     to the same step on the CPU.
Then each kernel's loss on its path (launches x (ms - bound ms)), a
kernels JSON line (each kernel's launches on its path, max abs
error, ms, plain ms, bound ms and what sets it, and library_ms: null where
no single PyTorch call computes the function -- these recurrences -- and
for K9 the stable argsort and gathers) and, last,
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SMOKE = os.path.join(REPO, "build", "smoke")
# chr20-scale genome of tools/gen_data_big.py; 10,000 pairs; 8 workers
SCALE, BARCODES, PAIRS_PER_BC, THREADS = 0.0208, 200, 50, 8

KERNEL_INFO = {   # name -> (source, the TPU kernel it replaces)
    "sw_extend": ("lariat_tpu_torch/csrc/sw_extend.cu",
                  "lariat_tpu/ops/sw_extend_pallas.py:50"),
    "sw_global": ("lariat_tpu_torch/csrc/sw_global.cu",
                  "lariat_tpu/ops/sw_global_pallas.py:40"),
    "traceback": ("lariat_tpu_torch/csrc/traceback.cu",
                  "lariat_tpu/ops/sw_global_pallas.py:295"),
    "sw_local": ("lariat_tpu_torch/csrc/sw_local.cu",
                 "lariat_tpu/ops/sw_local_pallas.py:49"),
    "extend_ablate": ("lariat_tpu_torch/csrc/extend_ablate.cu",
                      "tools/extend_ablate.py:49"),
    "smem_twoptr": ("lariat_tpu_torch/csrc/smem.cu",
                    "lariat_tpu/ops/smem_device.py:117"),
    "smem_exhaustive": ("lariat_tpu_torch/csrc/smem.cu",
                        "lariat_tpu/ops/smem_device.py:62"),
    "smem_strategy1": ("lariat_tpu_torch/csrc/smem.cu",
                       "lariat_tpu/ops/smem_device.py:465"),
    "sa_walk": ("lariat_tpu_torch/csrc/sa_walk.cu",
                "lariat_tpu/parallel/align_step.py:86"),
    "exact_match": ("lariat_tpu_torch/csrc/exact_match.cu",
                    "lariat_tpu/ops/fm_batch.py:366"),
    "fetch_window": ("lariat_tpu_torch/csrc/fetch_window.cu",
                     "lariat_tpu/parallel/align_step.py:156"),
    "smem_planes": ("lariat_tpu_torch/csrc/smem.cu",
                    "lariat_tpu/ops/smem_device.py:387"),
    "compact": ("lariat_tpu_torch/csrc/compact.cu",
                "lariat_tpu/ops/smem_device.py:391"),
}
CLI_KERNELS = ("sw_extend", "sw_global", "traceback", "sw_local")
SEED_KERNELS = ("smem_twoptr", "smem_strategy1", "sa_walk")
STEP_KERNELS = ("exact_match", "fetch_window")
# kernels that no path launches: K8 stays the port of the reference's
# fetch_window_batch, held against its twin in phase 5b, while the align
# steps stage their windows in K1's step entry (phase 5b checks 0 launches);
# K4a's planes entry and K9 are off every path in the reference too, and
# their launches are those of phase 5's planes-then-compaction pass
OFF_PATH = ("fetch_window", "smem_planes", "compact")
# the device align step's batch (bench.py's device step detail)
STEP_B, STEP_L = 8192, 151
PROFILE_PAIRS = 2000
SEED_READS = 4096
FALLBACK_READS = 250
# reads whose two-pointer lanes outrun K4a's step cap on a genome of this
# size (no exact copy of them in the synthetic genome)
LOW_COMPLEXITY = [b"A" * 151, b"AT" * 75, b"ACG" * 50, b"AC" * 75,
                  b"AAT" * 50, b"C" * 151]


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.time()
        print(f"[phase] {self.name} ...", flush=True)
        return self

    def __exit__(self, exc_type, exc, tb):
        status = "ok" if exc_type is None else "FAILED"
        print(f"[phase] {self.name}: {status} in "
              f"{time.time() - self.t0:.2f}s", flush=True)
        return False


def _run(cmd, timeout, log=None, env=None):
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                       timeout=timeout, env=env)
    if log:
        with open(log, "w") as f:
            f.write(f"$ {' '.join(cmd)}\n{r.stdout}\n--- stderr ---\n"
                    f"{r.stderr}")
    if r.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd[:4])} ... failed "
                           f"({r.returncode}):\n{r.stderr[-3000:]}")
    return r.stdout


def phase_environment():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no card listed")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()} python {sys.version.split()[0]}")
    from lariat_tpu_torch.ops import _build
    nv = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                        text=True, check=True, timeout=60).stdout
    print(nv.strip().splitlines()[-1])
    return smi


def phase_build():
    from lariat_tpu_torch.ops import _build
    out = _build.build(ptxas_report=True)
    for line in out.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    _build.load()
    print(f"  library {os.path.relpath(_build.library_path(), REPO)}")
    _sass_report(_build.library_path(), os.path.dirname(_build._nvcc()))


def _sass_report(lib, bin_dir):
    """Count, per kernel of the library, its sm_90a SASS instructions and
    among them the DPX (VI*), PRMT and POPC instructions."""
    tool = os.path.join(bin_dir, "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if tool is None:
        print("  sass: cuobjdump not found")
        return
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=120).stdout
    fn, counts = None, {}
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                     line)
        if fn and m:
            c = counts.setdefault(fn, {"total": 0})
            c["total"] += 1
            op = m.group(1)
            if op.startswith("VI") or op in ("PRMT", "POPC"):
                c[op] = c.get(op, 0) + 1
    for fn, c in counts.items():
        print(f"  sass {fn}: {json.dumps(dict(sorted(c.items())))}")


def _peaks():
    """int32 ops/s and bytes/s of the card, from its attributes."""
    from lariat_tpu_torch.ops import _build
    from lariat_tpu_torch.tools.kernel_roofline import peaks
    return peaks(_build.device_attributes(0))


def _bound(pk, ops, nbytes):
    """(ms, what sets it): the larger of ops over the int32 peak and bytes
    over the memory peak."""
    t_ops = ops / pk["int32_ops_s"] * 1e3
    t_bytes = nbytes / pk["mem_B_s"] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _band_cells(qlen, rows, w) -> int:
    from lariat_tpu_torch.tools.kernel_roofline import band_cells_batch
    return band_cells_batch(qlen, rows, w)


def _k1_steps(run, want, B) -> int:
    """The warp steps K1 ran over a batch, summed over its tasks: ``run``
    is a K1 entry given a (B,) int32 ``steps`` output, which the kernel
    fills; its result must equal ``want``."""
    import torch
    st = torch.full((B,), -1, dtype=torch.int32, device="cuda")
    got = run(st)
    torch.cuda.synchronize()
    if _max_abs_err(got, want) or int(st.min()) < 0:
        raise AssertionError("K1 with its step count differs or left a "
                             "task uncounted")
    return int(st.long().sum())


def _nbytes(*tensors) -> int:
    from lariat_tpu_torch.tools.kernel_roofline import nbytes
    return nbytes(*tensors)


def _median_ms(fn, n=7):
    import torch
    from lariat_tpu_torch.tools import median_ms
    return median_ms(fn, torch.device("cuda", torch.cuda.current_device()),
                     n)


def _max_abs_err(got, want) -> int:
    if tuple(got.shape) != tuple(want.shape):
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    return int((got.to("cpu").long() - want.to("cpu").long()).abs().max())


def phase_kernels(pk, seed=1):
    """K1-K3 and K2b at main-path shapes, K2/K2b/K3 on their edge shapes,
    and T1; returns name -> (max abs err, kernel ms, plain ms, shape,
    bound ms, what sets the bound)."""
    import numpy as np
    import torch
    from lariat_tpu_torch.ops import sw_batch, sw_extend, sw_global, sw_local
    from lariat_tpu_torch.tools.kernel_roofline import OPS_PER_CELL as OPS
    from lariat_tpu_torch.tools.kernel_turns import (k1_inputs, k2_inputs,
                                                     planted)
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    D = dict(o_del=6, e_del=1, o_ins=6, e_ins=1)
    S3 = dict(match_sc=1, mismatch_sc=-4, n_sc=-1)
    res = {}

    def cuda(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]

    # K1 at the production extend tier 8192 x 192 x 576
    q, qlen, t, tlen, w, h0 = k1_inputs(rng)
    B, Lq, Lt = q.shape[0], q.shape[1], t.shape[1]
    qd, qld, td, tld, wd, h0d = cuda(q, qlen, t, tlen, w, h0)
    mat = sw_extend.score_matrix(1, -4, -1, dev)
    ext = dict(D, end_bonus=5, zdrop=100)

    def k1():
        return sw_extend.extend_batch(qd, qld, td, tld, wd, h0d, **ext, **S3)

    def p1():
        return sw_batch.extend_batch(qd, qld, td, tld, mat, wd, h0d,
                                     packed=True, **ext)

    got, want = k1(), p1()
    torch.cuda.synchronize()
    err = _max_abs_err(got[:6], want)
    if err or int(got[6:].abs().max()):
        raise AssertionError(f"K1 sw_extend differs from its plain version "
                             f"(max abs err {err})")
    # operations: the band cells of the rows each task ran (the twin's
    # count, its stopping row included), at the band ksw_extend2 narrows w
    # to
    _, rows = sw_batch.extend_batch(qd, qld, td, tld, mat, wd, h0d,
                                    packed=True, rows_run=True, **ext)
    rows = rows.cpu().numpy()
    w_eff = sw_batch._adjust_w(torch.from_numpy(qlen), torch.from_numpy(w),
                               1, 5, 6, 1, 6, 1).numpy()
    cells = _band_cells(qlen, rows, w_eff)
    steps = _k1_steps(lambda st: sw_extend.extend_batch(
        qd, qld, td, tld, wd, h0d, **ext, **S3, steps=st), got, B)
    print(f"  K1 schedule: {int(rows.sum())} rows run (the twin's), "
          f"{steps} warp steps (the kernel's count), {cells} band cells")
    res["sw_extend"] = (err, _median_ms(k1), _median_ms(p1), (B, Lq, Lt),
                        *_bound(pk, OPS["extend"] * cells,
                                _nbytes(qd, qld, td, tld, wd, h0d, got)),
                        {"rows_run": int(rows.sum()), "warp_steps": steps,
                         "band_cells": cells})

    # K2 + K2b at the reg2aln chunk 2048 x 192 x 384
    B, Lq, Lt = 2048, 192, 384
    q, qlen, t, tlen, w = k2_inputs(rng, B, Lq, Lt)
    qd, qld, td, tld, wd = cuda(q, qlen, t, tlen, w)
    S = Lq + Lt

    def k2():
        return sw_global.global_batch(qd, qld, td, tld, wd, **D, **S3)

    def p2():
        return sw_global.global_batch_plain(qd, qld, td, tld, wd, **D, **S3)

    (gs, gz), (ws, wz) = k2(), p2()
    torch.cuda.synchronize()
    err = max(_max_abs_err(gs, ws), _max_abs_err(gz, wz))
    if err:
        raise AssertionError(f"K2 sw_global differs (max abs err {err})")
    ops = OPS["global"] * _band_cells(qlen, tlen, w)
    res["sw_global"] = (err, _median_ms(k2), _median_ms(p2), (B, Lq, Lt),
                        *_bound(pk, ops, _nbytes(qd, qld, td, tld, wd, gs,
                                                 gz)))
    res["traceback"] = _k2b(gz, qld, tld, wd, gs, S, pk)
    # K3: 4096 rescue DPs, read 151 (Lq 192) in the pestat window
    # high - low + 151 = 686 (Lt 704)
    B, Lq, Lt = 4096, 192, 704
    qlen = np.full(B, 151, np.int32)
    tlen = np.full(B, 686, np.int32)
    q, t = planted(rng, qlen, tlen, Lq, Lt)
    minsc = np.full(B, 19, np.int32)
    qd, qld, td, tld, md = cuda(q, qlen, t, tlen, minsc)

    def k3():
        return sw_local.local_batch(qd, qld, td, tld, md, **D, **S3)

    def p3():
        return sw_local.local_batch_plain(qd, qld, td, tld, md, **D, **S3)

    got, want = k3(), p3()
    torch.cuda.synchronize()
    err = _max_abs_err(got, want)
    if err:
        raise AssertionError(f"K3 sw_local differs (max abs err {err})")
    ops = OPS["local"] * int((qlen.astype(np.int64) * tlen).sum())
    res["sw_local"] = (err, _median_ms(k3), _median_ms(p3), (B, Lq, Lt),
                       *_bound(pk, ops, _nbytes(qd, qld, td, tld, md, got)))
    for name, (e, ms, pms, shape, bms, by, *_) in res.items():
        print(f"  {name} {shape}: exact (max abs err {e}); kernel "
              f"{ms:.3f} ms, plain {pms:.3f} ms; bound {bms:.4f} ms "
              f"({by}), {100 * bms / ms:.1f}% of it")
    _k1_edges(cuda)
    _edges(cuda, D, S3)
    res["extend_ablate"] = _t1_vs_plain(rng, cuda, pk)
    return res


def _k2b(gz, qld, tld, wd, gs, S, pk):
    """K2b on K2's z of the reg2aln chunk, timed with its bound, and on
    random z bytes of the same shape (every walk a random path), each
    against its twin, exact, with the windows of z its warps staged (the
    kernel's own count) beside the walk steps."""
    import numpy as np
    import torch
    from lariat_tpu_torch.ops import sw_global
    B = gz.shape[0]
    out = {}
    zr = torch.from_numpy(np.random.default_rng(29).integers(
        0, 256, tuple(gz.shape), dtype=np.uint8)).to(gz.device)
    for name, z in (("k2_z", gz), ("random_z", zr)):
        wnd = torch.full((B,), -1, dtype=torch.int32, device=gz.device)
        got = sw_global.traceback_ops_fused(z, qld, tld, wd, gs, S,
                                            windows=wnd)
        want = sw_global.traceback_ops_fused_plain(z, qld, tld, wd, gs, S)
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        if err or int(wnd.min()) < 0:
            raise AssertionError(f"K2b traceback differs on {name} (max abs "
                                 f"err {err}) or left a task uncounted")
        ops_b = got[:, :S // 4].cpu().numpy()
        steps = sum((((ops_b >> (2 * k)) & 3) != 3).sum(1)
                    for k in range(4))
        wn = wnd.cpu().numpy()
        out[name] = {"walk_steps": int(steps.sum()),
                     "walk_steps_max": int(steps.max()),
                     "windows_sum": int(wn.sum()),
                     "windows_max": int(wn.max()),
                     "windows_mean": float(wn.mean())}
        if name == "k2_z":
            # bytes: one 32-byte sector of z a walk step, the lengths in,
            # the blob out
            bms, by = _bound(pk, 0, 32 * int(steps.sum())
                             + _nbytes(qld, tld, wd, gs, got))

            def k2b():
                return sw_global.traceback_ops_fused(gz, qld, tld, wd, gs, S)

            def p2b():
                return sw_global.traceback_ops_fused_plain(gz, qld, tld, wd,
                                                           gs, S)
            ms, pms = _median_ms(k2b), _median_ms(p2b)
    print(f"  K2b ({B}, S {S}): exact on K2's z and on random z; "
          f"{json.dumps(out)}")
    return (0, ms, pms, (B, S), bms, by, out)


def _k1_edges(cuda):
    """K1 on its edge shapes against its twin (on the card), exact, at
    zdrop 100, 5, 0 and -1: qlen 0, tlen 0, tlen < 32, qlen not a multiple
    of C, w 0, w >= qlen, rows past qlen + w, a negative w (the empty row 0
    with beg == qlen: the gscore-0 case), h0 <= o_ins + e_ins, unrelated
    targets that z-drop within rows 0-3 (and later tasks that z-drop while
    their later rows are in flight), N codes, and Lq 448 (two tiles past
    256 columns)."""
    import numpy as np
    import torch
    from lariat_tpu_torch.ops import sw_batch, sw_extend
    from lariat_tpu_torch.tools.kernel_turns import planted
    rng = np.random.default_rng(13)
    report = []
    for B, Lq, Lt in ((512, 192, 576), (512, 448, 320)):
        qlen = rng.integers(1, Lq + 1, B).astype(np.int32)
        tlen = np.minimum(qlen + rng.integers(-20, 200, B), Lt).clip(
            1).astype(np.int32)
        w = rng.integers(0, 101, B).astype(np.int32)
        h0 = rng.integers(0, 120, B).astype(np.int32)
        qlen[:8] = 0, 40, 25, 37, 60, 30, 20, 9
        tlen[:8] = Lt, 0, 20, Lt, Lt, Lt, min(60, Lt), 31
        w[3:8] = 12, 0, 35, 3, 9
        h0[7:10] = 5, 7, 2
        qlen[10:12], w[10:12], tlen[10:12] = (4, 5), (-4, -2), (10, 10)
        qlen[12:14] = Lq, min(Lq, 257)
        junk = np.zeros(B, bool)
        junk[14:40] = True                    # unrelated targets
        q, t = planted(rng, qlen, tlen, Lq, Lt, n_frac=0.05)
        at0 = rng.random(B) < 0.5             # half planted at column 0
        for b in np.nonzero(at0 & ~junk)[0]:
            n = int(min(qlen[b], tlen[b]))
            t[b, :n] = q[b, :n]
        t[junk] = rng.integers(0, 4, (int(junk.sum()), Lt))
        args = cuda(q, qlen, t, tlen, w, h0)
        mat = sw_extend.score_matrix(1, -4, -1, args[0].device)
        w_eff = sw_batch._adjust_w(torch.from_numpy(qlen),
                                   torch.from_numpy(w), 1, 5, 6, 1, 6,
                                   1).numpy()
        n_band = np.minimum(tlen, np.where(w_eff < 0, 0, qlen + w_eff))
        for zdrop in (100, 5, 0, -1):
            got = sw_extend.extend_batch(*args, zdrop=zdrop)
            want, rows = sw_batch.extend_batch(
                args[0], args[1], args[2], args[3], mat, args[4], args[5],
                zdrop=zdrop, packed=True, rows_run=True)
            torch.cuda.synchronize()
            if _max_abs_err(got[:6], want) or int(got[6:].abs().max()):
                raise AssertionError(f"K1 sw_extend differs on the edge "
                                     f"shapes ({B}, {Lq}, {Lt}), zdrop "
                                     f"{zdrop}")
            early = int((rows.cpu().numpy() < n_band).sum())
            report.append(f"({B}, {Lq}, {Lt}) zdrop {zdrop}: {early} "
                          f"stopped early")
    print(f"  K1 edge shapes exact: {'; '.join(report)}")


def _edges(cuda, D, S3):
    """K3 (both passes) and K2 with K2b on their edge shapes, exact
    against the twins: query columns past one tile (Lq 448), qlen 0, tlen
    0, tlen < 32, qlen not a multiple of 6, N codes, minsc 0; w 0,
    w >= qlen, rows past qlen + w (empty bands)."""
    import numpy as np
    import torch
    from lariat_tpu_torch.ops import sw_global, sw_local
    from lariat_tpu_torch.tools.kernel_turns import planted
    rng = np.random.default_rng(11)
    B, Lq, Lt = 512, 448, 704
    qlen = rng.integers(1, Lq + 1, B).astype(np.int32)
    tlen = rng.integers(1, Lt + 1, B).astype(np.int32)
    qlen[[0, 3, 4, 5, 6]] = 0, 151, 448, 193, 192
    tlen[[1, 2, 7]] = 0, 20, 31
    minsc = np.where(rng.random(B) < 0.3, 0, 19).astype(np.int32)
    q, t = planted(rng, qlen, tlen, Lq, Lt, n_frac=0.05)
    args = cuda(q, qlen, t, tlen, minsc)
    got = sw_local.local_two_pass(*args, **D, **S3)
    want = sw_local.local_two_pass(*(a.cpu() for a in args), **D, **S3)
    torch.cuda.synchronize()
    if _max_abs_err(got, want):
        raise AssertionError("K3 sw_local differs on the edge shapes")
    B, Lq, Lt = 512, 448, 512
    qlen = rng.integers(0, Lq + 1, B).astype(np.int32)
    tlen = np.clip(qlen + rng.integers(-40, 41, B), 1, Lt).astype(np.int32)
    w = rng.integers(0, 60, B).astype(np.int32)
    w[0], qlen[1], tlen[2], tlen[3], tlen[4] = 0, 0, 0, 10, 31
    w[5] = qlen[5] + 5                                  # w >= qlen
    w[6], tlen[6] = 3, min(int(qlen[6]) + 40, Lt)       # rows past qlen + w
    q, t = planted(rng, qlen, tlen, Lq, Lt, n_frac=0.05)
    args = cuda(q, qlen, t, tlen, w)
    gs, gz = sw_global.global_batch(*args, **D, **S3)
    ws, wz = sw_global.global_batch_plain(*args, **D, **S3)
    torch.cuda.synchronize()
    if max(_max_abs_err(gs, ws), _max_abs_err(gz, wz)):
        raise AssertionError("K2 sw_global differs on the edge shapes")
    S = Lq + Lt
    got = sw_global.traceback_ops_fused(gz, args[1], args[3], args[4], gs, S)
    want = sw_global.traceback_ops_fused_plain(wz, args[1], args[3],
                                               args[4], ws, S)
    torch.cuda.synchronize()
    if _max_abs_err(got, want):
        raise AssertionError("K2b traceback differs on the edge shapes")
    print("  edge shapes: K3 two-pass (512, 448, 704), K2 + K2b (512, 448, "
          "512): exact")


def _t1_vs_plain(rng, cuda, pk):
    """T1 against its twin in all six variants at 8192 x 192 x 576, on
    planted inputs (timed, kernel and twin) and on the ablation tool's
    random inputs (timed, kernel only: most lanes die within a few
    rows). The bound is the baseline's on the planted inputs."""
    import numpy as np
    import torch
    from lariat_tpu_torch.ops import extend_ablate
    from lariat_tpu_torch.tools.kernel_roofline import OPS_PER_CELL
    from lariat_tpu_torch.tools.extend_ablate import inputs
    from lariat_tpu_torch.tools.kernel_turns import planted
    B, Lq, Lt = 8192, 192, 576
    qlen = rng.integers(0, 152, B).astype(np.int32)
    tlen = np.minimum(qlen + rng.integers(0, 450, B), Lt).astype(np.int32)
    qlen[:64], tlen[64:128] = 0, 0
    q, t = planted(rng, qlen, tlen, Lq, Lt)
    params = np.zeros((B, 8), np.int32)
    params[:, 0], params[:, 1], params[:, 2] = qlen, tlen, 100
    params[:, 3] = rng.integers(19, 152, B)
    sets = {"planted": cuda(q, t, params),
            "random": inputs(B, Lq, Lt, torch.device("cuda"))}
    err, base = 0, None
    for name, (half, kw) in extend_ablate.VARIANTS.items():
        Lv = Lt // 2 if half else Lt
        times = {}
        for kind, (qd, td, pd) in sets.items():
            def k():
                return extend_ablate.run_variant(qd, td, pd, Lv, **kw)

            def p():
                return extend_ablate.run_variant_plain(qd, td, pd, Lv, **kw)

            got, want = k(), p()
            torch.cuda.synchronize()
            e = _max_abs_err(got, want)
            if e:
                raise AssertionError(f"T1 extend_ablate {name} ({kind}) "
                                     f"differs from its plain version "
                                     f"(max abs err {e})")
            err = max(err, e)
            times[kind] = _median_ms(k)
            if kind == "planted":
                times["plain"] = _median_ms(p, n=3)
                if base is None:
                    # the band cells up to the rows the baseline's outputs
                    # prove visited (its best row max_i, its best
                    # to-the-end row max_ie)
                    o = got.cpu().numpy()
                    ops = OPS_PER_CELL["extend"] * _band_cells(
                        qlen, np.maximum(o[2], o[4]) + 1, params[:, 2])
                    base = (times[kind], times["plain"],
                            *_bound(pk, ops, _nbytes(qd, td, pd, got)))
        print(f"  extend_ablate {name} ({B}, {Lq}, {Lv}): exact; planted "
              f"kernel {times['planted']:.3f} ms, plain "
              f"{times['plain']:.3f} ms; random kernel "
              f"{times['random']:.3f} ms")
    return (err, base[0], base[1], (B, Lq, Lt), base[2], base[3])


def phase_data(scale: float, barcodes: int, pairs_per_bc: int):
    os.makedirs(SMOKE, exist_ok=True)
    tag = f"s{scale}_b{barcodes}_p{pairs_per_bc}"
    fasta = os.path.join(SMOKE, f"genome_{scale}.fa")
    reads = os.path.join(SMOKE, f"reads_{tag}.fastq.gz")
    if not os.path.exists(fasta + ".done"):
        _run([sys.executable, "tools/synth_genome.py", fasta, "--scale",
              str(scale), "--seed", "7"], timeout=600)
        open(fasta + ".done", "w").close()
    if not os.path.exists(reads + ".done"):
        _run([sys.executable, "tools/sim_reads.py", fasta, reads,
              "--barcodes", str(barcodes), "--pairs-per-bc",
              str(pairs_per_bc)], timeout=600)
        open(reads + ".done", "w").close()
    # the index, built (or loaded) and saved beside the FASTA by the CLIs'
    # own load_reference, in a subprocess
    info = _run([sys.executable, "-c",
                 "import sys; "
                 "from lariat_tpu_torch.cli import load_reference; "
                 "fm = load_reference(sys.argv[1]); "
                 "print(fm.l_pac, len(fm.contigs))", fasta], timeout=900)
    l_pac, n_contigs = (int(v) for v in info.split()[-2:])
    print(f"  genome {l_pac:,} bp, {n_contigs} contigs; reads "
          f"{os.path.relpath(reads, REPO)}")
    return fasta, reads


def phase_seeding(fasta, reads_path, pk):
    """K4a-K4c and K5 against their twins on the chr20-scale index, at the
    shapes of one 4,096-read seeding batch, then the device collect on a
    batch whose low-complexity reads send it to K4b (``_fallback_collect``);
    returns name -> (max abs err, kernel ms, plain ms, shape, bound ms,
    what sets it) and the K4b launches of that collect.

    The seeding kernels' bounds are bytes: 48 for each distinct fused row
    that the twins' ranks read on these inputs (``fm_batch.rank_rows``,
    ``lf_row``), each read once, plus their own inputs and outputs. They
    count no operations. K4a's lanes also count the rows they fetch (aux;
    one when both ranks of an extension share a block). K4a runs at round
    1's phase-A budget (timed), at phase B's 8L budget on the stragglers
    and at round 2, each in int32 and int64 indices; its walk lengths come
    out beside its time."""
    import numpy as np
    import torch
    from lariat_tpu_torch.align.engine import encode_read
    from lariat_tpu_torch.cli import load_reference
    from lariat_tpu_torch.config import AlignerConfig
    from lariat_tpu_torch.ops import fm_batch, smem_device as sd
    from lariat_tpu_torch.parallel import align_step
    from lariat_tpu_torch.tools.kernel_turns import seed_batch
    dev = torch.device("cuda")
    fm = load_reference(fasta)
    opt = AlignerConfig()
    fmd = fm_batch.DeviceFMIndex.from_host(fm, dev)
    g = align_step.DeviceGenome.from_host(fm, fmd)
    print(f"  index: fused {tuple(fmd.fused.shape)} int32 rows, "
          f"{fmd.idx_dtype}, seq_len {fmd.seq_len:,}")
    rmat, lens, qs = seed_batch(reads_path, SEED_READS)
    R, L = rmat.shape

    def put(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    def err(got, want):
        e = max(_max_abs_err(a, b) for a, b in zip(got, want))
        if e:
            raise AssertionError(f"differs from its plain version (max abs "
                                 f"err {e})")
        return e

    def no_rows():
        # a bool per fused row, which a twin sets where its ranks read
        return torch.zeros(fmd.fused.shape[0], dtype=torch.bool, device=dev)

    res = {}
    rd, lens_d = put(rmat), put(lens)
    fmd64 = fm_batch.DeviceFMIndex(fmd.fused, fmd.L2.long(), fmd.primary,
                                   fmd.seq_len)
    min_seed = opt.min_seed_len

    def k4a(f, reads, se, ee, mi, md, steps, bwd, cap):
        return sd.min_starts_twoptr(f, reads, se, ee, mi, L,
                                    max_steps=steps, min_seed=min_seed,
                                    cap=cap, mid=md, bwd_init=bwd)

    def p4a(f, reads, se, ee, mi, md, steps, bwd, cap, touched=None):
        meta, big, aux = sd.min_starts_twoptr_plain(
            f, reads, se, ee, mi.to(f.idx_dtype), md, L, sd._budget(steps),
            bwd, min_seed, cap, touched)
        sd._twoptr_flags(meta, aux, cap)
        return meta, big, aux

    # round 1 at its phase-A budget (3L), as the collect runs it
    runs = {"round1": (rd, put(np.zeros(R), np.int32), lens_d,
                       put(np.ones(R), np.int64),
                       put(np.full(R, L + 2), np.int32), 3 * L, False,
                       sd.CAP1)}
    meta1, big1, _ = k4a(fmd, *runs["round1"])
    meta1 = meta1.cpu().numpy()
    # phase B: round 1's stragglers rerun at 8L, padded as the collect
    # pads them, with the six low-complexity reads, which outrun round 1's
    # budget on this genome (phase 5's collect runs them too)
    idx = np.nonzero(meta1[:, sd.CAP1 + 1] == 0)[0]
    lc = [encode_read(s) for s in LOW_COMPLEXITY]
    nb = len(idx) + len(lc)
    Rs = sd._pad_pow2(nb)
    rmat_b = np.full((Rs, L), 4, np.uint8)
    rmat_b[:len(idx)] = rmat[idx]
    end_b = np.zeros(Rs, np.int64)
    end_b[:len(idx)] = lens[idx]
    for k, s in enumerate(lc, start=len(idx)):
        rmat_b[k, :len(s)] = s
        end_b[k] = len(s)
    mid_b = np.zeros(Rs, np.int64)
    mid_b[:nb] = L + 2
    runs["phaseB"] = (put(rmat_b), put(np.zeros(Rs), np.int32),
                      put(end_b, np.int32), put(np.ones(Rs), np.int64),
                      put(mid_b, np.int32), 8 * L, False, sd.CAP1)
    # round 2 on the reseed requests of round 1, as the collect builds them
    ri1, m1 = sd._slots(meta1, big1.cpu().numpy(), sd.CAP1, R)
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    re = (m1[:, 4] - m1[:, 3] >= split_len) & (m1[:, 2] <= opt.split_width)
    n2 = int(re.sum())
    R2 = sd._pad_pow2(n2)
    mid2, end2, mi2, rows2 = (np.zeros(R2, np.int64) for _ in range(4))
    mi2 += 1
    mid2[:n2] = (m1[re, 3] + m1[re, 4]) >> 1
    end2[:n2] = lens[ri1[re]]
    mi2[:n2] = m1[re, 2] + 1
    rows2[:n2] = ri1[re]
    runs["round2"] = (rd[put(rows2)], put(mid2, np.int32),
                      put(end2, np.int32), put(mi2), put(mid2, np.int32),
                      4 * L, True, sd.CAP2)
    # each run against the twin in int32 and int64 indices; the walk
    # lengths (aux, over the lanes before the padding) and times of the
    # int32 runs
    real = {"round1": R, "phaseB": nb, "round2": n2}
    stats, e4a = {}, 0
    t4a = no_rows()
    for name, a in runs.items():
        for f in (fmd, fmd64):
            got = k4a(f, *a)
            want = p4a(f, *a, touched=t4a if name == "round1" else None)
            e4a = max(e4a, err(got, want))
        aux = got[2][:real[name]].cpu().numpy().astype(np.int64)
        ms = _median_ms(lambda: k4a(fmd, *a))
        tr = aux[:, 1]
        stats[name] = {"lanes": real[name],
                       "transitions_max": int(tr.max()),
                       "transitions_median": float(np.median(tr)),
                       "transitions_sum": int(tr.sum()),
                       "rows_sum": int(aux[:, 2].sum()), "ms": ms,
                       "us_per_transition": 1e3 * ms / max(int(tr.max()),
                                                           1)}
        print(f"  K4a {name} ({stats[name]['lanes']} lanes): exact in int32 "
              f"and int64; {json.dumps(stats[name])}")
    print(f"  K4a round 1: flags {int(meta1[0, -1]) & 3}, "
          f"{int(meta1[:, sd.CAP1].sum())} seeds, {len(idx)} stragglers; "
          f"phase B: those and {len(lc)} low-complexity reads; round 2: "
          f"{n2} reseed lanes")

    def k4a_r1():
        return sd.min_starts_twoptr(fmd, *runs["round1"][:4], L,
                                    max_steps=3 * L, min_seed=min_seed,
                                    cap=sd.CAP1, mid=runs["round1"][4])[:2]

    def p4a_r1():
        return p4a(fmd, *runs["round1"])[:2]

    r1 = stats["round1"]
    rows4a = int(t4a.sum())
    res["smem_twoptr"] = (e4a, r1["ms"], _median_ms(p4a_r1, n=3), (R, L),
                          *_bound(pk, 0, 48 * rows4a + _nbytes(
                              *runs["round1"][:5], *k4a_r1())),
                          {"transitions": stats, "rows_distinct": rows4a})

    ri = put(np.repeat(np.arange(R), L), np.int32)
    ee = put(np.tile(np.arange(1, L + 1), R), np.int32)
    mi = put(np.ones(R * L), np.int64)

    def k4b():
        return sd.min_starts_kernel(fmd, rd, ri, ee, mi, L)

    def p4b():
        return sd.min_starts_kernel_plain(fmd, rd, ri, ee, mi, L)

    # int64 and int32 indices, each with the lanes' counters; the int32
    # run's rows bound it
    e4b = 0
    for f in (fmd64, fmd):
        cnt = torch.full((R * L, 2), -1, dtype=torch.int32, device=dev)
        out4b = sd.min_starts_kernel(f, rd, ri, ee, mi, L, counts=cnt)
        t4b = no_rows()
        want4b = sd.min_starts_kernel_plain(f, rd, ri, ee, mi, L, t4b)
        e4b = max(e4b, err(out4b, want4b))
        if int(cnt.min()) < 0:
            raise AssertionError("K4b left a lane uncounted")
    c = cnt.long()
    n_ext, n_rows = int(c[:, 0].sum()), int(c[:, 1].sum())
    info4b = {"lanes": R * L, "extensions": n_ext,
              "extensions_max": int(c[:, 0].max()), "rows_fetched": n_rows,
              "rows_per_extension": n_rows / max(n_ext, 1),
              "rows_distinct": int(t4b.sum())}
    print(f"  K4b ({R * L} lanes): exact in int32 and int64; "
          f"{json.dumps(info4b)}")
    res["smem_exhaustive"] = (e4b, _median_ms(k4b), _median_ms(p4b, n=3),
                              (R * L,),
                              *_bound(pk, 0, 48 * int(t4b.sum()) + _nbytes(
                                  rd, ri, ee, mi, *out4b)), info4b)
    cap3 = max(2, L // opt.min_seed_len + 2)

    def s1(f):
        return (f, rd, lens_d, int(opt.max_mem_intv), L, opt.min_seed_len,
                cap3)

    def k4c():
        return sd.strategy1(*s1(fmd))

    def p4c():
        return sd.pack_r3(*sd.strategy1_plain(*s1(fmd)))

    # int32 and int64 indices; the int32 run's rows bound it
    e4c = err(sd.strategy1(*s1(fmd64)),
              sd.pack_r3(*sd.strategy1_plain(*s1(fmd64))))
    out4c = k4c()
    t4c = no_rows()
    want4c = sd.strategy1_plain(*s1(fmd), touched=t4c)
    res["smem_strategy1"] = (max(e4c, err(out4c, sd.pack_r3(*want4c))),
                             _median_ms(k4c), _median_ms(p4c, n=3), (R, L),
                             *_bound(pk, 0, 48 * int(t4c.sum()) + _nbytes(
                                 rd, lens_d, *out4c)))
    res["sa_walk"] = _k5_lookup(fm, fmd, fmd64, g, pk, no_rows, err)
    planes_res, planes_launches = _planes_k9(pk, fmd, fmd64, runs, L,
                                             no_rows, err)
    res.update(planes_res)
    for name, (e, ms, pms, shape, bms, by, *_) in res.items():
        print(f"  {name} {shape}: exact (max abs err {e}); kernel "
              f"{ms:.3f} ms, plain {pms:.3f} ms; bound {bms:.4f} ms "
              f"({by}), {100 * bms / ms:.1f}% of it")
    print(f"  K4a: {r1['us_per_transition']:.3f} us a transition of the "
          f"longest lane ({r1['transitions_max']} transitions in "
          f"{r1['ms']:.3f} ms) beside its bound")
    res["sw_extend_desc"] = _k1_desc_wave(fm, pk)
    return (res, _fallback_collect(fm, fmd, g, qs[:FALLBACK_READS], opt),
            planes_launches)


def _k5_lookup(fm, fmd, fmd64, g, pk, no_rows, err):
    """K5 as the SA lookup runs it, one launch at the whole budget
    (``align_step.LOOKUP_STEPS``) over 65,536 random rows (``kernel_turns.
    lookup_rows``), against its twin in int32 and int64 indices, timed with
    its bound (48 bytes a distinct fused row the twin's walks read, plus
    inputs and outputs); beside it the phase-1 shape of earlier trees (64
    steps), the whole ``sa_lookup_batch_host`` (the launch, the download and
    the host sample add, positions checked against the twin's walk), the
    longest walk's steps and the us a step of that walk."""
    import numpy as np
    import torch
    from lariat_tpu_torch.parallel import align_step
    from lariat_tpu_torch.tools.kernel_turns import lookup_rows
    dev = fmd.device
    rows = lookup_rows(fm.seq_len)
    n5 = len(rows)
    steps = align_step.LOOKUP_STEPS
    e5 = 0
    for f in (fmd64, fmd):        # the int32 run's inputs are kept
        gf = align_step.DeviceGenome.from_host(fm, f)
        k5 = (gf, torch.from_numpy(rows).to(dev, f.idx_dtype),
              torch.zeros(n5, dtype=f.idx_dtype, device=dev),
              torch.zeros(n5, dtype=torch.bool, device=dev), steps)
        out5 = align_step.sa_walk_chunk(*k5)
        t5 = no_rows()
        want5 = align_step.sa_walk_chunk_plain(*k5, touched=t5)
        e5 = max(e5, err([out5], [want5]))
        if not bool(out5[2].bool().all()):
            raise AssertionError("K5: a walk outlived the lookup's budget")

    def k5k():
        return align_step.sa_walk_chunk(*k5)

    def k5p1():
        return align_step.sa_walk_chunk(*k5[:4], 64)

    def lookup():
        return align_step.sa_lookup_batch_host(g, fm, rows)

    sa = np.asarray(fm.sa_samples)
    wk, ws = (want5[i].cpu().numpy().astype(np.int64) for i in (0, 1))
    if not np.array_equal(lookup(), sa[wk // fm.sa_intv] + ws):
        raise AssertionError("the SA lookup differs from its twin's walk")
    ms = _median_ms(k5k)
    longest = int(ws.max())
    info = {"max_steps": steps, "longest": longest,
            "mean_steps": float(ws.mean()),
            "past_64": int((ws > 64).sum()),
            "us_per_step_longest": 1e3 * ms / max(longest, 1),
            "phase1_ms": _median_ms(k5p1), "lookup_ms": _median_ms(lookup),
            "rows_distinct": int(t5.sum())}
    print(f"  K5 one launch ({n5} rows, {steps} steps): exact in int32 and "
          f"int64; {json.dumps(info)}")
    return (e5, ms, _median_ms(lambda: align_step.sa_walk_chunk_plain(*k5),
                               n=3), (n5, steps),
            *_bound(pk, 0, 48 * int(t5.sum()) + _nbytes(*k5[1:4], out5)),
            info)


def _k1_desc_wave(fm, pk):
    """K1's descriptor entry (``resident.extend_wave_resident`` on the
    card: one launch) on a wave built from the chr20-scale genome against
    build_qt plus the twin on the card, exact, with int32 and int64
    descriptors: 8,192 extensions of 2,048 reads drawn from both strands
    (2% substitutions, 1% N), right extensions (qdir = tdir = 1) and left
    ones (qdir = tdir = -1), reverse-strand tstart >= l_pac, and tasks that
    run off the read or off either end of the doubled text. Returns, from
    the int32 run, the descriptor entry's ms with its bound, the tile
    entry's on build_qt's tiles of the same wave with its bound, the ms of
    the path the descriptor entry replaces (build_qt, the descriptor
    columns, the tile entry), each a median of 7, and the wave's rows run
    (the twin's), band cells and warp steps (the kernel's count)."""
    import numpy as np
    import torch
    from lariat_tpu_torch.ops import _build, resident, sw_batch, sw_extend
    from lariat_tpu_torch.tools.kernel_roofline import OPS_PER_CELL
    dev = torch.device("cuda")
    rng = np.random.default_rng(17)
    l_pac, n, n_reads, B, Lq, Lt = int(fm.l_pac), 151, 2048, 8192, 192, 256
    P = rng.integers(0, 2 * l_pac - n, n_reads)
    P = np.where((P < l_pac) & (P + n > l_pac), P - n, P)  # one strand
    reads = []
    for p0 in P:
        r = np.array(fm.fetch_fmd(int(p0), int(p0) + n), np.uint8)
        mut = rng.random(n) < 0.02
        r[mut] = (r[mut] + 1) % 4
        r[rng.random(n) < 0.01] = 4
        reads.append(r)
    rid = rng.integers(0, n_reads, B)
    s0 = rng.integers(1, n, B)
    right = rng.random(B) < 0.5
    qdir = np.where(right, 1, -1)
    qstart = np.where(right, s0, s0 - 1)
    qlen = np.where(right, n - s0, s0)
    tdir = qdir
    tstart = np.where(right, P[rid] + s0, P[rid] + s0 - 1)
    tlen = np.minimum(qlen + rng.integers(0, 100, B), Lt)
    h0 = rng.integers(19, 152, B)
    w = np.where(rng.random(B) < 0.8, 100, rng.integers(0, 100, B))
    off = np.arange(B) < 64                  # off the ends
    tstart[off] = np.where(np.arange(64) < 32, rng.integers(-40, 5, 64),
                           2 * l_pac - rng.integers(1, 40, 64))[:off.sum()]
    qstart[64:96] = rng.integers(n - 5, n + 20, 32)
    desc = resident.pack_desc(rid, qstart, qdir, qlen, tstart, tdir, tlen,
                              h0, w, l_pac)
    reads_d = resident.put_reads(reads, dev).codes
    pac_d = resident.pac_words_from_fm(fm, dev)
    opt_key = (6, 1, 6, 1, 5, 100, 1, -4)
    mat = sw_extend.score_matrix(1, -4, -1, dev)
    out = {}
    for dt in (np.int32, np.int64):
        desc_d = torch.from_numpy(desc.astype(dt)).to(dev)

        def k1d(steps=None):
            return sw_extend.extend_desc(reads_d, pac_d, l_pac, desc_d, Lq, Lt,
                                         steps=steps)

        def cols():
            return [desc_d[:, k].to(torch.int32).contiguous()
                    for k in (resident.D_QL, resident.D_TL, resident.D_W,
                              resident.D_H0)]

        def tiles():
            q, t = resident.build_qt(reads_d, pac_d, l_pac, desc_d, Lq, Lt)
            ql, tl, wd, hd = cols()
            return sw_extend.extend_batch(q, ql, t, tl, wd, hd)

        # the CLI's call: one launch through the descriptor entry
        before = (_build.launches()["sw_extend"],
                  _build.entry_launches()["lariat_sw_extend_desc"])
        got = resident.extend_wave_resident(reads_d, pac_d, l_pac, desc_d,
                                            Lq, Lt, opt_key)
        after = (_build.launches()["sw_extend"],
                 _build.entry_launches()["lariat_sw_extend_desc"])
        if after != (before[0] + 1, before[1] + 1):
            raise AssertionError("K1's descriptor entry did not launch once")
        q, t = resident.build_qt(reads_d, pac_d, l_pac, desc_d, Lq, Lt)
        ql, tl, wd, hd = cols()
        want, rows = sw_batch.extend_batch(q, ql, t, tl, mat, wd, hd,
                                           packed=True, rows_run=True)
        qlt, tlt = q.to(torch.uint8), t.to(torch.uint8)

        def k1t():
            return sw_extend.extend_batch(qlt, ql, tlt, tl, wd, hd)

        torch.cuda.synchronize()
        if (_max_abs_err(got[:6], want) or int(got[6:].abs().max())
                or _max_abs_err(k1t(), got)):
            raise AssertionError(f"K1's descriptor entry differs from "
                                 f"build_qt + the twin or the tile entry "
                                 f"({dt.__name__})")
        if dt is np.int32:
            rows = rows.cpu().numpy()
            w_eff = sw_batch._adjust_w(torch.from_numpy(qlen.astype(np.int32)),
                                       torch.from_numpy(w.astype(np.int32)),
                                       1, 5, 6, 1, 6, 1).numpy()
            cells = _band_cells(np.minimum(qlen, Lq), rows, w_eff)
            ops = OPS_PER_CELL["extend"] * cells
            # the descriptor entry must read its descriptors, each query
            # code and 2 bits a target row it runs, and write its rows
            n_rows = np.minimum(np.minimum(tlen, Lt),
                                np.where(w_eff < 0, 0,
                                         np.minimum(qlen, Lq) + w_eff))
            desc_bytes = (_nbytes(desc_d, got) + int(np.minimum(qlen, Lq).sum())
                          + int(np.maximum(n_rows, 0).sum() + 3) // 4)
            dbms, dby = _bound(pk, ops, desc_bytes)
            tbms, tby = _bound(pk, ops, _nbytes(qlt, tlt, ql, tl, wd, hd, got))
            out = {"desc_ms": _median_ms(k1d), "desc_bound_ms": dbms,
                   "desc_bound_by": dby, "tiles_ms": _median_ms(k1t),
                   "tiles_bound_ms": tbms, "tiles_bound_by": tby,
                   "build_qt_and_tiles_ms": _median_ms(tiles),
                   "rows_run": int(rows.sum()), "band_cells": cells,
                   "warp_steps": _k1_steps(k1d, got, B)}
    good = int((want[0] > torch.from_numpy(h0).to(dev)).sum())
    print(f"  K1 descriptor entry, {B} chr20-scale extensions ({good} "
          f"gained on h0): exact in int32 and int64, and equal to the tile "
          f"entry on build_qt's tiles; {json.dumps(out)}")
    return out


def _planes_k9(pk, fmd, fmd64, runs, L, no_rows, err):
    """K4a's planes entry and K9 (phase 5), off every path: round 1 of the
    4,096-read batch at an 8L budget and round 2 (bwd_init) on its reseed
    lanes at 32L, each in int32 and int64 indices against the planes twin;
    K9 on those planes in both layouts, at round 1's mid (L + 2) and round
    2's real mids, and at a cap that overflows, against its twins; K9's
    round-1 slots against K4a's direct slots where both finished. Returns
    (name -> result row, the launches of one planes-then-compaction pass
    over both rounds)."""
    import numpy as np
    import torch
    from lariat_tpu_torch.ops import _build, smem_device as sd
    from lariat_tpu_torch.tools.kernel_turns import (backtoback_ms,
                                                     device_split, events_ms)
    min_seed = 19
    rd, se1, ee1, mi1 = runs["round1"][:4]
    dev = rd.device
    rd2, se2, ee2, mi2, md2 = runs["round2"][:5]
    R = rd.shape[0]
    md1 = torch.full((R,), L + 2, dtype=torch.int32, device=dev)
    cases = {"round1": (rd, se1, ee1, mi1, 8 * L, False, md1, sd.CAP1),
             "round2": (rd2, se2, ee2, mi2, 32 * L, True, md2, sd.CAP2)}

    def planes(f, name):
        r, se, ee, mi, steps, bwd = cases[name][:6]
        return sd.min_starts_twoptr_planes(f, r, se, ee, mi, L,
                                           max_steps=steps, bwd_init=bwd)

    def planes_plain(f, name, touched=None):
        r, se, ee, mi, steps, bwd = cases[name][:6]
        return sd.min_starts_twoptr_plain(
            f, r, se.to(torch.int32), ee.to(torch.int32),
            mi.to(f.idx_dtype), None, L, sd._budget(steps), bwd, 0, 0,
            touched, planes=True)

    # the path: planes then the packed compaction, both rounds, int32
    _build.reset_launches()
    for name, (_, se, ee, _, _, _, md, cap) in cases.items():
        b, x0, x1, s, v, done, _ = planes(fmd, name)
        sd.compact_starts_packed(b, x0, x1, s, v, se, ee, md, done,
                                 min_seed, cap)
    torch.cuda.synchronize()
    drive = {k: _build.launches()[k] for k in ("smem_planes", "compact")}
    if drive != {"smem_planes": 2, "compact": 2}:
        raise AssertionError(f"planes pass launches: {drive}")

    res, info, kept = {}, {}, {}
    touched = no_rows()
    e_pl = 0
    for name in cases:
        for f in (fmd, fmd64):
            got = planes(f, name)
            want = planes_plain(f, name, touched if (
                name == "round1" and f is fmd) else None)
            e_pl = max(e_pl, err(got[:5] + got[6:], want))
            if bool(got[5]) != bool(want[5][:, 0].all()):
                raise AssertionError(f"planes {name}: done flag")
            kept[name, f.idx_dtype] = got
        aux = got[6].cpu().numpy().astype(np.int64)
        info[name] = {"lanes": int(aux.shape[0]), "done": bool(got[5]),
                      "transitions_max": int(aux[:, 1].max()),
                      "transitions_sum": int(aux[:, 1].sum()),
                      "rows_sum": int(aux[:, 2].sum())}
    # times and bounds of round 1: 48 B a distinct fused row its ranks
    # read, its inputs and its planes out
    for f, tag in ((fmd, ""), (fmd64, "_int64")):
        out = kept["round1", f.idx_dtype]
        info["round1"]["ms" + tag] = _median_ms(lambda: planes(f, "round1"))
        info["round1"]["bound" + tag] = _bound(
            pk, 0, 48 * int(touched.sum()) + _nbytes(rd, se1, ee1, mi1)
            + _nbytes(*out[:5], out[6]))
    print(f"  K4a planes entry: exact in int32 and int64 (round 1 {R} "
          f"lanes at 8L, round 2 {info['round2']['lanes']} lanes at 32L); "
          f"{json.dumps(info)}")
    r1 = info["round1"]
    res["smem_planes"] = (e_pl, r1["ms"],
                          _median_ms(lambda: planes_plain(fmd, "round1"),
                                     n=3),
                          (R, L), *r1["bound"],
                          {"rows_distinct": int(touched.sum()),
                           "ms_int64": r1["ms_int64"],
                           "bound_ms_int64": r1["bound_int64"][0],
                           "rounds": info})

    # K9 on those planes: both layouts, both rounds' mids, the collect's
    # caps, then min_seed 0 at a cap one below the longest lane's count
    # (an overflow), then at L (none: the flag and the flags column must
    # read 0 after the call that overflowed)
    e9, k9, ovf = 0, {}, []
    for (name, dt), (b, x0, x1, s, v, done, _) in kept.items():
        se, ee, md, cap = (cases[name][i] for i in (1, 2, 6, 7))
        args = (b, x0, x1, s, v, se, ee, md)
        for ms_, cp in ((min_seed, cap), (0, None), (0, L)):
            if cp is None:
                most = int(sd.compact_starts_plain(*args, 0, L)[5].max())
                cp = max(1, most - 1)
            got = sd.compact_starts(*args, ms_, cp)
            want = sd.compact_starts_plain(*args, ms_, cp)
            gpk = sd.compact_starts_packed(*args, done, ms_, cp)
            wpk = sd.compact_starts_packed_plain(*args, done, ms_, cp)
            e9 = max(e9, err(got, want), err([gpk], [wpk]))
            if ms_ == 0 and cp < L:
                ovf.append(bool(got[6]))
            elif ms_ == 0 and (bool(got[6]) or bool(
                    (gpk[:, -1] != int(bool(done))).any())):
                raise AssertionError("K9: the overflow of the call before "
                                     "stayed set")
            elif ms_:
                k9[f"{name}_seeds"] = int(got[5].long().sum())
    if not any(ovf):
        raise AssertionError(f"K9: no small cap overflowed: {ovf}")
    # one packed call captured in a CUDA graph (so the wrapper never waits
    # for the card) and replayed twice: an overflowing cap, then L
    b, x0, x1, s, v, done = kept["round1", fmd.idx_dtype][:6]
    args = (b, x0, x1, s, v, se1, ee1, md1)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cap_out = [sd.compact_starts_packed(*args, done, 0, cp)
                   for cp in (2, L)]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        e9 = max(e9, err(cap_out, [sd.compact_starts_packed_plain(
            *args, done, 0, cp) for cp in (2, L)]))
    del graph
    k9["graph_replays_exact"] = 2
    # K9's round-1 slots against K4a's direct slots (8L), lanes done in both
    b, x0, x1, s, v, done, aux = kept["round1", fmd.idx_dtype]
    qb, qe, cx0, cx1, cs, counts, _ = sd.compact_starts(
        b, x0, x1, s, v, se1, ee1, md1, min_seed, sd.CAP1)
    meta, big, _ = sd.min_starts_twoptr(fmd, rd, se1, ee1, mi1, L,
                                        max_steps=8 * L, min_seed=min_seed,
                                        cap=sd.CAP1, mid=md1)
    C = sd.CAP1
    both = (meta[:, C + 1] == 1) & (aux[:, 0] == 1)
    n = counts.clamp(max=C)
    k = torch.arange(C, device=dev)[None, :] < n[:, None]
    slots = (qb << 16) | qe
    same = ((meta[:, C] == n)
            & ((~k) | ((meta[:, :C] == slots)
                       & (big[:, :C] == cx0) & (big[:, C:2 * C] == cx1)
                       & (big[:, 2 * C:] == cs))).all(dim=1))
    if not bool(same[both].all()):
        raise AssertionError("K9's round-1 slots differ from K4a's")
    k9["lanes_checked_against_k4a"] = int(both.sum())
    # times and bounds at round 1 in int32 and int64, both layouts: with
    # the wrapper (median of 7), in device time as a spun single call and
    # as the mean of 200 calls back to back (a CUDA graph), and what one
    # call enqueues (torch.profiler). Bound: b and valid of every column,
    # x0, x1, s of the kept columns, the lanes' ranges, the outputs
    for f, tag in ((fmd, ""), (fmd64, "_int64")):
        b, x0, x1, s, v, done = kept["round1", f.idx_dtype][:6]
        args = (b, x0, x1, s, v, se1, ee1, md1)
        out = sd.compact_starts(*args, min_seed, C)
        pko = sd.compact_starts_packed(*args, done, min_seed, C)
        need = (_nbytes(b, v, se1, ee1, md1) + 3 * R * C * x0.element_size())
        calls = {"": lambda: sd.compact_starts(*args, min_seed, C),
                 "packed_": lambda: sd.compact_starts_packed(
                     *args, done, min_seed, C)}
        for lay, fn in calls.items():
            k9[f"{lay}ms{tag}"] = _median_ms(fn)
            k9[f"{lay}dev_ms{tag}"] = events_ms(fn)
            k9[f"{lay}b2b_ms{tag}"] = backtoback_ms(fn)
            split = device_split(fn)
            others = {n_: c for n_, (c, _) in split.items()
                      if n_ != "compact_kernel"}
            if (split.get("compact_kernel", [0])[0] != 1
                    or any(not n_.lower().startswith("memset")
                           for n_ in others)
                    or sum(others.values()) > 1):
                raise AssertionError(f"K9 call enqueues more than K9 and "
                                     f"one memset: {split}")
            k9[f"{lay}enqueued{tag}"] = split
        k9["bound" + tag] = _bound(pk, 0, need + _nbytes(*out[:7]))
        k9["packed_bound" + tag] = _bound(pk, 0, need + _nbytes(pko))
        if not tag:
            # the stable argsort and gathers are both the twin and the one
            # PyTorch route to this function: one timing, reported as
            # plain_ms and as library_ms
            k9["plain_ms"] = k9["library_ms"] = _median_ms(
                lambda: sd.compact_starts_plain(*args, min_seed, C), n=3)
    print(f"  K9: exact in both layouts, int32 and int64, mids L + 2 and "
          f"round 2's, caps 32/16, caps that overflow and then L (flags "
          f"reset), and replayed from a CUDA graph; {json.dumps(k9)}")
    res["compact"] = (e9, k9["ms"], k9["plain_ms"], (R, L), *k9["bound"],
                      {"library_ms": k9["library_ms"],
                       "library_ms_is_plain_ms": True,
                       **{key: k9[key] for key in k9
                          if key not in ("ms", "plain_ms", "library_ms",
                                         "bound")},
                       "bound_ms_int64": k9["bound_int64"][0],
                       "share_b2b": k9["bound"][0] / k9["b2b_ms"],
                       "share_dev": k9["bound"][0] / k9["dev_ms"],
                       "share_wrapper": k9["bound"][0] / k9["ms"]})
    return res, drive


def _fallback_collect(fm, fmd, g, qs, opt) -> int:
    """collect_seeds_rbegs_device, the main path's seeding call, on reads of
    the FASTQ plus low-complexity reads that blow K4a's step cap, so round
    1 takes the exhaustive fallback (K4b); its seeds and rbegs must equal
    the native C++ seeder's. Returns K4b's launches in that call."""
    import numpy as np
    from lariat_tpu_torch.align.engine import encode_read
    from lariat_tpu_torch.index import native_ops
    from lariat_tpu_torch.ops import _build, smem_device as sd
    reads = qs + [encode_read(s) for s in LOW_COMPLEXITY]
    want = native_ops.collect_seeds_rbegs_batch(fm, reads, opt)
    if want is None:
        raise RuntimeError("native seeding unavailable")
    _build.reset_launches()
    got = sd.collect_seeds_rbegs_device(fmd, g, fm, reads, opt)
    n = _build.launches()["smem_exhaustive"]
    if g.sa_samples is not None:
        raise AssertionError("the seeding path uploaded the SA samples")
    if not len(got[0]) == len(got[1]) == len(want[0]) == len(reads):
        raise AssertionError("fallback collect: read count")
    for i, (gm, gr, wm, wr) in enumerate(zip(*got, *want)):
        if not (np.array_equal(gm, np.asarray(wm).reshape(-1, 5))
                and np.array_equal(gr, np.asarray(wr))):
            raise AssertionError(f"fallback collect: read {i} differs from "
                                 f"the native seeder")
    n_mems = sum(len(m) for m in got[0])
    print(f"  fallback collect: {len(reads)} reads ({len(LOW_COMPLEXITY)} "
          f"low-complexity), {n_mems} seeds, "
          f"{sum(len(r) for r in got[1])} rbegs, equal to native; K4b "
          f"launched {n} times")
    return n


def phase_align_step(fasta, pk, logs):
    """K7, K8, K1's step entry and K5's lookup entry against their twins on
    phase 4's index (int32 and int64), each timed at the align step's
    shapes with its bound; K7, K8 and the step entry past 2^31 on
    synthetic tables; then both align steps at 8,192 x 151 against the
    same steps on the twins, with the launches of the int32 kernel run;
    then tools/device_step.py. Returns (name -> (max abs err, kernel ms,
    plain ms, shape, bound ms, what sets it, info), the step entry's
    numbers, the step run's launches)."""
    import numpy as np
    import torch
    from lariat_tpu_torch.align.ksw import fill_score_matrix
    from lariat_tpu_torch.cli import load_reference
    from lariat_tpu_torch.ops import _build, fm_batch, resident, sw_batch
    from lariat_tpu_torch.ops import sw_extend
    from lariat_tpu_torch.parallel import align_step as st
    from lariat_tpu_torch.tools.device_step import step_reads
    from lariat_tpu_torch.tools.kernel_roofline import OPS_PER_CELL
    from lariat_tpu_torch.tools.kernel_turns import events_ms
    dev = torch.device("cuda")
    fm = load_reference(fasta)
    fmd = fm_batch.DeviceFMIndex.from_host(fm, dev)
    fmd64 = fm_batch.DeviceFMIndex(fmd.fused, fmd.L2.long(), fmd.primary,
                                   fmd.seq_len)
    genomes = {f.idx_dtype: st.DeviceGenome.from_host(fm, f)
               for f in (fmd, fmd64)}
    g = genomes[fmd.idx_dtype]
    B, L, seed_len, window = STEP_B, STEP_L, 32, 32
    reads_np, starts = step_reads(fm, B, L)
    mat = fill_score_matrix(1, 4)
    ext = dict(h0=st.STEP_H0, match_sc=1, mismatch_sc=-4, n_sc=-1,
               **st.STEP_SCORING)

    def put(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    def no_rows():
        return torch.zeros(fmd.fused.shape[0], dtype=torch.bool, device=dev)

    def same(got, want, what):
        for a, b in zip(got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"{what} differs from its twin "
                                     f"(max abs err {_max_abs_err(a, b)})")

    res = {}
    # K7 on the edges, on the reads as they are (the suffix form masks in
    # the kernel): Ns at the first base, the last, mid-read and in the seed
    # suffix; lens 0, 1, under and at the seed length, L, and past L + 31;
    # both rules, both forms, int32 and int64; its occ1 entry on rows
    # around primary
    rng = np.random.default_rng(31)
    er, el = reads_np[:4096].copy(), np.full(4096, L, np.int32)
    el[:64] = rng.integers(0, 40, 64)
    el[:8] = 0, 1, seed_len - 1, seed_len, L, L + 1, L + seed_len, L + 200
    rows = np.arange(64, 4096)
    er[rows[:512], 0] = 4
    er[rows[512:1024], el[rows[512:1024]] - 1] = 4
    er[rows[1024:1536], L // 2] = 4
    er[rows[1536:2048], L - 1 - rng.integers(1, seed_len, 512)] = 4
    es = np.maximum(el - seed_len, 0).astype(np.int32)
    p = fm.primary
    k1 = np.concatenate([np.arange(p - 300, p + 300), [-1, 0, fm.seq_len],
                         rng.integers(0, fm.seq_len, 60000)])
    c1 = rng.integers(0, 4, len(k1)).astype(np.int32)
    for f in (fmd, fmd64):
        for skip_n, start, mi in ((False, None, None), (True, es, seed_len),
                                  (True, None, None), (False, es, seed_len)):
            a = (put(er), put(el), None if start is None else put(start),
                 mi, skip_n)
            same(fm_batch.backward_search(f, *a),
                 fm_batch.backward_search_plain(f, *a),
                 f"K7 (skip_n {skip_n}, suffix {start is not None}, "
                 f"{f.idx_dtype})")
        kd = put(k1).to(f.idx_dtype)
        same([fm_batch.occ1_rank(f, kd, put(c1))],
             [fm_batch.occ1_batch(f, kd, put(c1))], "K7's occ1 entry")
    # K7 at the step's shape: the seed suffixes of the step's reads, read
    # in place, with its count of each read's rank steps
    rd, lens = put(reads_np), put(np.full(B, L, np.int32))
    s0 = torch.clamp(lens - seed_len, min=0)
    k7 = (fmd, rd, lens, s0, seed_len, True)
    t7 = no_rows()
    kk, ll = fm_batch.backward_search_plain(*k7, touched=t7)
    chain = torch.full((B,), -1, dtype=torch.int32, device=dev)
    got = fm_batch.backward_search(*k7, steps=chain)
    same(got, (kk, ll), "K7 at the step's shape")
    ms7 = _median_ms(lambda: fm_batch.backward_search(*k7))
    dev7 = events_ms(lambda: fm_batch.backward_search(*k7))
    longest = int(chain.max())
    # the bytes it must move: each read's seed bases, start and lens, the
    # distinct fused rows its ranks read, the intervals out
    res["exact_match"] = (0, ms7, _median_ms(
        lambda: fm_batch.backward_search_plain(*k7), n=3), (B, L, seed_len),
        *_bound(pk, 0, 48 * int(t7.sum()) + B * seed_len + _nbytes(
            lens, s0, *got)),
        {"rows_distinct": int(t7.sum()), "hits": int((kk <= ll).sum()),
         "dev_ms": dev7, "longest_chain": longest,
         "mean_chain": float(chain.float().mean()),
         "us_per_step": 1e3 * dev7 / max(longest, 1)})
    # K8 (off the steps' path; the port of fetch_window_batch): negative
    # starts, starts near and past l_pac, every offset
    n = fm.l_pac
    wl = L + window
    fs = np.concatenate([np.arange(-wl - 20, 20), np.arange(n - wl - 20,
                                                            n + 20),
                         np.arange(16) + 16 * rng.integers(0, n // 16, 1),
                         rng.integers(-wl, n, 8000)])
    for gg in genomes.values():
        sd = put(fs, np.int64)
        same([st.fetch_window_batch(gg, sd, wl)],
             [st.fetch_window_batch_plain(gg, sd, wl)], "K8")
    # K5's lookup entry on the step's rows (the suffix hits' first rows,
    # row 0 elsewhere) and LF's edge rows, against the twin and the host
    # lookup
    rows5 = torch.where(kk <= ll, kk, 0).cpu().numpy().astype(np.int64)
    rows5[:6] = [0, p, p - 1, p + 1, fm.seq_len, fm.seq_len - 1]
    for gg in genomes.values():
        kd = put(rows5).to(gg.fmd.idx_dtype)
        got = st.sa_lookup_batch(gg, kd)
        same([got], [st.sa_lookup_batch_plain(gg, kd)], "K5's lookup entry")
        if not np.array_equal(got.cpu().numpy(),
                              st.sa_lookup_batch_host(gg, fm, rows5)):
            raise AssertionError("K5's lookup entry differs from "
                                 "sa_lookup_batch_host")
    kd = put(rows5).to(fmd.idx_dtype)
    t5 = no_rows()
    st.sa_lookup_batch_plain(g, kd, touched=t5)
    pos_fmd = st.sa_lookup_batch(g, kd)
    res["sa_lookup"] = {
        "ms": _median_ms(lambda: st.sa_lookup_batch(g, kd)),
        "plain_ms": _median_ms(lambda: st.sa_lookup_batch_plain(g, kd), n=3),
        "rows": B, "rows_distinct": int(t5.sum())}
    bms, by = _bound(pk, 0, 48 * int(t5.sum()) + 8 * B
                     + _nbytes(kd, pos_fmd))
    res["sa_lookup"].update(bound_ms=bms, bound_by=by)
    # K8 at the step's shape: the step's own windows (the lookup's hits,
    # forward-projected)
    isr, fwd = st.forward_start(g, pos_fmd, s0, lens)
    got = st.fetch_window_batch(g, fwd, wl)
    same([got], [st.fetch_window_batch_plain(g, fwd, wl)], "K8 at the step")
    pos = fwd.cpu().numpy()[:, None] + np.arange(wl)[None, :]
    words = np.unique(pos[(pos >= 0) & (pos < n)] >> 4)
    res["fetch_window"] = (0, _median_ms(lambda: st.fetch_window_batch(
        g, fwd, wl)), _median_ms(lambda: st.fetch_window_batch_plain(
            g, fwd, wl), n=3), (B, wl),
        *_bound(pk, 0, 4 * len(words) + _nbytes(fwd, got)),
        {"pac_words_distinct": int(len(words)), "step_launches": 0})
    # K1's step entry on the edges (reverse hits, windows across 0 and
    # l_pac, unmapped lanes at -1 - qb, Ns, short reads), then at the
    # step's shape against the twin and against the path it replaces (K8,
    # the orientation, the tile entry), with its bound
    pac = g.pac()
    ef = rng.integers(0, n - L, 4096).astype(np.int64)
    ef[:8] = [-20, -5, -wl - 3, 0, n - L, n - L + 10, n - 3, n + 5]
    ef[8:12] = -1 - np.array([0, 5, 58, 118])
    eisr = put(rng.random(4096) < 0.5)
    for gg in genomes.values():
        a = (put(er), put(np.minimum(el, L)), put(ef), eisr, gg.pac(),
             gg.l_pac, window)
        same([sw_extend.extend_step(*a, **ext)],
             [sw_extend.extend_step_plain(*a, **ext)],
             f"K1's step entry on the edges ({gg.fmd.idx_dtype})")
    sa = (rd, lens, fwd, isr, pac, n, window)
    want = sw_extend.extend_step_plain(*sa, **ext)
    same([sw_extend.extend_step(*sa, **ext)], [want],
         "K1's step entry at the step")
    tgt = st.fetch_window_batch(g, fwd, wl)
    qry = sw_extend.orient_reads(rd, lens, isr)
    full = [torch.full((B,), v, dtype=torch.int32, device=dev)
            for v in (wl, window, st.STEP_H0)]
    tiles = dict((k, v) for k, v in ext.items() if k != "h0")

    def k8_orient_tiles():
        t = st.fetch_window_batch(g, fwd, wl)
        q = sw_extend.orient_reads(rd, lens, isr)
        return sw_extend.extend_batch(q, lens, t, *full, **tiles)

    same([k8_orient_tiles()], [want], "K8 + orientation + the tile entry")
    _, rows_run = sw_batch.extend_batch(
        qry, lens, tgt, full[0], sw_extend.score_matrix(1, -4, -1, dev),
        full[1], full[2], packed=True, rows_run=True, **st.STEP_SCORING)
    rows_np = rows_run.cpu().numpy()
    w_eff = sw_batch._adjust_w(lens.cpu(), full[1].cpu(), 1, 5, 6, 1, 6,
                               1).numpy()
    cells = _band_cells(np.full(B, L), rows_np, w_eff)
    step_bytes = (B * L + _nbytes(lens, fwd, isr, want) + 4 * len(words))
    sbms, sby = _bound(pk, OPS_PER_CELL["extend"] * cells, step_bytes)
    step = {"ms": _median_ms(lambda: sw_extend.extend_step(*sa, **ext)),
            "dev_ms": events_ms(lambda: sw_extend.extend_step(*sa, **ext)),
            "k8_orient_tiles_dev_ms": events_ms(k8_orient_tiles),
            "plain_ms": _median_ms(
                lambda: sw_extend.extend_step_plain(*sa, **ext), n=3),
            "k8_orient_tiles_ms": _median_ms(k8_orient_tiles),
            "tiles_ms": _median_ms(lambda: sw_extend.extend_batch(
                qry, lens, tgt, *full, **tiles)),
            "bound_ms": sbms, "bound_by": sby, "rows_run": int(rows_np.sum()),
            "band_cells": cells,
            "warp_steps": _k1_steps(lambda s: sw_extend.extend_step(
                *sa, steps=s, **ext), want, B)}
    for name in ("exact_match", "fetch_window"):
        e, ms, pms, shape, bms, by, info = res[name]
        print(f"  {name} {shape}: exact in int32 and int64; kernel "
              f"{ms:.3f} ms, plain {pms:.3f} ms; bound {bms:.4f} ms ({by}), "
              f"{100 * bms / ms:.1f}% of it; {json.dumps(info)}")
    print(f"  K1 step entry ({B} x {L}, window {wl}): exact on the edges and "
          f"at the step, equal to K8 + orientation + the tile entry; "
          f"{json.dumps(step)}")
    print(f"  K5 lookup entry ({B} rows): exact in int32 and int64, equal to "
          f"sa_lookup_batch_host; {json.dumps(res['sa_lookup'])}")
    _past_2_31(put, same)

    # the align steps at 8,192 x 151: the kernels' run counted
    steps = (st.align_step_smem, st.align_step)
    _build.reset_launches()
    runs = [fn(g, rd, lens, mat) for fn in steps]
    torch.cuda.synchronize()
    launches = _build.launches()
    entries = _build.entry_launches()
    for gg in genomes.values():
        for fn, got in zip(steps, runs if gg is g else
                           [fn(gg, rd, lens, mat) for fn in steps]):
            want = fn(gg, rd, lens, mat, plain=True)
            same(got, want, f"{fn.__name__} ({gg.fmd.idx_dtype})")
    # every extension through the step entry: no window fetch (K8) and no
    # oriented copy; the seed mask is K7's own
    want_on = {"smem_exhaustive": 1, "sa_walk": 2, "fetch_window": 0,
               "sw_extend": 2, "exact_match": 1}
    if any(launches[k] != v for k, v in want_on.items()) or \
            entries["lariat_sa_lookup"] != 2 or \
            entries["lariat_sw_extend_step"] != 2:
        raise AssertionError(f"the align steps' launches: {launches}, "
                             f"{entries}")
    for fn, r in zip(steps, runs):
        mapped = r.mapped.cpu().numpy()
        at = (r.pos.cpu().numpy() == starts) & mapped
        print(f"  {fn.__name__} ({B} x {L}): every field equal to the twins' "
              f"in int32 and int64; mapped {mapped.mean():.4f}, at the "
              f"planted start {at.mean():.4f}")
    print(f"  align step launches: {json.dumps(launches)}; entries "
          f"{json.dumps(entries)}")
    out = _last_json(
        _run([sys.executable, "-m", "lariat_tpu_torch.tools.device_step",
              fasta], timeout=600, log=os.path.join(logs, "device_step.log")),
        ("device", "card", "B", "L", "device_step_pairs_s", "device_step_ms",
         "device_step_mapped_frac", "device_step_parts_ms",
         "exact_step_pairs_s", "exact_step_ms", "exact_step_mapped_frac",
         "exact_step_parts_ms", "launches"), "device_step")
    if not (out["B"] == B and out["device_step_pairs_s"] > 0
            and out["device_step_mapped_frac"] > 0.9):
        raise AssertionError(f"device_step: {out}")
    print(f"  device_step: {json.dumps(out)}")
    res["sa_lookup"]["step_launches"] = entries["lariat_sa_lookup"]
    step["step_launches"] = entries["lariat_sw_extend_step"]
    return res, step, launches


# the synthetic tables past 2^31: a text of 2.4e9 codes (a multiple of
# 128), its primary row past 2^31
BIG_SEQ_LEN, BIG_PRIMARY = 2_400_000_000, 2_200_000_017


def _past_2_31(put, same):
    """K7 (both entries), K8 and K1's step entry against their twins at
    positions and rows on both sides of 2^31, int64 indices: a valid rank
    table of a random text of 2.4e9 codes made on the card (checkpoints the
    running counts of its words; about 0.9 GB) and a random 2-bit pac of
    as many bases (about 600 MB). The text's second half is the complement
    of its first, so each code is as frequent as its complement, as in a
    doubled text: a bidirectional interval then stays inside the table.
    Then the seeding kernels, K9 and K1's descriptor entry on the same
    tables (``_seeding_past_2_31``)."""
    import numpy as np
    import torch
    from lariat_tpu_torch.ops import fm_batch, resident, sw_extend
    from lariat_tpu_torch.parallel import align_step as st
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(41)
    n, nb, two31 = BIG_SEQ_LEN, BIG_SEQ_LEN // 128, 1 << 31
    w = torch.randint(0, 1 << 32, (nb, 8), generator=gen, device=dev)
    w[nb // 2:] = w[:nb // 2] ^ ((1 << 32) - 1)
    counts = torch.stack([fm_batch._popcount32(fm_batch._match(w, c)).sum(1)
                          for c in range(4)], dim=1)
    ckpt = torch.zeros((nb + 1, 4), dtype=torch.int64, device=dev)
    ckpt[1:] = counts.cumsum(0)
    fused = torch.zeros((nb + 1, 12), dtype=torch.int32, device=dev)
    fused[:, :4] = ckpt.to(torch.int32)
    fused[:nb, 4:] = (w - (w >> 31) * (1 << 32)).to(torch.int32)
    del w, counts
    L2 = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                    ckpt[-1].cumsum(0)])
    big = fm_batch.DeviceFMIndex(fused, L2, BIG_PRIMARY, n)
    rng = np.random.default_rng(43)
    B, L = 4096, STEP_L
    reads = rng.integers(0, 4, (B, L)).astype(np.uint8)
    reads[rng.random((B, L)) < 0.01] = 4
    lens = np.full(B, L, np.int32)
    lens[:64] = rng.integers(0, L + 40, 64)
    start = np.maximum(lens - 32, 0).astype(np.int32)
    touched = torch.zeros(nb + 1, dtype=torch.bool, device=dev)
    for skip_n, s, mi in ((True, start, 32), (False, start, 32),
                          (False, None, None)):
        a = (put(reads), put(lens), None if s is None else put(s), mi, skip_n)
        same(fm_batch.backward_search(big, *a),
             fm_batch.backward_search_plain(big, *a, touched=touched),
             f"K7 past 2^31 (skip_n {skip_n}, suffix {s is not None})")
    lo, hi = int(touched[:two31 >> 7].sum()), int(touched[two31 >> 7:].sum())
    k = np.concatenate([np.arange(two31 - 300, two31 + 300),
                        np.arange(BIG_PRIMARY - 200, BIG_PRIMARY + 200),
                        [-1, 0, n - 1, n], rng.integers(0, n + 1, 20000)])
    kd = put(k).to(torch.int64)
    cd = put(rng.integers(0, 4, len(k)), np.int32)
    same([fm_batch.occ1_rank(big, kd, cd)],
         [fm_batch.occ1_batch(big, kd, cd)], "K7's occ1 entry past 2^31")
    pac = torch.randint(0, 1 << 32, (n // 16,), generator=gen, device=dev)
    pac = (pac - (pac >> 31) * (1 << 32)).to(torch.int32)
    g = st.DeviceGenome(fmd=big, sa_intv=32, l_pac=n, pac_words=pac)
    wl = L + 32
    fs = np.concatenate([np.arange(two31 - wl - 20, two31 + 20),
                         np.arange(n - wl - 20, n + 20),
                         rng.integers(-wl, n, 4000)])
    sd = put(fs, np.int64)
    same([st.fetch_window_batch(g, sd, wl)],
         [st.fetch_window_batch_plain(g, sd, wl)], "K8 past 2^31")
    # the step entry on reads planted at their windows, both strands
    fwd = sd[:2048]
    isr = put(np.arange(2048) % 2 == 1)
    sl = put(np.full(2048, L, np.int32))
    win = resident.fetch_forward_batch(pac, n, fwd, L).to(torch.uint8)
    rd = sw_extend.orient_reads(win, sl, isr)
    ext = dict(h0=st.STEP_H0, match_sc=1, mismatch_sc=-4, n_sc=-1,
               **st.STEP_SCORING)
    a = (rd, sl, fwd, isr, pac, n, 32)
    got = sw_extend.extend_step(*a, **ext)
    same([got], [sw_extend.extend_step_plain(*a, **ext)],
         "K1's step entry past 2^31")
    full = int((got[0] >= L).sum())
    print(f"  past 2^31 (int64; text and pac of {n} bases, primary "
          f"{BIG_PRIMARY}): K7 both rules and forms equal to the twin over "
          f"{lo} fused rows below 2^31 and {hi} above, its occ1 entry on "
          f"{len(k)} rows, K8 on {len(fs)} windows, the step entry on 2048 "
          f"planted reads ({full} scored the whole read)")
    if not (lo and hi and full):
        raise AssertionError("the checks past 2^31 missed a side of it")
    sides = _seeding_past_2_31(big, g, pac, put, same)
    print(f"  past 2^31, [below, above] 2^31 on each kernel's side: fused "
          f"rows its twin read (K4a-K4c, K5), kept x0 values (K9), target "
          f"positions (K1's descriptor entry): {json.dumps(sides)}")
    if not all(lo and hi for lo, hi in sides.values()):
        raise AssertionError(f"a kernel past 2^31 touched one side: {sides}")
    del g, big, fused, pac
    torch.cuda.empty_cache()


def _seeding_past_2_31(big, g, pac, put, same):
    """On ``_past_2_31``'s tables (int64 indices), against their twins:
    K4a's slots entry and planes entry at round 1 (start 0, mid L + 2) and
    round 2 (bwd_init, mids inside the reads) on 4,096 random reads x L
    192 with 1% N; K9 in both layouts on those planes (min_seed 0; the
    rounds' caps, then 1 and L in turn); K4b on every (read, e) lane of
    512 of the reads; K4c; K5's walk from rows around 2^31, around the
    primary row and at random; K1's descriptor entry on 4,096 extensions
    (both directions) whose target windows straddle 2^31 or l_pac, the
    seam of the doubled text, their queries planted from the windows.
    Returns
    {kernel: [below, above]}: the fused rows its twin read below and
    above position 2^31, K9's kept x0 values and K1's target positions."""
    import numpy as np
    import torch
    from lariat_tpu_torch.ops import resident, smem_device as sd
    from lariat_tpu_torch.ops import sw_batch, sw_extend
    from lariat_tpu_torch.parallel import align_step as st
    dev = big.fused.device
    n, two31 = big.seq_len, 1 << 31
    cut = two31 >> 7                 # the first fused row past 2^31
    rng = np.random.default_rng(47)
    R, L, min_seed = 4096, 192, 19
    reads = rng.integers(0, 4, (R, L)).astype(np.uint8)
    reads[rng.random((R, L)) < 0.01] = 4
    lens = rng.integers(100, L + 1, R).astype(np.int32)
    lens[:3] = 0, 1, L
    reads[np.arange(L)[None, :] >= lens[:, None]] = 4
    rd, ld = put(reads), put(lens)
    sides = {}

    def rows():
        return torch.zeros(big.fused.shape[0], dtype=torch.bool, device=dev)

    def count(name, touched):
        sides[name] = [int(touched[:cut].sum()), int(touched[cut:].sum())]

    mid2 = rng.integers(0, np.maximum(lens, 1)).astype(np.int32)
    rounds = {"round 1": (put(np.zeros(R), np.int32), put(np.ones(R),
                                                           np.int64),
                          put(np.full(R, L + 2), np.int32), 8 * L, False,
                          sd.CAP1),
              "round 2": (put(mid2), put(rng.integers(1, 6, R), np.int64),
                          put(mid2), 4 * L, True, sd.CAP2)}
    t_slots, t_planes, kept = rows(), rows(), []
    for name, (se, mi, md, steps, bwd, cap) in rounds.items():
        budget = sd._budget(steps)
        got = sd.min_starts_twoptr(big, rd, se, ld, mi, L, max_steps=steps,
                                   min_seed=min_seed, cap=cap, mid=md,
                                   bwd_init=bwd)
        want = sd.min_starts_twoptr_plain(big, rd, se, ld, mi, md, L, budget,
                                          bwd, min_seed, cap, t_slots)
        sd._twoptr_flags(want[0], want[2], cap)
        same(got, want, f"K4a's slots entry past 2^31 ({name})")
        pl = sd.min_starts_twoptr_planes(big, rd, se, ld, mi, L,
                                         max_steps=steps, bwd_init=bwd)
        same(pl[:5] + pl[6:], sd.min_starts_twoptr_plain(
            big, rd, se, ld, mi, None, L, budget, bwd, 0, 0, t_planes,
            planes=True), f"K4a's planes entry past 2^31 ({name})")
        # min_seed 0: random reads hold few SMEMs of 19 bases
        a = (*pl[:5], se, ld, md)
        for cp in (cap, 1, L):
            got = sd.compact_starts(*a, 0, cp)
            same(got, sd.compact_starts_plain(*a, 0, cp),
                 f"K9 past 2^31 ({name}, cap {cp})")
            same([sd.compact_starts_packed(*a, pl[5], 0, cp)],
                 [sd.compact_starts_packed_plain(*a, pl[5], 0, cp)],
                 f"K9's packed layout past 2^31 ({name}, cap {cp})")
        filled = torch.arange(L, device=dev)[None, :] < got[5][:, None]
        kept.append(got[2][filled])
    count("smem_twoptr", t_slots)
    count("smem_planes", t_planes)
    x0 = torch.cat(kept)
    sides["compact"] = [int((x0 < two31).sum()), int((x0 >= two31).sum())]
    # K4b over every (read, e) lane of the first 512 reads
    ri = put(np.repeat(np.arange(512), L), np.int32)
    ee = put(np.tile(np.arange(1, L + 1), 512), np.int32)
    mi = put(np.ones(512 * L), np.int64)
    t4b = rows()
    same(sd.min_starts_kernel(big, rd, ri, ee, mi, L),
         sd.min_starts_kernel_plain(big, rd, ri, ee, mi, L, t4b),
         "K4b past 2^31")
    count("smem_exhaustive", t4b)
    t4c = rows()
    s1 = (big, rd, ld, 20, L, min_seed, L // min_seed + 2)
    same(sd.strategy1(*s1), sd.pack_r3(*sd.strategy1_plain(*s1, t4c)),
         "K4c past 2^31")
    count("smem_strategy1", t4c)
    # K5's walk at the lookup's budget
    p = big.primary
    k = np.concatenate([np.arange(two31 - 2000, two31 + 2000),
                        np.arange(p - 2000, p + 2000), [0, n - 1, n],
                        rng.integers(0, n + 1, 8000)])
    kd = put(k, np.int64)
    z = torch.zeros_like(kd)
    t5 = rows()
    same([st.sa_walk_chunk(g, kd, z, z.bool(), st.LOOKUP_STEPS)],
         [st.sa_walk_chunk_plain(g, kd, z, z.bool(), st.LOOKUP_STEPS, t5)],
         "K5's walk past 2^31")
    count("sa_walk", t5)
    # K1's descriptor entry: right extensions start below a seam and run
    # across it, left ones start above it and run back across it
    B, Lq, Lt, ql = 4096, 192, 256, 151
    seam = np.where(np.arange(B) < B // 2, two31, n)
    right = rng.random(B) < 0.5
    tdir = np.where(right, 1, -1)
    tstart = seam + np.where(right, -rng.integers(1, 150, B),
                             rng.integers(0, 150, B))
    tlen = np.minimum(ql + rng.integers(0, 100, B), Lt)
    codes = resident.fetch_fmd_batch(pac, n, put(tstart, np.int64),
                                     put(tdir, np.int64), ql).cpu().numpy()
    qr = np.where(right[:, None], codes, codes[:, ::-1]).astype(np.uint8)
    mut = rng.random(qr.shape) < 0.02
    qr[mut] = (qr[mut] + 1) % 4
    qr[rng.random(qr.shape) < 0.01] = 4
    qm = np.full((B, Lq), 4, np.uint8)
    qm[:, :ql] = qr
    h0 = rng.integers(19, 152, B)
    w = np.where(rng.random(B) < 0.8, 100, rng.integers(0, 100, B))
    desc = resident.pack_desc(np.arange(B), np.where(right, 0, ql - 1),
                              tdir, np.full(B, ql), tstart, tdir, tlen, h0,
                              w, n)
    rdq, dd = put(qm), put(desc)
    got = sw_extend.extend_desc(rdq, pac, n, dd, Lq, Lt)
    q, t = resident.build_qt(rdq, pac, n, dd, Lq, Lt)
    cols = [dd[:, c].to(torch.int32).contiguous() for c in (
        resident.D_QL, resident.D_TL, resident.D_W, resident.D_H0)]
    want = sw_batch.extend_batch(q, cols[0], t, cols[1],
                                 sw_extend.score_matrix(1, -4, -1, dev),
                                 cols[2], cols[3], packed=True)
    same([got[:6], got[6:]], [want, torch.zeros_like(got[6:])],
         "K1's descriptor entry past 2^31")
    pos = tstart[:, None] + np.arange(Lt)[None, :] * tdir[:, None]
    pos = pos[np.arange(Lt)[None, :] < tlen[:, None]]
    sides["sw_extend"] = [int((pos < two31).sum()), int((pos >= two31).sum())]
    gained = int((got[0] > torch.from_numpy(h0).to(dev)).sum())
    print(f"  past 2^31, seeding: K4a (both entries, rounds 1 and 2), K9 "
          f"(both layouts, caps {sd.CAP1}/{sd.CAP2}, 1, L), K4b ({512 * L} "
          f"lanes), K4c, K5's walk ({len(k)} rows) and K1's descriptor "
          f"entry ({B} extensions across 2^31 and l_pac, {gained} gained on "
          f"h0, int64 descriptors) equal to their twins")
    if not gained:
        raise AssertionError("K1 past 2^31: no extension scored")
    return sides


def _bam_records(path: str):
    """(record bytes past the header, record count) of a BAM: BGZF is
    multi-member gzip, so the stdlib reads it."""
    import gzip
    import struct
    with gzip.open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"BAM\x01":
        raise AssertionError(f"{path}: not a BAM")
    (l_text,) = struct.unpack_from("<i", data, 4)
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 8 + l_name
    body = data[off:]
    n, pos = 0, 0
    while pos < len(body):
        pos += 4 + struct.unpack_from("<i", body, pos)[0]
        n += 1
    if pos != len(body):
        raise AssertionError(f"{path}: truncated record")
    return body, n


def _cli(module, mode, fasta, reads, out_dir, threads, log, env):
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.time()
    stdout = _run([sys.executable, "-m", module, "-reads", reads, "-genome",
                   fasta, "-output", out_dir, "-threads", str(threads),
                   "-use_device", mode, "-first_chunk"], timeout=900,
                  log=log, env=env)
    return stdout, time.time() - t0


def _summary(stdout):
    m = re.search(r"Processed (\d+) read pairs across (\d+) barcodes in "
                  r"([\d.]+)s \(([\d.]+) pairs/s\)", stdout)
    if not m:
        raise AssertionError("no 'Processed' summary line")
    return int(m.group(1)), float(m.group(4))


def _last_json(stdout, keys, what):
    """The last JSON line of a tool's output, holding every key of
    ``keys``."""
    lines = [s for s in stdout.splitlines() if s.startswith("{")]
    if not lines:
        raise AssertionError(f"{what}: no JSON line")
    out = json.loads(lines[-1])
    missing = set(keys) - set(out)
    if missing:
        raise AssertionError(f"{what}: final JSON lacks {sorted(missing)}")
    return out


def _check_roofline(roof):
    """The kernel roofline's JSON line (run by the bench): every section,
    every share of a peak in (0, 100%], the seeding section's counts."""
    from lariat_tpu_torch.tools.kernel_roofline import shares
    missing = {"device", "card", "attributes", "peaks", "extend",
               "global_tb", "local_2pass", "smem_seed", "fm_rank",
               "launches"} - set(roof)
    if missing:
        raise AssertionError(f"kernel_roofline lacks {sorted(missing)}")
    sh = shares(roof)
    if len(sh) != 6 or not all(0 < v <= 100 for v in sh.values()):
        raise AssertionError(f"kernel_roofline shares: {sh}")
    print(f"  kernel_roofline peaks {json.dumps(roof['peaks'])}")
    for k in ("extend", "global_tb", "local_2pass", "smem_seed", "fm_rank"):
        print(f"  kernel_roofline {k}: {json.dumps(roof[k])}")
    seed = roof["smem_seed"]
    if not (seed.get("reads_per_s", 0) > 0
            and seed.get("rbegs_total", 0) >= seed.get("mems_total", 0) > 0):
        raise AssertionError(f"kernel_roofline smem_seed: {seed}")
    if not 0 < roof["fm_rank"].get("bound_ms", 0) < roof["fm_rank"]["ms"]:
        raise AssertionError(f"kernel_roofline fm_rank: {roof['fm_rank']}")


def phase_tools(fasta, reads, env, logs):
    """The T1 ablation and the priming profile, each a subprocess of its
    own (the roofline runs in the bench); returns the ablation tool's T1
    launch count."""
    from lariat_tpu_torch.ops import extend_ablate

    def tool(name, *args, log=None, **extra_env):
        return _run([sys.executable, "-m", f"lariat_tpu_torch.tools.{name}",
                     *args], timeout=600,
                    log=os.path.join(logs, f"{log or name}.log"),
                    env={**env, **extra_env})

    out = tool("extend_ablate")
    lines = [json.loads(s) for s in out.splitlines() if s.startswith("{")]
    names = [x.get("variant") for x in lines[:-1]]
    if names != list(extend_ablate.VARIANTS):
        raise AssertionError(f"extend_ablate: variants {names}")
    for x in lines[:-1]:
        if not (x.get("ms", 0) > 0 and x.get("padded_cells_per_s", 0) > 0):
            raise AssertionError(f"extend_ablate: bad line {x}")
        print(f"  extend_ablate {x['variant']} (Lt {x['Lt']}): "
              f"{x['ms']:.3f} ms, {x['padded_cells_per_s']:.4g} padded "
              f"cells/s")
    fin = _last_json(out, ("device", "card", "B", "Lq", "Lt", "timing",
                           "launches"), "extend_ablate")
    t1_launches = int(fin["launches"].get("extend_ablate", 0))
    print(f"  extend_ablate on {fin['card']}: {t1_launches} T1 launches")

    # the same 2,000 pairs seeded by host C++ and on the device
    for flag, seeder in (("0", "host"), ("1", "device")):
        prof = _last_json(
            tool("prime_profile", fasta, reads, str(PROFILE_PAIRS),
                 log=f"prime_profile_{seeder}", LARIAT_DEVICE_SEED=flag),
            ("device", "card", "pairs", "seeder", "index_upload_s", "seed_s",
             "seed_warm_s", "align_s", "rescue_s", "total_s", "pairs_per_s",
             "seed_profile", "prime_s", "prime_pairs_per_s", "extend_waves",
             "rescue_waves", "wave_wall_s", "launches"),
            "prime_profile")
        if not (prof["pairs"] == PROFILE_PAIRS and prof["seeder"] == seeder
                and prof["extend_waves"] > 0 and prof["rescue_waves"] > 0
                and (prof["seed_profile"] is not None) == (seeder == "device")
                and prof["prime_pairs_per_s"] > 0):
            raise AssertionError(f"prime_profile: {prof}")
        print(f"  prime_profile ({seeder} seeding): {json.dumps(prof)}")
    return t1_launches


def _port_run(fasta, reads, out, log, env):
    """One port CLI run: (pairs, pairs/s, primed, host pairs, waves, busy
    fraction, the run's kernel launch counts)."""
    stdout, wall = _cli("lariat_tpu_torch.cli", "on", fasta, reads,
                        os.path.join(SMOKE, out), THREADS, log, env)
    n, rate = _summary(stdout)
    m = re.search(r"device waves: (\d+)\s+wave wall ([\d.]+)s\s+busy "
                  r"fraction ([\d.]+)\s+primed pairs (\d+)\s+host pairs "
                  r"(\d+)", stdout)
    if not m:
        raise AssertionError(f"no device summary line in {out}")
    lm = re.search(r"kernel launches: (\{.*\})", stdout)
    if not lm:
        raise AssertionError(f"no kernel launch line in {out}")
    launches = json.loads(lm.group(1))
    em = re.search(r"kernel entry launches: (\{.*\})", stdout)
    if not em:
        raise AssertionError(f"no kernel entry launch line in {out}")
    launches["entries"] = json.loads(em.group(1))
    wm = re.search(r"sa walks: (\[.*\])", stdout)
    if not wm:
        raise AssertionError(f"no SA walk line in {out}")
    launches["walks"] = json.loads(wm.group(1))
    dev_line = re.search(r"device priming on (.*)", stdout)
    print(f"  {out}: {n} pairs, {rate} pairs/s ({wall:.1f}s wall with index "
          f"load); device waves {m.group(1)}, busy fraction {m.group(3)}; "
          f"primed {m.group(4)}, host {m.group(5)}; "
          f"{dev_line.group(1) if dev_line else '?'}")
    print(f"  kernel launches in {out}: "
          f"{json.dumps({k: v for k, v in launches.items() if k != 'walks'})}")
    return n, rate, int(m.group(4)), int(m.group(5)), launches


def _server_run(fasta, reads, env, logs):
    """The port's CLI through a resident server on the card: the server
    starts as a subprocess, builds, uploads and prewarms, and writes its
    ready file; the CLI primes through it (LARIAT_DEVICE_SOCKET) and never
    initialises CUDA; then ``stop``, and the server must exit 0 with its
    kernel launches in its log. Returns _port_run's tuple, the launches
    being the server's."""
    from lariat_tpu_torch.parallel.device_server import stop_server
    sock = os.path.join(SMOKE, "srv.sock")
    ready = os.path.join(SMOKE, "srv.ready")
    for f in (sock, ready):
        if os.path.exists(f):
            os.remove(f)
    log_path = os.path.join(logs, "server.log")
    t0 = time.time()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "lariat_tpu_torch.parallel.device_server",
             "-genome", fasta, "-socket", sock, "-ready_file", ready,
             "-idle_timeout", "600"], cwd=REPO, env=env, stdout=log,
            stderr=subprocess.STDOUT)
    try:
        while not os.path.exists(ready):
            if proc.poll() is not None or time.time() - t0 > 300:
                raise RuntimeError(f"the server never became ready "
                                   f"(exit {proc.poll()})")
            time.sleep(0.2)
        ready_s = time.time() - t0
        stdout, wall = _cli("lariat_tpu_torch.cli", "on", fasta, reads,
                            os.path.join(SMOKE, "out_port_server"), THREADS,
                            os.path.join(logs, "port_server.log"),
                            {**env, "LARIAT_DEVICE_SOCKET": sock})
        stop_server(sock)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        raise AssertionError(f"the server exited {rc}")
    if f"device priming via server ({sock}" not in stdout:
        raise AssertionError("the CLI did not prime through the server")
    if "cuda initialized in the CLI process: False" not in stdout:
        raise AssertionError("the CLI initialised CUDA beside the server")
    n, rate = _summary(stdout)
    m = re.search(r"primed pairs (\d+)\s+host pairs (\d+)", stdout)
    with open(log_path) as f:
        slog = f.read()
    lm = re.search(r"kernel launches: (\{.*\})", slog)
    em = re.search(r"kernel entry launches: (\{.*\})", slog)
    pm = re.search(r"prewarm ([\d.]+)s", slog)
    if not (m and lm and em and pm):
        raise AssertionError("no priming split, prewarm or launch line")
    launches = json.loads(lm.group(1))
    launches["entries"] = json.loads(em.group(1))
    launches["walks"] = []
    print(f"  out_port_server: {n} pairs, {rate} pairs/s ({wall:.1f}s wall "
          f"with index load); server ready after {ready_s:.1f}s (prewarm "
          f"{pm.group(1)}s of it); primed {m.group(1)}, host {m.group(2)}; "
          f"the CLI never initialised CUDA")
    print(f"  kernel launches in the server: "
          f"{json.dumps({k: v for k, v in launches.items() if k != 'walks'})}")
    return n, rate, int(m.group(1)), int(m.group(2)), launches


def _cli_walks(walks, n_launches):
    """K5's launches in the device-seeded CLI run, one per SA lookup, as
    the CLI logged them: [rows (padded), max_steps, longest walk, walks
    past 64 steps] a launch, checked against the kernel's launch count."""
    if len(walks) != n_launches or any(w["max_steps"] != 512 for w in walks):
        raise AssertionError(f"K5: {n_launches} launches for {len(walks)} "
                             f"lookups")
    out = {"cli_launches": [[w["rows"], w["max_steps"], w["longest"],
                             w["past_64"]] for w in walks]}
    print(f"  K5 in the device-seeded run ([rows, max_steps, longest walk, "
          f"walks past 64] a launch): {json.dumps(out)}")
    return out


def phase_whole_bam(runs):
    """Every BAM of each port run against host-native lariat_tpu's as a
    whole file, CL normalised (io/bamcompare.py): the decompressed streams
    in full, every BGZF block past the header at the same stream range,
    the EOF block; each file's counts printed."""
    from lariat_tpu_torch.io.bamcompare import compare_bams
    names = sorted(os.path.basename(f) for f in glob.glob(
        os.path.join(SMOKE, "out_host", "*.bam")))
    for run in runs:
        for name in names:
            rep = compare_bams(os.path.join(SMOKE, "out_host", name),
                               os.path.join(SMOKE, run, name))
            print(f"  {run}/{name}: {rep['records']} records, "
                  f"{rep['stream_bytes']} stream bytes equal (CL "
                  f"normalised); {rep['blocks_compared']} of "
                  f"{rep['blocks']} BGZF blocks ({rep['bytes_compared']} "
                  f"bytes) equal byte for byte, {rep['header_blocks']} "
                  f"holding header bytes, {rep['shifted_blocks']} shifted "
                  f"by the CL's length")


def phase_bench(env, logs):
    """python -m lariat_tpu_torch.tools.bench in a subprocess: its JSON
    line, held to the port's bench contract; returns it."""
    out = _run([sys.executable, "-m", "lariat_tpu_torch.tools.bench"],
               timeout=700, log=os.path.join(logs, "bench.log"), env=env)
    res = _last_json(out, ("metric", "value", "unit", "vs_baseline",
                           "detail"), "bench")
    print(f"  bench result: {json.dumps(res)}")
    d = res["detail"]
    host, dev = d["cli_host_native_5w"], d["cli_device_primed_5w"]
    diff = d.get("device_vs_host_diff", {})
    step = d.get("device_step_launches", {})
    srv = dev.get("server_launches", {})
    bad = []
    if not ("pairs_s" in host and "pairs_s" in dev):
        bad.append("a mode has no pairs_s")
    if not dev.get("primed_pairs", 0) > 0:
        bad.append("the device median primed no pair")
    if diff.get("sam_diff_rate") != 0.0:
        bad.append(f"device vs host diff {diff}")
    if d.get("rfa_jit_probe", {}).get("rfa_rows") != "jit":
        bad.append(f"rfa probe {d.get('rfa_jit_probe')}")
    if not d.get("device_step_pairs_s", 0) > 0:
        bad.append(f"device step {d.get('device_step_error')}")
    if "roofline" not in d:
        bad.append(f"roofline {d.get('roofline_error')}")
    else:
        _check_roofline(d["roofline"])
    if not d.get("card"):
        bad.append("no card")
    skipped = "hg38 regime SKIPPED" in res["metric"]
    if skipped == os.path.isdir(os.path.join(REPO, "data_big")):
        bad.append(f"metric {res['metric']!r} with data_big/ "
                   f"{'present' if not skipped else 'absent'}")
    # K3 runs only where a mate rescue window survives, which the bench's
    # reads (all proper pairs) never give: its count is printed, not held
    idle = [k for k in ("sw_extend", "sw_global", "traceback")
            if srv.get(k, 0) <= 0]
    idle += [k for k in ("smem_exhaustive", "sa_walk", "sw_extend")
             if step.get(k, 0) <= 0]
    if idle:
        bad.append(f"kernels never launched on the bench's paths: {idle}")
    desc = dev.get("server_entry_launches", {}).get("lariat_sw_extend_desc")
    if desc != srv.get("sw_extend"):
        bad.append(f"{desc} of {srv.get('sw_extend')} K1 launches in the "
                   f"bench's server through the descriptor entry")
    if bad:
        raise AssertionError(f"bench: {bad}")
    print(f"  bench on {d['card']}: host-native {host['pairs_s']} pairs/s, "
          f"device-primed {dev['pairs_s']} pairs/s (primed "
          f"{dev['primed_pairs']}, host {dev['host_pairs']}); server "
          f"launches {json.dumps({k: srv[k] for k in CLI_KERNELS})}; device "
          f"step {d['device_step_pairs_s']:.1f} pairs/s")
    return res


def phase_probe_entry(env, logs):
    """python -m lariat_tpu_torch.tools.probe_device (its lines printed),
    then tools/entry.py's step on the card, its launches counted, every
    field against the same step on the CPU (the plain twins)."""
    import torch
    from lariat_tpu_torch.ops import _build
    from lariat_tpu_torch.tools.entry import entry
    out = _run([sys.executable, "-m", "lariat_tpu_torch.tools.probe_device"],
               timeout=600, log=os.path.join(logs, "probe_device.log"),
               env=env)
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    for x in lines:
        print(f"  probe {json.dumps(x)}")
    want = ["device", "launch_trivial", "download_8MB", "upload_8MB",
            "download_8MB", "upload_8MB", "k1_B128", "k1_B1024",
            "k1_plain_B1024", "k1_plain_B8192", "launches"]
    if [x["probe"] for x in lines] != want:
        raise AssertionError(f"probe_device: {[x['probe'] for x in lines]}")
    if lines[-1].get("sw_extend", 0) < 2 * 4:
        raise AssertionError(f"probe_device: K1 launches {lines[-1]}")
    fn, args = entry()
    torch.cuda.synchronize()
    _build.reset_launches()
    got = fn(*args)
    torch.cuda.synchronize()
    launches = _build.launches()
    entries = _build.entry_launches()
    cfn, cargs = entry("cpu")
    want = cfn(*cargs)
    for field in got._fields:
        a = getattr(got, field).cpu()
        b = getattr(want, field)
        if not torch.equal(a, b):
            raise AssertionError(f"entry(): {field} differs from the twins")
    idle = [k for k in ("smem_exhaustive", "sa_walk", "sw_extend")
            if launches.get(k, 0) <= 0]
    if idle:
        raise AssertionError(f"entry(): no launch of {idle}")
    print(f"  entry(): align_step_smem on 64 x 100 of a 20 kb index, every "
          f"field equal to the twins on the CPU ({int(got.mapped.sum())} "
          f"mapped); launches {json.dumps({k: v for k, v in launches.items() if v})}, "
          f"entries {json.dumps({k: v for k, v in entries.items() if v})}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--logs", default=SMOKE,
                   help="directory for the CLI runs' and the tools' logs")
    args = p.parse_args(argv)
    os.makedirs(args.logs, exist_ok=True)
    with Phase("environment"):
        phase_environment()
    import torch
    with Phase("build"):
        phase_build()
    pk = _peaks()
    print(f"  peaks (card attributes): {json.dumps(pk)}")
    with Phase("kernels vs plain"):
        kres = phase_kernels(pk)
    with Phase("data"):
        fasta, reads = phase_data(SCALE, BARCODES, PAIRS_PER_BC)
    with Phase("seeding kernels vs plain"):
        sres, exh_launches, planes_launches = phase_seeding(fasta, reads,
                                                            pk)
    kres.update(sres)
    with Phase("align step kernels vs plain"):
        ares, step_entry, step_launches = phase_align_step(fasta, pk,
                                                           args.logs)
    kres.update(ares)
    env = {k: v for k, v in os.environ.items()
           if k not in ("LARIAT_TORCH_DEVICE", "LARIAT_DEVICE_SEED")}
    with Phase("host-native run"):
        host_out, host_s = _cli(
            "lariat_tpu.cli", "off", fasta, reads,
            os.path.join(SMOKE, "out_host"), THREADS,
            os.path.join(args.logs, "host.log"), env)
        n_host, rate_host = _summary(host_out)
        print(f"  host-native: {n_host} pairs, {rate_host} pairs/s "
              f"({host_s:.1f}s wall with index load)")
    # each port run is a subprocess whose CLI resets its launch counts
    # before its main loop and prints them after
    runs = {}
    env = {k: v for k, v in env.items() if not k.startswith("LARIAT_PRIME")
           and k not in ("LARIAT_DEVICE_SOCKET",
                         "LARIAT_DEVICE_SERVER_CPU_OK")}
    # the all-primed runs: the router's own knobs leave it no reason to
    # host-route (a thread for every batch the run can make, batches being
    # 512 pairs or more but the last; a tail grace past the run; no
    # dormancy)
    knobs = {"LARIAT_PRIME_THREADS":
             str(-(-BARCODES * PAIRS_PER_BC // 512)),
             "LARIAT_PRIME_TAIL_GRACE": "600", "LARIAT_PRIME_MIN_FRAC": "0"}
    print(f"  router knobs of the all-primed port runs: {json.dumps(knobs)}")
    with Phase("port run"):
        runs["out_port"] = _port_run(fasta, reads, "out_port",
                                     os.path.join(args.logs, "port.log"),
                                     {**env, **knobs})
    with Phase("port run, device seeding"):
        runs["out_port_seed"] = _port_run(
            fasta, reads, "out_port_seed",
            os.path.join(args.logs, "port_seed.log"),
            {**env, **knobs, "LARIAT_DEVICE_SEED": "1"})
    with Phase("port run, router defaults"):
        runs["out_port_default"] = _port_run(
            fasta, reads, "out_port_default",
            os.path.join(args.logs, "port_default.log"), env)
    with Phase("port run through the resident server"):
        runs["out_port_server"] = _server_run(fasta, reads, env, args.logs)
    print(f"  pairs/s: host-seeded port {runs['out_port'][1]}, "
          f"device-seeded port {runs['out_port_seed'][1]}, router defaults "
          f"{runs['out_port_default'][1]}, through the server "
          f"{runs['out_port_server'][1]}, host-native {rate_host}")
    with Phase("tools"):
        launches = {k: runs["out_port"][4].get(k, 0) for k in CLI_KERNELS}
        launches.update({k: runs["out_port_seed"][4].get(k, 0)
                         for k in SEED_KERNELS})
        launches["smem_exhaustive"] = exh_launches
        launches.update({k: step_launches[k] for k in STEP_KERNELS})
        launches.update(planes_launches)
        launches["extend_ablate"] = phase_tools(fasta, reads, env, args.logs)
    with Phase("checks"):
        want_pairs = BARCODES * PAIRS_PER_BC
        names = sorted(os.path.basename(f) for f in glob.glob(
            os.path.join(SMOKE, "out_host", "*.bam")))
        for out, (n_port, _, primed, host_pairs, _) in runs.items():
            got_names = sorted(os.path.basename(f) for f in glob.glob(
                os.path.join(SMOKE, out, "*.bam")))
            if not names or names != got_names:
                raise AssertionError(f"BAM sets differ: {names} vs "
                                     f"{got_names} ({out})")
            n_rec = 0
            for name in names:
                a, n = _bam_records(os.path.join(SMOKE, "out_host", name))
                b, _ = _bam_records(os.path.join(SMOKE, out, name))
                if a != b:
                    raise AssertionError(f"{out}/{name}: records differ from "
                                         f"host-native")
                n_rec += n
            print(f"  {out}: {len(names)} BAMs, {n_rec} records "
                  f"byte-identical to host-native")
            if out in ("out_port", "out_port_seed"):
                if not (n_host == n_port == primed == want_pairs
                        and host_pairs == 0):
                    raise AssertionError(
                        f"{out} pairs: host {n_host}, port {n_port}, primed "
                        f"{primed}, host-routed {host_pairs}; want "
                        f"{want_pairs} all primed")
            elif not (n_host == n_port == primed + host_pairs == want_pairs
                      and primed > 0):
                raise AssertionError(
                    f"{out} pairs: host {n_host}, port {n_port}, primed "
                    f"{primed}, host-routed {host_pairs}; want {want_pairs}, "
                    f"some primed")
            print(f"  {out}: primed {primed}, host-routed {host_pairs}")
        srv = runs["out_port_server"][4]
        idle = [k for k in CLI_KERNELS if srv.get(k, 0) <= 0]
        if idle:
            raise AssertionError(f"the server launched no {idle}")
        idle = [k for k in KERNEL_INFO
                if k not in OFF_PATH and launches.get(k, 0) <= 0]
        if idle:
            raise AssertionError(f"kernels never launched on their "
                                 f"path: {idle}")
        # every K1 launch of both port runs went through its descriptor
        # entry (the wave's gathers folded into the kernel)
        for out, run in runs.items():
            n_k1 = run[4].get("sw_extend", 0)
            desc = run[4]["entries"].get("lariat_sw_extend_desc", 0)
            if desc != n_k1:
                raise AssertionError(f"{out}: {desc} of {n_k1} K1 launches "
                                     f"through the descriptor entry")
        walks = _cli_walks(runs["out_port_seed"][4]["walks"],
                           launches["sa_walk"])
        if runs["out_port"][4]["walks"]:
            raise AssertionError("the host-seeded run walked the SA on the "
                                 "card")
    with Phase("whole BAM"):
        phase_whole_bam(runs)
    with Phase("bench"):
        phase_bench(env, args.logs)
    with Phase("probe and entry"):
        phase_probe_entry(env, args.logs)
    desc = runs["out_port"][4]["entries"]["lariat_sw_extend_desc"]
    extra = {"sw_extend": {"desc_launches": desc,
                           "desc_wave": kres.pop("sw_extend_desc"),
                           "step_entry": step_entry},
             "sa_walk": {**walks, "lookup_entry": kres.pop("sa_lookup")}}
    kernels = []
    for name, (src, replaces) in KERNEL_INFO.items():
        err, ms, pms, _, bms, by, *more = kres[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": pms,
                        "bound_ms": bms, "bound_by": by,
                        "library_ms": None, **(more[0] if more else {}),
                        **extra.get(name, {})})
    # what each kernel loses to its bound over its path's launches
    loss = {k["name"]: round(k["launches"] * (k["ms"] - k["bound_ms"]), 4)
            for k in kernels}
    print(f"  kernel loss, launches x (ms - bound_ms), ms: "
          f"{json.dumps(dict(sorted(loss.items(), key=lambda kv: -kv[1])))}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
