"""Per-kernel share of the card's peak for the port's DP kernels.

    python -m lariat_tpu_torch.tools.kernel_roofline        # needs CUDA

The H100 counterpart of tools/kernel_roofline.py, at its kernels and
shapes: K1 seed extension at 8192 x 192 x 576 (``ops/sw_extend``), K2
banded global DP and K2b backtrack at 2048 x 192 x 192 (``ops/sw_global``;
DP, traceback and combined times, the JAX tool's split), and the K3
two-pass local SW at 2048 x 192 x 704 (``ops/sw_local.local_two_pass``,
the rescue path's); then device seeding (``smem_seed``) and the FM rank
(``fm_rank``), below. Prints one JSON line.

Peaks come from the device (cudaDeviceGetAttribute, ``_build.
device_attributes``), not from constants:
  - int32 peak = SMs x 64 INT32 lanes per SM per clock x maximum SM clock.
    A Hopper SM has four partitions of 16 INT32 lanes; the DP kernels are
    integer add/max/compare/select work with no tensor-core shape.
  - memory peak = 2 (double data rate) x memory clock x bus width / 8.

Work is counted in the cells each recurrence needs, not in the cells a
kernel's schedule runs through: the band (K1, K2) or the qlen x tlen box
(K3). ``OPS_PER_CELL`` is the fewest int32 instructions a cell of each
recurrence needs on sm_90, one DPX instruction counting as one (loads,
stores, address arithmetic and loop control not counted), so the bound
reads the same work whatever kernel implements it:
  K3 local (native/ksw.cpp local_core)   9 = substitution score 1 (one
     PRMT from the column's profile), M 1, H = max(M, E, F, 0) 1
     (VIMNMX3 relu), E 2 and F 2 (the open term, then VIADDMNMX relu),
     the row's first argmax 2 (VIMNMX with its predicate, a select);
  K2 global (ksw_global_one)             15 = substitution 1, M 1, H with
     its direction 2 (two VIMNMX with predicates), E with its bit 3 (open
     term, extend term, VIMNMX), F with its bit 3, the direction byte
     from the four predicates 5 (two selects for H's source, two for the
     E and F bits, one OR);
  K1 extend (ksw_extend_one)             11 = substitution 1, M with the
     M == 0 quirk 3 (add, compare, select), H 1 (VIMNMX3), E 2, F 2, the
     row's argmax 2.
(PR 2 counted the one-thread kernels' own instructions, 21, 22 and 20; a
kernel with DPX could then read past 100% of its bound.)
K2b is a walk of dependent one-byte loads: its share is of the memory
peak, counting one 32-byte sector per step. K2 writes all of z, so it
also reports its share of the memory peak.

Inputs: K2 and K3 take the JAX tool's random codes and lengths. K1 does
not: with random codes nearly every lane dies under the z-drop test within
a few rows. Each K1 query is planted unmutated at the start of its target.
The row maximum then is h0 + i + 1 on the diagonal and rises every row up
to row qlen - 1; past it, the deletion path from that corner keeps each
row's maximum within o_del + rows x e_del of the best, and the z-drop test
takes the same rows back as its gap term, so its left side stays at most
o_del. Every lane runs until its band leaves the query (row qlen + w);
``_check_k1`` checks the score and ends that this implies. K1's cells are
the band cells of the rows each task ran, by the twin's count
(``band_cells_batch``), as chip_smoke.py counts them.

``smem_seed`` is the JAX tool's section of the same name: the whole device
seeding (``ops/smem_device.collect_seeds_rbegs_device``, K4a-K4c and K5)
over 2,048 reads of 151 bp, each with one substitution, from a 1 Mbp
random genome (index built in a temporary directory): reads/s of a warm
call, the first call's ms, and the mems and rbegs totals. It reports no
share of a peak. ``fm_rank`` is the JAX tool's section of that name on the
same genome: 65,536 random single-code ranks (``occ1_batch``) through K7's
``occ1`` entry (``fm_batch.occ1_rank``), checked against the twin, with
its share of the memory peak counting one 48-byte fused row a lookup (the
JAX tool counted 64 bytes) plus the rows, codes and ranks in and out.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from ..config import AlignerConfig
from ..device import get_device
from ..index import fmindex
from ..ops import (_build, fm_batch, smem_device, sw_batch, sw_extend,
                   sw_global, sw_local)
from ..parallel.align_step import DeviceGenome
from . import card, median_ms

INT32_LANES_PER_SM_CLOCK = 64
OPS_PER_CELL = {"extend": 11, "global": 15, "local": 9}
SECTOR_BYTES = 32
SCORING = dict(o_del=6, e_del=1, o_ins=6, e_ins=1, match_sc=1,
               mismatch_sc=-4, n_sc=-1)


def peaks(attrs: Dict[str, int]) -> Dict[str, float]:
    """int32 ops/s and memory bytes/s from the card's attributes."""
    return {
        "int32_ops_s": float(attrs["sm_count"] * INT32_LANES_PER_SM_CLOCK
                             * attrs["sm_clock_khz"] * 1e3),
        "mem_B_s": 2.0 * attrs["mem_clock_khz"] * 1e3
                   * attrs["mem_bus_bits"] / 8}


def band_cells(qlen: int, tlen: int, w: int) -> int:
    """Cells of a banded DP of one task over rows 0..tlen-1 with band
    [max(i - w, 0), min(i + w + 1, qlen)): what K1 visits when no lane
    stops early (its band is empty from row qlen + w on), and what K2
    visits."""
    return sum(max(0, min(i + w + 1, qlen) - max(i - w, 0))
               for i in range(tlen))


def band_cells_batch(qlen, rows, w) -> int:
    """Cells of many banded DPs: task b over its rows 0..rows[b]-1, band
    [max(i - w, 0), min(i + w + 1, qlen)) -- K1's work when rows are the
    rows each task ran (``sw_batch.extend_batch(..., rows_run=True)``) and w
    the band ``_adjust_w`` leaves."""
    qlen, rows, w = (np.asarray(a, np.int64)[:, None]
                     for a in (qlen, rows, w))
    i = np.arange(max(int(rows.max(initial=0)), 1))[None, :]
    n = np.clip(np.minimum(i + w + 1, qlen) - np.maximum(i - w, 0), 0, None)
    return int(np.where(i < rows, n, 0).sum())


def nbytes(*tensors) -> int:
    """Bytes of the tensors' elements."""
    return sum(t.numel() * t.element_size() for t in tensors)


def share(cells: float, ops: float, ms: float, peak: float) -> float:
    """Percent of ``peak`` reached by ``cells * ops`` in ``ms``."""
    return 100.0 * cells * ops / (ms * 1e-3) / peak


def _check_k1(out: torch.Tensor, qlen: int, h0: int) -> None:
    """The planted K1 lanes reach h0 + qlen at (qlen-1, qlen-1), the
    premise of counting their cells by ``band_cells``."""
    score, qle, tle = (out[k].cpu() for k in range(3))
    if not (bool((score == h0 + qlen).all()) and bool((qle == qlen).all())
            and bool((tle == qlen).all())):
        raise AssertionError("K1's planted lanes did not follow the "
                             "diagonal; the cell count would be wrong")


def measure(dev: torch.device, iters: int = 7) -> dict:
    rng = np.random.default_rng(5)
    pk = peaks(_build.device_attributes(dev.index or 0))
    int_peak, mem_peak = pk["int32_ops_s"], pk["mem_B_s"]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def full(B, v):
        return put(np.full(B, v, np.int32))

    res = {}
    # ---- K1: banded extend at the production tier 8192 x 192 x 576 ------
    B, Lq, Lt, qlen, tlen, w, h0 = 8192, 192, 576, 151, 400, 100, 30
    q = rng.integers(0, 4, (B, Lq)).astype(np.uint8)
    t = rng.integers(0, 4, (B, Lt)).astype(np.uint8)
    t[:, :qlen] = q[:, :qlen]
    args = (put(q), full(B, qlen), put(t), full(B, tlen), full(B, w),
            full(B, h0))
    ext = dict(SCORING, end_bonus=5, zdrop=100)

    def k1():
        return sw_extend.extend_batch(*args, **ext)

    _check_k1(k1(), qlen, h0)
    ms = median_ms(k1, dev, iters)
    # the band cells of the rows each task ran, as the twin counts them
    _, rows = sw_batch.extend_batch(
        args[0], args[1], args[2], args[3],
        sw_extend.score_matrix(1, -4, -1, dev), args[4], args[5],
        o_del=6, e_del=1, o_ins=6, e_ins=1, end_bonus=5, zdrop=100,
        packed=True, rows_run=True)
    w_eff = sw_batch._adjust_w(args[1], args[4], 1, 5, 6, 1, 6, 1)
    cells = float(band_cells_batch(np.full(B, qlen), rows.cpu().numpy(),
                                   w_eff.cpu().numpy()))
    res["extend"] = {
        "shape": [B, Lq, Lt], "ms": ms, "cells": cells,
        "cells_per_s": cells / (ms * 1e-3),
        "padded_cells_per_s": B * Lq * Lt / (ms * 1e-3),
        "ops_per_cell": OPS_PER_CELL["extend"],
        "int32_sol_pct": share(cells, OPS_PER_CELL["extend"], ms, int_peak)}

    # ---- K2 + K2b: reg2aln tier 2048 x 192 x 192 --------------------------
    B, Lq, Lt, qlen, tlen, w = 2048, 192, 192, 151, 160, 20
    S = Lq + Lt
    gq = put(rng.integers(0, 4, (B, Lq)).astype(np.uint8))
    gt = put(rng.integers(0, 4, (B, Lt)).astype(np.uint8))
    gql, gtl, gw = full(B, qlen), full(B, tlen), full(B, w)
    score, z = sw_global.global_batch(gq, gql, gt, gtl, gw, **SCORING)

    def dp():
        return sw_global.global_batch(gq, gql, gt, gtl, gw, **SCORING)

    def tb():
        return sw_global.traceback_ops_fused(z, gql, gtl, gw, score, S=S)

    def both():
        s2, z2 = dp()
        return sw_global.traceback_ops_fused(z2, gql, gtl, gw, s2, S=S)

    blob = tb().cpu().numpy()
    ops = blob[:, :S // 4]
    steps = int(sum(int((((ops >> (2 * k)) & 3) != 3).sum())
                    for k in range(4)))
    dp_ms, tb_ms, ms = (median_ms(f, dev, iters) for f in (dp, tb, both))
    cells = float(B) * band_cells(qlen, tlen, w)
    res["global_tb"] = {
        "shape": [B, Lq, Lt], "ms": ms, "dp_ms": dp_ms, "traceback_ms": tb_ms,
        "cells": cells, "cells_per_s": cells / (dp_ms * 1e-3),
        "padded_cells_per_s": B * Lq * Lt / (dp_ms * 1e-3),
        "ops_per_cell": OPS_PER_CELL["global"],
        "int32_sol_pct": share(cells, OPS_PER_CELL["global"], dp_ms,
                               int_peak),
        # z is written whole: its bytes bound the DP
        "mem_sol_pct": share(nbytes(gq, gt, gql, gtl, gw, score, z), 1,
                             dp_ms, mem_peak),
        "traceback_steps": steps,
        "traceback_mem_sol_pct": share(steps, SECTOR_BYTES, tb_ms, mem_peak),
        "dl_bytes_per_wave": B * (S // 4 + 12)}

    # ---- K3: local two-pass at the rescue tier 2048 x 192 x 704 -----------
    B, Lq, Lt, qlen, tlen = 2048, 192, 704, 151, 686
    largs = (put(rng.integers(0, 4, (B, Lq)).astype(np.uint8)),
             full(B, qlen),
             put(rng.integers(0, 4, (B, Lt)).astype(np.uint8)),
             full(B, tlen), full(B, 19))

    def k3():
        return sw_local.local_two_pass(*largs, **SCORING)

    out = k3().cpu().long()
    te, qe, scored = out[1], out[2], out[7].bool()
    second = int(((qe + 1) * (te + 1))[scored].sum())
    ms = median_ms(k3, dev, iters)
    cells = float(B) * qlen * tlen + second
    res["local_2pass"] = {
        "shape": [B, Lq, Lt], "ms": ms, "cells": cells,
        "second_pass_cells": second, "cells_per_s": cells / (ms * 1e-3),
        "padded_cells_per_s": 2.0 * B * Lq * Lt / (ms * 1e-3),
        "ops_per_cell": OPS_PER_CELL["local"],
        "int32_sol_pct": share(cells, OPS_PER_CELL["local"], ms, int_peak)}
    fm = random_index(rng)
    res["smem_seed"] = smem_seed(dev, rng, fm=fm)
    res["fm_rank"] = fm_rank(dev, rng, fm, mem_peak, iters)
    res["peaks"] = pk
    return res


def random_index(rng, n: int = 1 << 20):
    """The index of a random genome of n bases, built in a temporary
    directory."""
    g = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "genome.fa")
        with open(path, "w") as f:
            f.write(">c\n" + g.tobytes().decode() + "\n")
        return fmindex.build_index(path)


def fm_rank(dev: torch.device, rng, fm, mem_peak: float, iters: int = 7,
            n: int = 1 << 16) -> dict:
    """n random occ1 lookups through K7's occ1 entry: ms, lookups/s and the
    share of the memory peak."""
    fmd = fm_batch.DeviceFMIndex.from_host(fm, dev)
    k = torch.from_numpy(rng.integers(0, fm.seq_len, n)).to(dev,
                                                            fmd.idx_dtype)
    c = torch.from_numpy(rng.integers(0, 4, n).astype(np.int32)).to(dev)

    def run():
        return fm_batch.occ1_rank(fmd, k, c)

    out = run()
    if not torch.equal(out, fm_batch.occ1_batch(fmd, k, c)):
        raise AssertionError("K7's occ1 entry differs from occ1_batch")
    ms = median_ms(run, dev, iters)
    nb = 48 * n + nbytes(k, c, out)
    return {"lookups": n, "genome_bp": int(fm.l_pac), "ms": ms,
            "lookups_per_s": n / (ms * 1e-3), "bytes": nb,
            "mem_sol_pct": share(nb, 1, ms, mem_peak)}


def smem_seed(dev: torch.device, rng, n_reads: int = 2048,
              read_len: int = 151, fm=None) -> dict:
    """Device 3-round seeding plus SA walks over reads of a 1 Mbp random
    genome (``random_index``, unless ``fm`` is given): the first call's ms,
    then one warm call timed."""
    if fm is None:
        fm = random_index(rng)
    fmd = fm_batch.DeviceFMIndex.from_host(fm, dev)
    dg = DeviceGenome.from_host(fm, fmd)
    codes = fm.get_seq_codes(0, fm.l_pac)
    reads = []
    for _ in range(n_reads):
        p = int(rng.integers(0, fm.l_pac - read_len))
        seg = codes[p:p + read_len].copy()
        seg[int(rng.integers(0, read_len))] = (seg[0] + 1) % 4
        reads.append(seg)
    opt = AlignerConfig()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        # the result is downloaded to the host: the call ends synchronised
        mems, rbegs = smem_device.collect_seeds_rbegs_device(
            fmd, dg, fm, reads, opt)
        times.append(time.perf_counter() - t0)
    return {"reads": n_reads, "read_len": read_len, "genome_bp": fm.l_pac,
            "ms": times[1] * 1e3, "reads_per_s": n_reads / times[1],
            "first_run_ms": times[0] * 1e3,
            "mems_total": int(sum(len(m) for m in mems)),
            "rbegs_total": int(sum(len(r) for r in rbegs))}


def shares(res: dict) -> Dict[str, float]:
    """Every share of a peak in a ``measure`` result, by name."""
    return {f"{k}.{f}": v for k, sec in res.items() if isinstance(sec, dict)
            for f, v in sec.items() if f.endswith("_sol_pct")}


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    dev = get_device("cuda")
    _build.reset_launches()
    res = measure(dev)
    res = {"device": torch.cuda.get_device_name(dev), "card": card(dev),
           "attributes": _build.device_attributes(dev.index or 0), **res,
           "launches": _build.launches()}
    print(json.dumps(res), flush=True)
    over = {k: v for k, v in shares(res).items() if not 0 < v <= 100}
    if over:
        print(f"kernel_roofline: shares outside (0, 100]: {over}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
