"""K1, K4a, K4c and the SA lookup (K5) timed on the card, to compare two
trees of the port in one call, in turns (parent, new, new, parent):

    git archive <parent> lariat_tpu_torch | tar -x -C build/parent
    for t in build/parent . . build/parent; do
      PYTHONPATH=$t python3 lariat_tpu_torch/tools/kernel_turns.py \\
          <genome.fa> <reads.fastq.gz>
    done

Run by its path, the script times the ``lariat_tpu_torch`` that PYTHONPATH
puts first, through entry points that every tree of the port has had since
device seeding came in:
- K1, ``sw_extend.extend_batch``, on chip_smoke.py phase 3's inputs
  (``k1_inputs``: 8192 x 192 x 576, seed 1), checked against its twin;
- K4a, ``smem_device.min_starts_twoptr``, at round 1's phase-A budget (3L)
  on the first 4,096 reads of the FASTQ (``seed_batch``), checked against
  its twin, with the transitions of its longest lane (flags bits 2+);
- K4c, ``smem_device.strategy1``, on the same reads at the collect's
  max_intv, min_len and cap, checked against its twin;
- the SA lookup, ``align_step.sa_lookup_batch_host``, on chip_smoke.py
  phase 5's 65,536 random rows (seed 3), checked against the positions of
  the twin's walk.
Each time is the median of 21 calls (CUDA events around the call, its host
time included), taken three times; K4a and K4c also once in device time
alone (``events_ms``). Prints the card and, last, one JSON line.
chip_smoke.py builds its K1 and seeding inputs with the same functions;
``sa_walks.py`` times K5 alone.
"""

from __future__ import annotations

import json
import os
import sys

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


def main(argv=None) -> int:
    import torch
    from lariat_tpu_torch.cli import load_reference
    from lariat_tpu_torch.ops import fm_batch, smem_device as sd
    from lariat_tpu_torch.ops import sw_batch, sw_extend
    from lariat_tpu_torch.parallel import align_step
    from lariat_tpu_torch.tools import card, median_ms
    import lariat_tpu_torch
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        raise SystemExit("usage: kernel_turns.py <genome.fa> "
                         "<reads.fastq.gz>")
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

    q, qlen, t, tlen, w, h0 = (put(a) for a in
                               k1_inputs(np.random.default_rng(1)))
    ext = dict(o_del=6, e_del=1, o_ins=6, e_ins=1, end_bonus=5, zdrop=100)

    def k1():
        return sw_extend.extend_batch(q, qlen, t, tlen, w, h0, **ext)

    got = k1()
    want = sw_batch.extend_batch(q, qlen, t, tlen,
                                 sw_extend.score_matrix(1, -4, -1, dev), w,
                                 h0, packed=True, **ext)
    out["k1_max_abs_err"] = int((got[:6].long() - want.long()).abs().max())
    out["k1_ms"] = medians(k1)

    fm = load_reference(argv[0])
    fmd = fm_batch.DeviceFMIndex.from_host(fm, dev)
    rmat, lens, _ = seed_batch(argv[1], 4096)
    R, L = rmat.shape
    args = (fmd, put(rmat), put(np.zeros(R), np.int32), put(lens),
            put(np.ones(R), np.int64), L)
    mid = put(np.full(R, L + 2), np.int32)

    def k4a():
        return sd.min_starts_twoptr(*args, max_steps=3 * L, min_seed=19,
                                    cap=sd.CAP1, mid=mid)

    meta, big = k4a()[:2]   # newer trees also return the lanes' aux
    pm, pb, aux = sd.min_starts_twoptr_plain(
        *args[:5], mid, L, sd._budget(3 * L), False, 19, sd.CAP1)
    sd._twoptr_flags(pm, aux, sd.CAP1)
    out["k4a_max_abs_err"] = max(
        int((a.long() - b.long()).abs().max()) for a, b in
        ((meta, pm), (big, pb)))
    out["k4a_reads"] = [R, L]
    out["k4a_transitions_max"] = int(meta[0, -1]) >> 2
    out["k4a_ms"] = medians(k4a)
    out["k4a_dev_ms"] = events_ms(k4a)

    s1 = (fmd, args[1], args[3], 20, L, 19, L // 19 + 2)

    def k4c():
        return sd.strategy1(*s1)

    want = sd.pack_r3(*sd.strategy1_plain(*s1))
    out["k4c_max_abs_err"] = max(int((a.long() - b.long()).abs().max())
                                 for a, b in zip(k4c(), want))
    out["k4c_ms"] = medians(k4c)
    out["k4c_dev_ms"] = events_ms(k4c)

    g = align_step.DeviceGenome.from_host(fm, fmd)
    rows = lookup_rows(fm.seq_len)

    def lookup():
        return align_step.sa_lookup_batch_host(g, fm, rows)

    kd = torch.from_numpy(rows).to(dev, fmd.idx_dtype)
    z = torch.zeros_like(kd)
    walk = align_step.sa_walk_chunk_plain(g, kd, z, z.bool(), 512).cpu()
    want = (np.asarray(fm.sa_samples)[(walk[0].numpy() // fm.sa_intv)
                                      .astype(np.int64)]
            + walk[1].numpy().astype(np.int64))
    out["lookup_max_abs_err"] = int(np.abs(lookup() - want).max())
    out["lookup_rows"] = len(rows)
    out["lookup_ms"] = medians(lookup)
    print(json.dumps(out), flush=True)
    errs = [out[k] for k in out if k.endswith("max_abs_err")]
    return 0 if not any(errs) else 1


if __name__ == "__main__":
    sys.exit(main())
