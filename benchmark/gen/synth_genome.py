"""Repeat-structured synthetic genome generator.

Uniform-random genomes are trivially alignable (VERDICT r1 "What's weak" 6);
real genomes are ~50% repeats. This builds hg38-LIKE sequence with the repeat
classes that actually stress a linked-read aligner:

 - SINE family ("Alu"): 300 bp consensus, ~8% coverage, 8-16% divergence
 - LINE family ("L1"): 6 kb consensus, ~12% coverage, mostly 5'-truncated
   copies, 5-20% divergence
 - alpha-satellite: 171 bp monomer arrays at each contig's "centromere"
   (few-Mb arrays, 1-5% monomer divergence) — also exercises the centromere
   MAPQ zeroing (lariat.go:978-988)
 - segmental duplications: 50-300 kb blocks copied at 1-2% divergence —
   the regime the RFA method targets (reference README.md:3)
 - the rest iid random

All pasting is vectorized (copies generated as (K, L) matrices, mutated with
one random mask, scattered with flat fancy indexing), so a 3.1 Gbp genome
generates in minutes. Usage:

    python benchmark/gen/synth_genome.py out.fa --scale 1.0 --seed 7

--scale 1.0 = hg38-sized (~3.1 Gbp over 24 contigs); --scale 0.01 = ~31 Mbp.
Also importable: make_contig / write_fasta / CONTIG_SIZES / centromere_bed.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

# hg38 chromosome sizes (rounded to 0.1 Mb)
CONTIG_SIZES = [
    ("chr1", 248_900_000), ("chr2", 242_200_000), ("chr3", 198_300_000),
    ("chr4", 190_200_000), ("chr5", 181_500_000), ("chr6", 170_800_000),
    ("chr7", 159_300_000), ("chr8", 145_100_000), ("chr9", 138_400_000),
    ("chr10", 133_800_000), ("chr11", 135_100_000), ("chr12", 133_300_000),
    ("chr13", 114_400_000), ("chr14", 107_000_000), ("chr15", 101_900_000),
    ("chr16", 90_300_000), ("chr17", 83_300_000), ("chr18", 80_400_000),
    ("chr19", 58_600_000), ("chr20", 64_400_000), ("chr21", 46_700_000),
    ("chr22", 50_800_000), ("chrX", 156_000_000), ("chrY", 57_200_000),
]

ALU_LEN = 300
LINE_LEN = 6000
SAT_MONOMER = 171


def _mutate_matrix(rng, mat: np.ndarray, rate_lo: float, rate_hi: float
                   ) -> np.ndarray:
    """Mutate each row of (K, L) codes at a per-row rate in [lo, hi)."""
    K, L = mat.shape
    rates = rng.uniform(rate_lo, rate_hi, (K, 1))
    mask = rng.random((K, L)) < rates
    shift = rng.integers(1, 4, (K, L), dtype=np.uint8)
    return np.where(mask, (mat + shift) % 4, mat)


def _paste_copies(rng, contig: np.ndarray, copies: np.ndarray,
                  starts: np.ndarray) -> None:
    """contig[starts[k] : starts[k]+L] = copies[k], fully vectorized."""
    K, L = copies.shape
    idx = starts[:, None] + np.arange(L, dtype=np.int64)[None, :]
    contig[idx.ravel()] = copies.ravel()


def make_contig(rng: np.random.Generator, n: int,
                alu: np.ndarray, line: np.ndarray, sat: np.ndarray,
                alu_frac: float = 0.08, line_frac: float = 0.12,
                sat_mb: float = 0.02) -> tuple:
    """One contig of n bases; returns (codes uint8, (cen_start, cen_end))."""
    contig = rng.integers(0, 4, n, dtype=np.uint8)

    # SINEs: fixed-length copies, one vectorized paste
    k_alu = int(n * alu_frac / ALU_LEN)
    if k_alu:
        starts = rng.integers(0, n - ALU_LEN, k_alu)
        copies = _mutate_matrix(rng, np.tile(alu, (k_alu, 1)), 0.08, 0.16)
        _paste_copies(rng, contig, copies, starts)

    # LINEs: 5'-truncated copies, bucketed by length for vector pasting
    total_line = int(n * line_frac)
    placed = 0
    for frac in (1.0, 0.5, 0.25, 0.12, 0.05):
        L = max(int(LINE_LEN * frac), 200)
        k = max(int(total_line * 0.2 / L), 1) if n > 4 * L else 0
        if not k:
            continue
        starts = rng.integers(0, n - L, k)
        # truncation keeps the 3' end, like real L1 insertions
        copies = _mutate_matrix(rng, np.tile(line[-L:], (k, 1)), 0.05, 0.20)
        _paste_copies(rng, contig, copies, starts)
        placed += k * L

    # centromeric satellite array at the contig midpoint
    sat_len = min(int(sat_mb * n), n // 4)
    sat_len -= sat_len % SAT_MONOMER
    cen_start = cen_end = -1
    if sat_len >= SAT_MONOMER:
        k = sat_len // SAT_MONOMER
        arr = _mutate_matrix(rng, np.tile(sat, (k, 1)), 0.01, 0.05).ravel()
        cen_start = (n - sat_len) // 2
        cen_end = cen_start + sat_len
        contig[cen_start:cen_end] = arr

    return contig, (cen_start, cen_end)


def add_segdups(rng: np.random.Generator, contig: np.ndarray,
                n_dups: int = 4) -> None:
    """Copy random 50-300 kb blocks within the contig at 1-2% divergence."""
    n = len(contig)
    for _ in range(n_dups):
        L = int(rng.integers(50_000, 300_000))
        if n < 3 * L:
            continue
        src = int(rng.integers(0, n - L))
        dst = int(rng.integers(0, n - L))
        block = contig[src:src + L].copy()
        rate = rng.uniform(0.01, 0.02)
        mask = rng.random(L) < rate
        shift = rng.integers(1, 4, L, dtype=np.uint8)
        contig[dst:dst + L] = np.where(mask, (block + shift) % 4, block)


_B2A = np.frombuffer(b"ACGT", dtype=np.uint8)


def write_fasta_contig(f, name: str, codes: np.ndarray,
                       width: int = 80) -> None:
    f.write(f">{name}\n".encode())
    n = len(codes)
    chunk = (1 << 22) // width * width
    for off in range(0, n, chunk):
        seg = _B2A[codes[off:off + chunk]]
        full = len(seg) // width * width
        if full:
            block = seg[:full].reshape(-1, width)
            out = np.empty((block.shape[0], width + 1), np.uint8)
            out[:, :width] = block
            out[:, width] = ord("\n")
            f.write(out.tobytes())
        rem = seg[full:]
        if len(rem):
            f.write(rem.tobytes() + b"\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("output", help="output FASTA path")
    p.add_argument("--scale", type=float, default=1.0,
                   help="genome size scale vs hg38 (1.0 = ~3.1 Gbp)")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--centromeres", default="",
                   help="also write a centromere TSV here")
    args = p.parse_args(argv)
    rng = np.random.default_rng(args.seed)
    alu = rng.integers(0, 4, ALU_LEN, dtype=np.uint8)
    line = rng.integers(0, 4, LINE_LEN, dtype=np.uint8)
    sat = rng.integers(0, 4, SAT_MONOMER, dtype=np.uint8)
    cens = []
    total = 0
    with open(args.output, "wb") as f:
        for name, size in CONTIG_SIZES:
            n = int(size * args.scale)
            if n < 10_000:
                continue
            contig, (cs, ce) = make_contig(rng, n, alu, line, sat)
            add_segdups(rng, contig, n_dups=max(1, n // 60_000_000))
            write_fasta_contig(f, name, contig)
            if cs >= 0:
                cens.append((name, cs, ce))
            total += n
            print(f"{name}: {n:,} bases done", flush=True)
    if args.centromeres:
        with open(args.centromeres, "w") as cf:
            for name, cs, ce in cens:
                cf.write(f"{name}\t{cs}\t{ce}\n")
    print(f"wrote {total:,} bases to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
