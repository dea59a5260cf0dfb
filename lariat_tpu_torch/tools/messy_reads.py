"""Write a FASTQ of deliberately messy read pairs: the soak test's reads.

    python -m lariat_tpu_torch.tools.messy_reads GENOME.fa OUT.fastq.gz \\
        [--barcodes 400] [--pairs-per-bc 24] [--seed 5]

Each mate is ``messy_read``'s (a copy of ``tests/test_soak.py``'s
``_messy_read``): substitutions, an insertion block, a deletion, N runs, a
chimera of two distant loci, a homopolymer head, pure junk or a read of
1-24 bases, each reverse-complemented half the time, drawn from the
genome's contigs joined end to end. Records are barcode-grouped in the
9-line format of ``tools/sim_reads.py`` (barcodes ending ``-1``), so the
CLI reads them as it reads simulated ones; the qnames carry no truth.
"""

from __future__ import annotations

import argparse
import gzip
import sys

import numpy as np

COMP = bytes.maketrans(b"ACGTN", b"TGCAN")


def messy_read(genome: bytes, rng) -> bytes:
    """A deliberately ugly read: indels, N runs, chimera, junk, homopolymer."""
    kind = int(rng.integers(0, 8))
    glen = len(genome)
    ln = int(rng.integers(40, 152))
    pos = int(rng.integers(0, glen - 400))
    seq = bytearray(genome[pos:pos + ln])
    if kind == 0:          # clean + substitutions
        for _ in range(int(rng.integers(0, 8))):
            seq[int(rng.integers(0, len(seq)))] = b"ACGT"[
                int(rng.integers(0, 4))]
    elif kind == 1:        # insertion block
        at = int(rng.integers(1, len(seq)))
        ins = bytes(b"ACGT"[int(rng.integers(0, 4))]
                    for _ in range(int(rng.integers(1, 12))))
        seq = seq[:at] + bytearray(ins) + seq[at:]
    elif kind == 2:        # deletion (take a gapped slice of the genome)
        gap = int(rng.integers(1, 15))
        seq = bytearray(genome[pos:pos + ln // 2]
                        + genome[pos + ln // 2 + gap:pos + ln + gap])
    elif kind == 3:        # N runs
        at = int(rng.integers(0, max(1, len(seq) - 5)))
        seq[at:at + int(rng.integers(1, 6))] = b"N" * int(rng.integers(1, 6))
    elif kind == 4:        # chimera of two distant loci
        pos2 = int(rng.integers(0, glen - 200))
        seq = bytearray(genome[pos:pos + ln // 2]
                        + genome[pos2:pos2 + ln - ln // 2])
    elif kind == 5:        # homopolymer-heavy
        seq = bytearray(b"A" * int(rng.integers(20, 80))) + seq[:40]
    elif kind == 6:        # pure junk
        seq = bytearray(bytes(b"ACGT"[int(rng.integers(0, 4))]
                              for _ in range(ln)))
    else:                  # very short
        seq = seq[:int(rng.integers(1, 25))]
    if rng.integers(0, 2):
        seq = bytearray(bytes(seq).translate(COMP)[::-1])
    return bytes(seq)


def load_genome(path: str) -> bytes:
    """The FASTA's contigs joined end to end, upper case."""
    parts = []
    with open(path, "rb") as f:
        for line in f:
            if not line.startswith(b">"):
                parts.append(line.strip().upper())
    return b"".join(parts)


def _barcode(rng, i: int) -> str:
    """A unique 14-mer: 7 random bases, then 7 encoding ``i``."""
    tail = "".join("ACGT"[(i >> (2 * k)) & 3] for k in range(7))
    return "".join("ACGT"[c] for c in rng.integers(0, 4, 7)) + tail


def write_fastq(genome: bytes, out: str, barcodes: int, pairs_per_bc: int,
                seed: int = 5) -> int:
    """``barcodes`` x ``pairs_per_bc`` messy pairs to ``out`` (gzip when it
    ends in .gz); returns the pairs written."""
    rng = np.random.default_rng(seed)
    opener = gzip.open if out.endswith(".gz") else open
    with opener(out, "wt") as f:
        for b in range(barcodes):
            bc = _barcode(rng, b)
            for i in range(pairs_per_bc):
                r1 = messy_read(genome, rng).decode()
                r2 = messy_read(genome, rng).decode()
                f.write(f"@messy:{bc}:{i} rg\n{r1}\n{'I' * len(r1)}\n"
                        f"{r2}\n{'I' * len(r2)}\n{bc}-1,{bc}\n{'J' * 14}\n"
                        f"ACGTACGT\nIIIIIIII\n")
    return barcodes * pairs_per_bc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lariat_tpu_torch.tools.messy_reads")
    p.add_argument("genome", help="FASTA the reads are drawn from")
    p.add_argument("output", help="output .fastq.gz (or .fastq)")
    p.add_argument("--barcodes", type=int, default=400)
    p.add_argument("--pairs-per-bc", type=int, default=24)
    p.add_argument("--seed", type=int, default=5)
    args = p.parse_args(argv)
    n = write_fastq(load_genome(args.genome), args.output, args.barcodes,
                    args.pairs_per_bc, args.seed)
    print(f"wrote {n} messy pairs / {args.barcodes} barcodes -> "
          f"{args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
