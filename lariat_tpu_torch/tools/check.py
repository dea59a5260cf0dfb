"""Metrics/validation harness (equivalent of the reference's go/check.py):
the port of tools/check.py.

Runs the port's aligner in-process on a FASTQ (or analyzes an existing
BAM), then reports:
 - fractions unmapped / proper-pair / mapq==0 / <30 / >=30;
 - for simulated reads with truth in the qname
   (``mol:<x>:<chrom>:<x>:<x>:<pos1>:<pos2>``), empirical-vs-reported MAPQ
   calibration in bins {5, 15, 30, 45} (reference check.py:47-101).

    python -m lariat_tpu_torch.tools.check -reads r.fastq.gz -genome g.fa \\
        -output outdir [-use_device auto|on|off]
    python -m lariat_tpu_torch.tools.check -bam existing.bam

``-use_device`` goes to the CLI (default ``auto``: the GPU, and an error
without CUDA; ``off`` runs the host-native workers).
"""

from __future__ import annotations

import argparse
import math
import os
import sys

from ..io.bamread import BamFile


def show_frac(log_lines, label, reads, pred):
    n = sum(1 for r in reads if pred(r))
    frac = n / len(reads) if reads else 0.0
    log_lines.append(f"{label:15}: {frac:.6f}")


def correct_alignment(r, tolerance=200):
    parts = r.name.split(":")
    if len(parts) < 7 or parts[0] != "mol":
        return None
    al_pos = int(float(parts[5]))
    return parts[2] == r.ref_name and abs(r.pos - al_pos) < tolerance


def analyze_mapqs(reads):
    opts = [5, 15, 30, 45]
    groups = {}
    for r in reads:
        ok = correct_alignment(r)
        if ok is None:
            continue
        binned = min(opts, key=lambda o: abs(r.mapq - o))
        groups.setdefault(binned, []).append((r.mapq, ok))
    results = []
    for k in sorted(groups):
        vals = groups[k]
        mapqs = sorted(v[0] for v in vals)
        med = mapqs[len(mapqs) // 2]
        err = 1.0 - (sum(1 for v in vals if v[1]) / len(vals))
        emp = -10.0 * math.log10(err) if err > 0 else float("inf")
        results.append({"bin": k, "med_mapq": med,
                        "emp_mapq": round(emp, 2), "n": len(vals)})
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("-reads", "--reads")
    p.add_argument("-genome", "--genome")
    p.add_argument("-output", "--output", default="check_out")
    p.add_argument("-bam", "--bam", help="analyze an existing BAM instead")
    p.add_argument("-log", "--log", default="check_log.txt")
    p.add_argument("-threads", "--threads", default="8")
    p.add_argument("-use_device", "--use_device", default="auto",
                   choices=["auto", "on", "off"])
    args = p.parse_args(argv)

    if args.bam:
        bam_fn = args.bam
    else:
        from .. import cli
        rc = cli.main(["-reads", args.reads, "-genome", args.genome,
                       "-output", args.output, "-first_chunk",
                       "-threads", str(args.threads),
                       "-use_device", args.use_device])
        if rc != 0:
            return rc
        bam_fn = os.path.join(args.output, "bc_sorted_bam.bam")

    reads = list(BamFile(bam_fn))
    log_lines = ["", "----------", bam_fn]
    show_frac(log_lines, "Unmapped", reads, lambda x: x.is_unmapped)
    show_frac(log_lines, "Proper pair", reads, lambda x: x.is_proper_pair)
    show_frac(log_lines, "mapq = 0", reads, lambda x: x.mapq == 0)
    show_frac(log_lines, "mapq < 30", reads, lambda x: x.mapq < 30)
    show_frac(log_lines, "mapq >= 30", reads, lambda x: x.mapq >= 30)
    if reads and reads[0].name.startswith("mol:"):
        for row in analyze_mapqs(reads):
            log_lines.append(str(row))
    with open(args.log, "a") as f:
        f.write("\n".join(log_lines) + "\n")
    for line in log_lines:
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
