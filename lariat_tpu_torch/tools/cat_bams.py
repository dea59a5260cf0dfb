"""Concatenate position-bucketed BAM chunks (the `samtools cat` step): the
port of tools/cat_bams.py.

The reference's position-bucketed output naming
(``NNNNNN-contig_OFFSET_pos_bucketed.bam``, bamwriter.go:133-191) exists so a
downstream ``samtools cat`` can merge per-chunk outputs into one coordinate-
compatible BAM. This tool performs that merge natively: it keeps the first
file's header and appends the record payloads of the rest through one BGZF
writer (all files must share the same reference set, which holds for
chunked runs of the same genome).

    python -m lariat_tpu_torch.tools.cat_bams -o merged.bam a.bam b.bam ...
    python -m lariat_tpu_torch.tools.cat_bams -o merged.bam --auto dir1 dir2
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

from ..io.bamread import BamFile
from ..io.bgzf import BGZFWriter


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--auto", action="store_true",
                   help="arguments are output DIRECTORIES; merge their "
                        "position-bucketed BAMs in name order")
    p.add_argument("inputs", nargs="+")
    args = p.parse_args(argv)
    if args.auto:
        files = []
        # chunk outputs interleave by bucket name so coordinates stay sorted
        buckets = {}
        for d in args.inputs:
            for f in glob.glob(os.path.join(d, "*_pos_bucketed.bam")):
                buckets.setdefault(os.path.basename(f), []).append(f)
        for name in sorted(buckets):
            files.extend(sorted(buckets[name]))
    else:
        files = args.inputs
    if not files:
        print("no input BAMs found", file=sys.stderr)
        return 1
    with open(args.output, "wb") as out:
        w = BGZFWriter(out)
        for i, f in enumerate(files):
            bam = BamFile(f)
            if i == 0:
                w.write(bam.data[:bam._records_start])
            w.write(bam.data[bam._records_start:])
        w.close()
    print(f"merged {len(files)} BAMs -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
