"""Print a BAM file as SAM text (header + records), no external tools: the
port of tools/bam2sam.py.

    python -m lariat_tpu_torch.tools.bam2sam out/bc_sorted_bam.bam [--no-header]
"""

from __future__ import annotations

import sys

from ..io.bamread import BamFile


def record_to_sam(r) -> str:
    cigar = "".join(f"{ln}{op}" for op, ln in r.cigar) if r.cigar else "*"
    if r.mate_ref_id < 0:
        rnext = "*"
    elif r.mate_ref_id == r.ref_id:
        rnext = "="
    else:
        rnext = "?"
    qual = ("".join(chr(q + 33) for q in r.qual)
            if r.qual and r.qual[0] != 0xff else "*")
    fields = [r.name, str(r.flag), r.ref_name if r.ref_id >= 0 else "*",
              str(r.pos + 1), str(r.mapq), cigar, rnext,
              str(r.mate_pos + 1), str(r.tlen), r.seq or "*", qual]
    for tag, val in r.tags.items():
        if isinstance(val, int):
            fields.append(f"{tag}:i:{val}")
        elif isinstance(val, float):
            fields.append(f"{tag}:f:{val}")
        else:
            fields.append(f"{tag}:Z:{val}")
    return "\t".join(fields)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m lariat_tpu_torch.tools.bam2sam <file.bam> "
              "[--no-header]")
        return 1
    bam = BamFile(argv[0])
    if "--no-header" not in argv:
        sys.stdout.write(bam.header_text)
    mate_names = {i: n for i, (n, _) in enumerate(bam.references)}
    for r in bam:
        line = record_to_sam(r)
        if "\t?\t" in line and r.mate_ref_id >= 0:
            line = line.replace("\t?\t", f"\t{mate_names[r.mate_ref_id]}\t")
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
