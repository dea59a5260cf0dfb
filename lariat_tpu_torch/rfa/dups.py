"""Within-barcode duplicate marking (markDuplicates, lariat.go:642-685)."""

from __future__ import annotations

from typing import List

from .types import Alignment


def mark_duplicates(alignments: List[List[Alignment]]) -> None:
    """Active reads with identical (read1, reversed, contig, pos, mateContig,
    matePos) tuples are duplicates; the first seen is kept."""
    seen = set()
    for arr in alignments:
        for aln in arr:
            if not aln.active:
                continue
            mate = aln.mate_alignment
            key = (aln.read1, aln.reversed_, aln.contig, aln.pos,
                   mate.contig, mate.pos)
            if key in seen:
                aln.duplicate = True
            else:
                seen.add(key)
