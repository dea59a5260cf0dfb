"""Core data types for RFA inference (reference inference/lariat.go structs)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..io.fastq import FastQRecord


class SwapOrderedMap(dict):
    """Int-keyed map with insertion-order iteration and swap-delete.

    Replicates the reference's OrderedMap (``inference/ordered_map.go``):
    Delete moves the *last* entry into the deleted slot, so iteration order
    after deletions matches the reference exactly — RFA sweep determinism
    depends on this.

    Implemented as a dict subclass (Python dicts are insertion-ordered and
    overwrite-in-place, matching Set) so the hot operations — get, ``in``,
    len, set — run at C speed; only delete(), with a single optimizer call
    site, pays an O(n) rebuild to replicate the swap order.
    """

    __slots__ = ()

    def set(self, key: int, val) -> None:
        self[key] = val

    def delete(self, key: int) -> None:
        if key not in self:
            return
        items = list(dict.items(self))
        last = items[-1]
        if last[0] != key:
            for i, kv in enumerate(items):
                if kv[0] == key:
                    items[i] = last
                    break
        items.pop()
        dict.clear(self)
        dict.update(self, items)

    def values(self) -> List:
        return list(dict.values(self))

    def keys(self) -> List[int]:
        return list(dict.keys(self))


@dataclasses.dataclass(slots=True)
class MapQData:
    """Second-best metadata recorded for debugging tags (lariat.go:150-163)."""
    copies: int = 0
    copies_in_active_molecules: int = 0
    unique_molecules_active: int = 0
    copies_outside_active_molecules: int = 0
    reads_in_molecule: int = 0
    active_alignments_in_molecules: str = ""
    second_best: Optional["Alignment"] = None
    second_best_score: float = 0.0
    score: float = 0.0
    second_best_proper_pair: bool = False
    second_best_molecule_reads: int = -1
    second_best_molecule_confidence: float = -1.0


@dataclasses.dataclass(slots=True)
class Alignment:
    """Candidate alignment of one read (lariat.go:68-117)."""
    id: int = 0                      # hit id, unique within the barcode
    read1: bool = False
    is_proper: bool = False
    soft_clipped: int = 0            # number of soft-clipped sides
    soft_clipped_length: int = 0
    fastq: Optional[FastQRecord] = None
    mapq: int = 0
    molecule_difference: float = 0.0
    contig: str = ""
    pos: int = -1
    aend: int = 0
    score: int = 0
    mismatches: int = 0
    matches: int = 0
    mismatch_locs: List[int] = dataclasses.field(default_factory=list)
    mismatch_read_locs: List[int] = dataclasses.field(default_factory=list)
    indels: int = 0
    read_id: int = 0
    bad_molecule: bool = False
    correctly_placed: bool = False
    mate_id: int = 0
    mate_alignment: Optional["Alignment"] = None
    reversed_: bool = False
    molecule_id: int = -1
    cigar: Tuple[Tuple[int, int], ...] = ()
    active: bool = False
    log_alignment_probability: float = 0.0
    updated_log_alignment_probability: float = 0.0
    bwa_pick: bool = False
    mapq_data: Optional[MapQData] = None
    # lazily cached per-alignment term of score_alignment; the op counts are
    # immutable after GetAlignments, and every term is a multiple of 0.5, so
    # caching the exact partial sum cannot change any downstream float
    score_part: Optional[float] = None
    sum_move_probability_change: float = 1.0
    molecule_confidence: float = 0.00075 * 0.025
    active_molecule: bool = False
    readmap_s: int = 0
    readmap_e: int = 0
    secondary: Optional["Alignment"] = None   # split-read supplementary
    primary: Optional["Alignment"] = None
    duplicate: bool = False
    # per-barcode integer contig id (get_alignments); lets the vectorized
    # scoring compare contigs without string work. -1 = unassigned.
    contig_id: int = -1
    # per-read cache of static score arrays, stored on arr[0]
    # (scoring._read_arrays); fields it covers are immutable after
    # GetAlignments
    score_arrays: Optional[tuple] = None

    @property
    def read_name(self) -> str:
        return self.fastq.read_info if self.fastq else ""

    @property
    def read_seq(self) -> bytes:
        if self.fastq is None:
            return b""
        return self.fastq.read1 if self.read1 else self.fastq.read2

    @property
    def read_qual(self) -> bytes:
        if self.fastq is None:
            return b""
        return self.fastq.read_qual1 if self.read1 else self.fastq.read_qual2

    def is_unmapped(self) -> bool:
        """lariat.go:143-148 demotion rule."""
        return (not self.is_proper) and self.score - 17 < 19


@dataclasses.dataclass
class CandidateMolecule:
    """A read-cloud candidate (lariat.go:181-196)."""
    id: int
    chrom: str
    start: int
    stop: int = 0
    # read id -> SwapOrderedMap(alignment id -> Alignment)
    alignments: SwapOrderedMap = dataclasses.field(default_factory=SwapOrderedMap)
    best_alignment_for_read: SwapOrderedMap = dataclasses.field(
        default_factory=SwapOrderedMap)
    active_alignments: SwapOrderedMap = dataclasses.field(
        default_factory=SwapOrderedMap)
    log_probability: float = 0.0
    true_molecule: bool = False
    active_molecule: bool = False
    molecule_confidence: float = 1.0
    differences: float = 0.0
    soft_clipped: int = 0
    mismatch_locs: Dict[int, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Region:
    start: int = -1
    end: int = -1
