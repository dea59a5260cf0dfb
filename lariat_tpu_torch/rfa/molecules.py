"""Molecule calling: 1-D clustering + per-molecule best-alignment tables.

Equivalents of inferMolecules (lariat.go:1370-1408),
markBestAlignmentForReadInMolecule (lariat.go:1410-1463), scrapMolecules
(lariat.go:1061-1086), setMoleculeDifferences (lariat.go:570-588) and
setMoleculeConfidences (lariat.go:1048-1059).
"""

from __future__ import annotations

from typing import List

from .scoring import _part, score_alignment
from .types import Alignment, CandidateMolecule, SwapOrderedMap

MOLECULE_GAP = 50000


def infer_molecules(positions: List[List[Alignment]]) -> List[CandidateMolecule]:
    """Greedy 1-D clustering: new molecule at gaps > 50 kb (lariat.go:1376)."""
    out: List[CandidateMolecule] = []
    molecule_num = 0
    current = None
    for plist in positions:
        for i, aln in enumerate(plist):
            if i == 0 or aln.pos - plist[i - 1].pos > MOLECULE_GAP:
                if i > 0:
                    current.stop = plist[i - 1].pos
                current = CandidateMolecule(
                    id=molecule_num, chrom=aln.contig, start=aln.pos)
                aln_map = SwapOrderedMap()
                aln_map[aln.id] = aln
                current.alignments[aln.read_id] = aln_map
                out.append(current)
                molecule_num += 1
            else:
                aln_map = current.alignments.get(aln.read_id)
                if aln_map is not None:
                    aln_map[aln.id] = aln
                else:
                    aln_map = SwapOrderedMap()
                    aln_map[aln.id] = aln
                    current.alignments[aln.read_id] = aln_map
        if plist:
            current.stop = plist[-1].pos
    return out


def mark_best_alignment_for_read_in_molecule(
        molecules: List[CandidateMolecule],
        improper_pair_penalty: float) -> None:
    """Per molecule per read: best pair-scored alignment + active sets."""
    for molecule in molecules:
        active_alignments = SwapOrderedMap()
        best_for_read = SwapOrderedMap()
        mol_alignments = molecule.alignments
        for read_id, alignments in dict.items(mol_alignments):
            best_score = -float("inf")
            best_alignment = None
            # all alignments of a read share mate_id — hoist the mate map
            # lookup and its value list out of the per-alignment loop
            first = next(iter(dict.values(alignments)))
            mate_alignments = mol_alignments.get(first.mate_id)
            mates = (list(dict.values(mate_alignments))
                     if mate_alignments else None)
            for alignment in dict.values(alignments):
                if mates:
                    # inlined score_alignment(alignment, mate, 0.0, ipp)
                    # replaying the exact scalar float order; the
                    # log_molecule_penalty term is 0.0 here (no-op add)
                    pa = alignment.score_part
                    if pa is None:
                        pa = _part(alignment)
                    a_rev = alignment.reversed_
                    a_contig = alignment.contig
                    a_pos = alignment.pos
                    base = 0.0 + pa
                    for mate in mates:
                        pm = mate.score_part
                        if pm is None:
                            pm = _part(mate)
                        score = base + pm
                        if a_rev == mate.reversed_ or a_contig != mate.contig:
                            score += improper_pair_penalty
                        else:
                            dist = (a_pos - mate.pos if a_rev
                                    else mate.pos - a_pos)
                            if not (-35 <= dist < 750):
                                score += improper_pair_penalty
                        if score > best_score:
                            best_score = score
                            best_alignment = alignment
                else:
                    if alignment.log_alignment_probability > best_score:
                        best_score = alignment.log_alignment_probability
                        best_alignment = alignment
                if alignment.active:
                    active_alignments[read_id] = alignment
            if best_alignment.active:
                active_alignments[read_id] = best_alignment
            best_for_read[read_id] = best_alignment
        for aln in active_alignments.values():
            for loc in aln.mismatch_locs:
                molecule.mismatch_locs[loc] = molecule.mismatch_locs.get(loc, 0) + 1
        molecule.active_alignments = active_alignments
        molecule.best_alignment_for_read = best_for_read


def scrap_molecules(molecules: List[CandidateMolecule]
                    ) -> List[CandidateMolecule]:
    """Drop empty molecules; renumber molecule_id on member alignments."""
    kept: List[CandidateMolecule] = []
    count = 0
    for mol in molecules:
        if len(mol.active_alignments) > 0:
            kept.append(mol)
            for amap in dict.values(mol.alignments):
                for aln in dict.values(amap):
                    aln.molecule_id = count
            count += 1
        else:
            for amap in dict.values(mol.alignments):
                for aln in dict.values(amap):
                    aln.molecule_id = -1
    return kept


def set_molecule_differences(molecules: List[CandidateMolecule],
                             set_bad: bool) -> None:
    for mol in molecules:
        differences = 0
        for aln in mol.active_alignments.values():
            differences += aln.mismatches
        n = len(mol.active_alignments)
    # (loop split keeps reference behavior: differences uses len at call time)
        if set_bad and n and differences / n > 1.5:
            for aln in mol.active_alignments.values():
                aln.bad_molecule = True
        mol.differences = differences / n if n else float("nan")
        for aln in mol.active_alignments.values():
            aln.molecule_difference = mol.differences


def molecule_confidence(mol: CandidateMolecule, num_active: int) -> float:
    return num_active / len(mol.best_alignment_for_read)


def set_molecule_confidences(molecules: List[CandidateMolecule]) -> None:
    for mol in molecules:
        mol.molecule_confidence = molecule_confidence(
            mol, len(mol.active_alignments))
        for aln in mol.active_alignments.values():
            if aln.soft_clipped > 0:
                mol.soft_clipped += 1
            aln.molecule_confidence = mol.molecule_confidence
