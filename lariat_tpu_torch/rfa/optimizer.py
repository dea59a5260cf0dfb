"""RFA move optimizer: greedy molecule-to-molecule sub-move sweeps.

Equivalents of fastScore (lariat.go:1179-1307), GenerateMove
(lariat.go:1135-1167), acceptMove (lariat.go:1331-1368), isActiveMolecule
(lariat.go:1309-1319) and the optimizer driver (optimizer/optimizer.go:15-27;
the annealing acceptance function is ignored by the reference's GenerateMove,
so the effective behavior is greedy hill-climbing over
2 x 4*n_molecules sweeps — replicated as such).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from . import debug
from .scoring import is_pair
from .types import Alignment, CandidateMolecule


@dataclasses.dataclass
class Move:
    score_change: float = -float("inf")
    alignment_change: float = 0.0
    source: Optional[CandidateMolecule] = None
    sink: Optional[CandidateMolecule] = None
    to_delete: List[int] = dataclasses.field(default_factory=list)
    to_set: List[Alignment] = dataclasses.field(default_factory=list)
    num_moved: int = 0


def is_active_molecule(mol: CandidateMolecule, read_change: int) -> bool:
    active = len(mol.active_alignments) + read_change
    potential = len(mol.best_alignment_for_read)
    if active <= 4:
        return False
    if active / potential < 0.1:
        return False
    return True


def fast_score(source: CandidateMolecule, sink: CandidateMolecule,
               log_unpaired_probability: float) -> Tuple[float, Move]:
    """Delta log10 score of the sub-move source -> sink (lariat.go:1179-1307)."""
    change = 0.0
    alignment_change = 0.0
    num = 0
    to_delete: List[int] = []
    to_set: List[Alignment] = []
    source_mismatch_remove = {}
    if debug.PRINT_MOVE:
        print("test move ", source.id, " to ", sink.id, source.start,
              sink.start, "current alignments", len(source.active_alignments),
              len(sink.active_alignments))
        print("  source mol mismatch locs ", dict(source.mismatch_locs))
        print("  sink mol mismatch locs ", dict(sink.mismatch_locs))
    for source_aln in source.active_alignments.values():
        read_id = source_aln.read_id
        sink_aln = source_aln and sink.best_alignment_for_read.get(read_id)
        if sink_aln is None:
            continue
        mate_id = source_aln.mate_id
        source_mate = source.active_alignments.get(mate_id)
        source_has_mate = source_mate is not None
        source_has_mate_pair = source_has_mate and is_pair(source_aln, source_mate)
        mate = sink.best_alignment_for_read.get(mate_id)
        sink_has_mate_pair = (mate is not None and is_pair(sink_aln, mate)
                              and source_has_mate)
        if not source_has_mate_pair or (source_has_mate and sink_has_mate_pair):
            to_delete.append(read_id)
            to_set.append(sink_aln)
        alignment_change += (sink_aln.log_alignment_probability
                             - source_aln.log_alignment_probability)
        if debug.PRINT_MOVE:
            print("\talignment ", source_aln.pos, " to ", sink_aln.pos,
                  " change score ",
                  sink_aln.updated_log_alignment_probability
                  - source_aln.updated_log_alignment_probability)
            print("\t\tsource mismatches ", list(source_aln.mismatch_locs))
            print("\t\tsink mismatches ", list(sink_aln.mismatch_locs))
        # mismatch-locus bookkeeping sanity (score adjustments are disabled in
        # the reference too; only the invariant check remains)
        for loc in source_aln.mismatch_locs:
            n_mm = source.mismatch_locs.get(loc, 0)
            if n_mm == 0:
                raise RuntimeError("source molecule missing mismatch locus")
            source_mismatch_remove[loc] = source_mismatch_remove.get(loc, 0) + 1
        if source_has_mate_pair and not sink_has_mate_pair and source.id != sink.id:
            alignment_change += log_unpaired_probability / 2.0
        elif (not source_has_mate_pair and sink_has_mate_pair
              and source.id != sink.id):
            alignment_change -= log_unpaired_probability / 2.0
        num += 1

    source_active_before = is_active_molecule(source, 0)
    source_active_after = is_active_molecule(source, -num)
    if not source_active_after and source_active_before and source.id != sink.id:
        change -= len(source.best_alignment_for_read) * -0.5
    sink_active_before = is_active_molecule(sink, 0)
    sink_active_after = is_active_molecule(sink, num)
    if sink_active_after and not sink_active_before and source.id != sink.id:
        change += len(sink.best_alignment_for_read) * -0.5
    if (len(source.active_alignments) - num == 0 and num > 0
            and source.id != sink.id):
        change -= -3.0
        if debug.PRINT_MOVE:
            print(">>>>>> adding 3")
    if len(sink.active_alignments) == 0 and num > 0 and source.id != sink.id:
        change += -3.0
        if debug.PRINT_MOVE:
            print(">>>>>> adding -3")
    change += alignment_change
    if debug.PRINT_MOVE:
        print("\t======= final alignment change ", alignment_change)
        print("&&&&&&& final change ", change)
    return change, Move(score_change=change, alignment_change=alignment_change,
                       source=source, sink=sink, to_delete=to_delete,
                       to_set=to_set, num_moved=num)


def accept_move(move: Move) -> None:
    """Mutate active sets + molecule mismatch counters (lariat.go:1331-1368)."""
    for read_id, sink_aln in zip(move.to_delete, move.to_set):
        source_aln = move.source.active_alignments.get(read_id)
        for loc in source_aln.mismatch_locs:
            n = move.source.mismatch_locs.get(loc, 0)
            if n == 0:
                raise RuntimeError("source molecule missing mismatch locus")
            move.source.mismatch_locs[loc] = n - 1
        for loc in sink_aln.mismatch_locs:
            move.sink.mismatch_locs[loc] = move.sink.mismatch_locs.get(loc, 0) + 1
        move.source.active_alignments.delete(read_id)
        move.sink.active_alignments.set(read_id, sink_aln)
        source_aln.active = False
        sink_aln.active = True


class RFAOptimizer:
    """Greedy round-robin move generator (lariat.go:1135-1167)."""

    def __init__(self, molecules: List[CandidateMolecule],
                 alignments: List[List[Alignment]],
                 log_unpaired_probability: float, barcode: str = ""):
        self.molecules = molecules
        self.alignments = alignments
        self.log_unpaired_probability = log_unpaired_probability
        self.barcode = barcode
        self.current_source = 0
        # read_id -> molecule indices whose best_alignment_for_read contain
        # it. A sink sharing no reads with the source always scores with
        # num_moved == 0 and is discarded by generate_move, so restricting
        # the sweep to index-hit sinks is exact (best_alignment_for_read is
        # immutable during optimization; only active sets mutate).
        self._read_to_mols = {}
        for mi, mol in enumerate(molecules):
            for read_id in mol.best_alignment_for_read.keys():
                self._read_to_mols.setdefault(read_id, []).append(mi)
        # tensorized fastScore rows (propose step); None -> scalar sweep.
        # The verbose debug path needs the scalar per-sink prints.
        self._tensors = None
        if not debug.PRINT_MOVE:
            from .tensor_rfa import RFATensors
            self._tensors = RFATensors.build(molecules, alignments)

    def generate_move(self) -> None:
        mols = self.molecules
        source = mols[self.current_source]
        if len(source.active_alignments) == 0:
            self.current_source = (self.current_source + 1) % len(mols)
            return
        cand = set()
        for read_id in source.active_alignments.keys():
            cand.update(self._read_to_mols.get(read_id, ()))
        best_move = Move(score_change=-float("inf"))
        cand_list = sorted(cand)
        if self._tensors is not None and cand_list:
            # propose: one tensor row scores every candidate sink;
            # serialize-accept: the winner is re-derived with the scalar
            # fast_score (byte-identical change; also re-checks the
            # mismatch-locus invariants) and applied on host
            import numpy as _np
            K = _np.array([i for i in cand_list if i != self.current_source],
                          _np.int64)
            if len(K):
                change, num = self._tensors.fast_score_row(
                    source, self.current_source, K,
                    self.log_unpaired_probability)
                best_k = -1
                best_c = -float("inf")
                best_n_act = -1
                for j in range(len(K)):
                    if num[j] <= 0:
                        continue
                    c = float(change[j])
                    n_act = len(mols[K[j]].active_alignments)
                    if c > best_c or (c == best_c and n_act > best_n_act):
                        best_k = int(K[j])
                        best_c = c
                        best_n_act = n_act
                if best_k >= 0:
                    score, best_move = fast_score(
                        source, mols[best_k], self.log_unpaired_probability)
                    assert score == best_c, "tensor/scalar fastScore mismatch"
        else:
            for i in cand_list:
                if i == self.current_source:
                    continue
                sink = mols[i]
                score, move = fast_score(source, sink,
                                         self.log_unpaired_probability)
                if ((score > best_move.score_change
                     or (score == best_move.score_change
                         and len(move.sink.active_alignments)
                         > len(best_move.sink.active_alignments)))
                        and move.num_moved > 0):
                    best_move = move
        best_score = best_move.score_change
        if best_score > 0 or (
                best_score == 0 and best_move.sink is not None
                and len(best_move.sink.active_alignments)
                > len(source.active_alignments)):
            accept_move(best_move)
        self.current_source = (self.current_source + 1) % len(mols)

    def optimize(self) -> None:
        """Optimize(model, 1, 2, 4*n_molecules) effective loop
        (lariat.go:513; optimizer.go:15-27)."""
        n = len(self.molecules)
        if n == 0:
            return
        for _temp_step in range(2):
            for _sweep in range(4 * n):
                self.generate_move()
