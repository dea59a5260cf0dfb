"""MAPQ estimation: min(per-read probability normalization, molecule-move
normalization), capped at 60, zeroed in centromeres.

Equivalents of estimateMapQualities (lariat.go:867-992),
moleculeMapqProbabilitySums (lariat.go:767-790),
updateAlignmentsMoleculeStatus (lariat.go:687-719) and
calculateLogMoleculePenalty (lariat.go:792-825).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from .molecules import set_molecule_confidences, set_molecule_differences
from .optimizer import fast_score
from .scoring import (pair_total_matrix, pseudo_count_alignment_score,
                      score_alignment, single_total_vector)
from .types import Alignment, CandidateMolecule, Region

GENOME_LENGTH = 3.2e9  # hard-coded human genome length (lariat.go:885)


def molecule_mapq_probability_sums(molecules: List[CandidateMolecule],
                                   log_unpaired_probability: float,
                                   tensors=None) -> None:
    # sinks sharing no reads with the source contribute to nothing (their
    # source_alignments list is empty), so the sweep is restricted to
    # read-sharing sinks via an index — exact, same contribution order
    read_to_mols: Dict[int, list] = {}
    for mi, mol in enumerate(molecules):
        for read_id in mol.best_alignment_for_read.keys():
            read_to_mols.setdefault(read_id, []).append(mi)
    import numpy as np
    for src_id, source in enumerate(molecules):
        cand = set()
        for read_id in source.active_alignments.keys():
            cand.update(read_to_mols.get(read_id, ()))
        if tensors is not None:
            # tensor row (tensor_rfa): all sink changes at once, then the
            # per-alignment sums accumulate sink-ascending exactly like the
            # scalar loop (per-aln addition chains are identical)
            K = np.array([i for i in sorted(cand) if i != src_id], np.int64)
            if not len(K):
                continue
            change, _num = tensors.fast_score_row(
                source, src_id, K, log_unpaired_probability)
            src_alns = list(source.active_alignments.values())
            for aln in src_alns:
                if not aln.active:
                    raise RuntimeError(
                        "setting molecule mapq for non-active alignment")
            cols = np.array([a.read_id for a in src_alns], np.int64)
            sums = np.array([a.sum_move_probability_change
                             for a in src_alns], np.float64)
            EXK = tensors.EX[K][:, cols] if len(cols) else None
            for j in range(len(K)):
                c = float(change[j])
                prob = math.pow(10.0, c) if c < 300 else math.inf
                sums = np.where(EXK[j], sums + prob, sums)
            for a, s in zip(src_alns, sums):
                a.sum_move_probability_change = float(s)
            continue
        for snk_id in sorted(cand):
            if src_id == snk_id:
                continue
            sink = molecules[snk_id]
            source_alignments = [
                aln for aln in source.active_alignments.values()
                if sink.best_alignment_for_read.get(aln.read_id) is not None]
            change, _ = fast_score(source, sink, log_unpaired_probability)
            prob = math.pow(10.0, change) if change < 300 else math.inf
            for aln in source_alignments:
                if not aln.active:
                    raise RuntimeError(
                        "setting molecule mapq for non-active alignment")
                aln.sum_move_probability_change += prob


def update_alignments_molecule_status(
        alignments: List[List[Alignment]],
        molecules: Optional[List[CandidateMolecule]],
        read_copies_in_active: Dict[int, int],
        read_copies_not_in_active: Dict[int, int],
        unique_molecules_active: Dict[int, Dict[int, bool]]) -> None:
    if molecules is None:
        return
    set_molecule_confidences(molecules)
    set_molecule_differences(molecules, False)
    for read_id, arr in enumerate(alignments):
        for aln in arr:
            is_active = False
            if aln.molecule_id != -1:
                mol = molecules[aln.molecule_id]
                is_active = (len(mol.active_alignments) - mol.soft_clipped > 4
                             and mol.molecule_confidence > 0.1)
                aln.active_molecule = is_active
            if is_active:
                molecules[aln.molecule_id].active_molecule = True
                read_copies_in_active[read_id] = (
                    read_copies_in_active.get(read_id, 0) + 1)
                unique_molecules_active.setdefault(read_id, {})[
                    aln.molecule_id] = True
            else:
                read_copies_not_in_active[read_id] = (
                    read_copies_not_in_active.get(read_id, 0) + 1)
            if aln.molecule_id != -1:
                aln.mapq_data.reads_in_molecule = len(
                    molecules[aln.molecule_id].active_alignments)


def calculate_log_molecule_penalty(molecules: Optional[List[CandidateMolecule]],
                                   genome_length: float) -> float:
    dna_length = 1000.0
    if not molecules:
        return 0.0
    for mol in molecules:
        if mol.active_molecule:
            smallest = float("inf")
            biggest = -1
            for aln in mol.active_alignments.values():
                biggest = max(biggest, aln.pos)
                smallest = min(smallest, aln.pos)
            if biggest >= smallest:
                dna_length += (biggest - smallest) + 1000.0
        else:
            for aln in mol.active_alignments.values():
                dna_length += (aln.aend - aln.pos) * 2.0
    singleton_prob = 0.05
    return math.log10(dna_length / genome_length * singleton_prob)


def append_pseudocount_score(scores: List[float], arr: List[Alignment],
                             alignments: List[List[Alignment]],
                             log_molecule_penalty: float,
                             improper_pair_penalty: float) -> None:
    if not arr:
        return
    mate_arr = alignments[arr[0].mate_id]
    best_single_mate = -float("inf")
    for mate in mate_arr:
        s = score_alignment(None, mate, log_molecule_penalty,
                            improper_pair_penalty)
        if s > best_single_mate:
            best_single_mate = s
    if mate_arr:
        scores.append(best_single_mate
                      + pseudo_count_alignment_score(arr[0], log_molecule_penalty))
    else:
        scores.append(pseudo_count_alignment_score(arr[0], log_molecule_penalty))


def _go_int64(x: float) -> int:
    """Go int64(float64) truncation, clamped on inf like gc's saturation."""
    if math.isnan(x):
        return -(1 << 63)
    if x == math.inf:
        return (1 << 63) - 1
    if x == -math.inf:
        return -(1 << 63)
    return int(x)


def debug_strings(aln: Alignment, alignments: List[List[Alignment]],
                  molecules: List[CandidateMolecule],
                  cache: Dict[int, Dict[int, str]],
                  log_unpaired_probability: float) -> None:
    """-debug diagnostics: append per-alternative-molecule move summaries to
    mapq_data.active_alignments_in_molecules (emitted as the AA bam tag,
    bamwriter.go:515). Mirrors debugStrings (lariat.go:994-1046) including the
    per-(source,sink) molecule string cache."""
    from . import debug
    if not debug.DEBUG:
        return
    for alt in alignments[aln.read_id]:
        if alt.molecule_id == -1:
            continue
        alt_mol = molecules[alt.molecule_id]
        chrom = alt.contig
        start, end = alt_mol.start, alt_mol.stop
        sub = cache.get(aln.molecule_id)
        molstring = sub.get(alt.molecule_id) if sub else None
        if molstring is None:
            src_mol = molecules[aln.molecule_id]
            sourcesink = sum(
                1 for a in src_mol.active_alignments.values()
                if alt_mol.best_alignment_for_read.get(a.read_id) is not None)
            sinksource = sum(
                1 for a in alt_mol.active_alignments.values()
                if src_mol.best_alignment_for_read.get(a.read_id) is not None)
            stc, _ = fast_score(src_mol, alt_mol, log_unpaired_probability)
            tsc, _ = fast_score(alt_mol, src_mol, log_unpaired_probability)
            molstring = (
                f"{chrom}:{start}-{end}"
                f":alignments:{len(alt_mol.active_alignments)}"
                f":spots:{len(alt_mol.best_alignment_for_read)}"
                f":mv_S->T:{sourcesink}:{_go_int64(stc)}"
                f":mv_T->S:{sinksource}:{_go_int64(tsc)},")
            cache.setdefault(aln.molecule_id, {})[alt.molecule_id] = molstring
        aln.mapq_data.active_alignments_in_molecules += molstring


def _neg10log10_1m(p: float) -> float:
    """-10*log10(1-p) with Go-style inf semantics."""
    arg = 1.0 - p
    if arg <= 0.0:
        return math.inf
    return -10.0 * math.log10(arg)


def estimate_map_qualities(alignments: List[List[Alignment]],
                           molecules: Optional[List[CandidateMolecule]],
                           log_unpaired_probability: float,
                           improper_pair_penalty: float,
                           centromeres: Dict[str, Region]) -> None:
    read_copies_in_active: Dict[int, int] = {}
    read_copies_not_in_active: Dict[int, int] = {}
    unique_molecules_active: Dict[int, Dict[int, bool]] = {}
    from . import debug
    if debug.PRINT_MOVE:
        print("NOW TESTING MAPQS")
    if molecules:
        tensors = None
        if not debug.PRINT_MOVE:
            from .tensor_rfa import RFATensors
            tensors = RFATensors.build(molecules, alignments)
        molecule_mapq_probability_sums(molecules, log_unpaired_probability,
                                       tensors)
    update_alignments_molecule_status(
        alignments, molecules, read_copies_in_active,
        read_copies_not_in_active, unique_molecules_active)
    log_molecule_penalty = calculate_log_molecule_penalty(
        molecules, GENOME_LENGTH)
    for read_id, arr in enumerate(alignments):
        scores: List[float] = []
        append_pseudocount_score(scores, arr, alignments, log_molecule_penalty,
                                 improper_pair_penalty)
        # re-link mate_alignment pointers between active pairs (hoisted
        # active check: assignment order among qualifying pairs unchanged)
        for aln in arr:
            if not aln.active:
                continue
            for mate in alignments[aln.mate_id]:
                if mate.active:
                    aln.mate_alignment = mate
                    mate.mate_alignment = aln
        # best pair score per alignment + the second-best (non-active) pair
        # scan. The vectorized path is bit-identical to the scalar loops: the
        # score matrix replays the scalar addition order
        # (scoring.pair_total_matrix) and the improvement chain of the
        # strict-> running compare is replayed element by element, including
        # its mate_alignment side effects.
        mates0 = alignments[arr[0].mate_id] if arr else []
        n_a, n_m = len(arr), len(mates0)
        homog = arr and all(a.mate_id == arr[0].mate_id for a in arr)
        tot = None
        if homog and n_a * max(n_m, 1) >= 32:
            if n_m:
                tot = pair_total_matrix(arr, mates0, improper_pair_penalty,
                                        log_molecule_penalty)
                for b in tot.max(axis=1):
                    scores.append(float(b))
            else:
                for b in single_total_vector(arr, improper_pair_penalty,
                                             log_molecule_penalty):
                    scores.append(float(b))
        else:
            for aln in arr:
                mate_arr = alignments[aln.mate_id]
                best = -float("inf")
                for mate in mate_arr:
                    s = score_alignment(aln, mate, log_molecule_penalty,
                                        improper_pair_penalty)
                    if s > best:
                        best = s
                if not mate_arr:
                    best = score_alignment(aln, None, log_molecule_penalty,
                                           improper_pair_penalty)
                scores.append(best)

        # second-best (non-active) pair metadata
        second_best_proper = False
        second_best_raw = scores[0]
        second_best_logp = -1000.0
        second_best_mol_reads = -1
        second_best_aln: Optional[Alignment] = None
        second_best_mol_conf = -1.0
        if tot is not None and n_m:
            import numpy as _np
            flat = tot.ravel().copy()
            flat[_np.repeat(_np.array([a.active for a in arr], bool),
                            n_m)] = -_np.inf
            run = _np.maximum.accumulate(
                _np.concatenate(([_np.float64(-1000.0)], flat)))[:-1]
            for k in _np.nonzero(flat > run)[0]:
                i, j = divmod(int(k), n_m)
                aln, mate = arr[i], mates0[j]
                second_best_logp = float(flat[k])
                second_best_raw = score_alignment(aln, mate, 0.0,
                                                  improper_pair_penalty)
                second_best_aln = aln
                aln.mate_alignment = mate
                second_best_proper = aln.is_proper
                if aln.molecule_id != -1 and molecules:
                    alt = molecules[aln.molecule_id]
                    second_best_mol_conf = alt.molecule_confidence
                    second_best_mol_reads = len(alt.active_alignments)
        else:
            for aln in arr:
                for mate in alignments[aln.mate_id]:
                    s = score_alignment(aln, mate, log_molecule_penalty,
                                        improper_pair_penalty)
                    if not aln.active and s > second_best_logp:
                        second_best_logp = s
                        second_best_raw = score_alignment(
                            aln, mate, 0.0, improper_pair_penalty)
                        second_best_aln = aln
                        aln.mate_alignment = mate
                        second_best_proper = aln.is_proper
                        if aln.molecule_id != -1 and molecules:
                            alt = molecules[aln.molecule_id]
                            second_best_mol_conf = alt.molecule_confidence
                            second_best_mol_reads = len(alt.active_alignments)
        dbg_cache: Dict[int, Dict[int, str]] = {}
        for aln in arr:
            if aln.active:
                d = aln.mapq_data
                d.second_best = second_best_aln
                d.second_best_score = second_best_raw
                d.second_best_proper_pair = second_best_proper
                d.second_best_molecule_confidence = second_best_mol_conf
                d.second_best_molecule_reads = second_best_mol_reads
                d.copies = len(arr)
                d.copies_in_active_molecules = read_copies_in_active.get(
                    aln.read_id, 0)
                d.copies_outside_active_molecules = (
                    read_copies_not_in_active.get(read_id, 0))
                d.unique_molecules_active = len(
                    unique_molecules_active.get(read_id, {}))
                d.score = score_alignment(aln, aln.mate_alignment, 0.0,
                                          improper_pair_penalty)
                if molecules:
                    debug_strings(aln, alignments, molecules, dbg_cache,
                                  log_unpaired_probability)

        scores.sort()
        total_probability = 0.0
        i = len(scores) - 1
        while i >= 0 and len(scores) - i <= 15:
            total_probability += math.pow(10.0, scores[i])
            i -= 1

        for aln in arr:
            s = score_alignment(aln, aln.mate_alignment, log_molecule_penalty,
                                improper_pair_penalty)
            mapq = _neg10log10_1m(math.pow(10.0, s) / total_probability)
            molecule_mapq = _neg10log10_1m(1.0 / aln.sum_move_probability_change)
            mapq = min(mapq, molecule_mapq, 60.0)
            region = centromeres.get(aln.contig)
            start = region.start if region else -1
            end = region.end if region else -1
            if start < aln.pos <= end:
                mapq = 0.0
            aln.mapq = int(mapq)
    check_mates(alignments)


def check_mates(alignments: List[List[Alignment]]) -> None:
    """Panic-invariant from lariat.go:827-846."""
    for arr in alignments:
        for aln in arr:
            if aln.active and aln.mate_alignment is not None:
                if not aln.mate_alignment.active:
                    raise RuntimeError(
                        f"active alignment {aln.id} (read {aln.read_id}) has "
                        f"inactive mate {aln.mate_alignment.id}")
