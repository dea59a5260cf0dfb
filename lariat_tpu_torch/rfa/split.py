"""Split-read (supplementary/SA) detection (reference inference/split.go)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .scoring import is_pair, pseudo_count_alignment_score, score_alignment
from .types import Alignment, MapQData, Region


def get_split_alignment(primary: Alignment, alignments: List[Alignment],
                        centromeres: Dict[str, Region],
                        improper_pair_penalty: float
                        ) -> Tuple[Optional[Alignment], float]:
    """split.go:29-137: pick a supplementary alignment covering a distinct
    read segment."""
    if primary.pos == -1:
        return None, 0.0
    ps, pe = primary.readmap_s, primary.readmap_e
    if ps > pe:
        ps, pe = pe, ps
    if (pe - ps) > len(primary.read_seq) - 15:
        return None, 0.0
    candidates: List[Tuple[Alignment, float]] = []
    for cand in alignments:
        if cand.active or cand.pos == -1:
            continue
        ss, se = cand.readmap_s, cand.readmap_e
        if ss > se:
            ss, se = se, ss
        if (ps < ss and pe > se) or (ss < ps and se > pe):
            continue  # fully contained either way
        elif ps < ss:
            overlap = pe - ss
        else:
            overlap = se - ps
        if overlap < (se - ss) // 2:
            cand.is_proper = is_pair(cand, primary.mate_alignment) \
                if primary.mate_alignment is not None else False
            if cand.score >= 36 or cand.is_proper:
                candidates.append((cand, float(cand.score)))
    if not candidates:
        return None, 0.0
    candidates.sort(key=lambda cs: -cs[1])
    c = candidates[0][0]
    second_best = (score_alignment(primary, None, 0.0, improper_pair_penalty)
                   + pseudo_count_alignment_score(candidates[0][0], 0.0))
    if len(candidates) > 1:
        mapq = float(candidates[0][0].score - candidates[1][0].score)
        second_best = score_alignment(primary, candidates[1][0], 0.0,
                                      improper_pair_penalty)
    else:
        mapq = float(candidates[0][0].score)
    region = centromeres.get(c.contig)
    start = region.start if region else -1
    end = region.end if region else -1
    if start < c.pos <= end:
        mapq = 0.0
    mapq = min(mapq, 60.0)
    c.mapq = int(mapq)
    return c, second_best


def check_split_reads(reads: List[List[Alignment]],
                      centromeres: Dict[str, Region],
                      improper_pair_penalty: float) -> None:
    """split.go:142-158: attach a supplementary to each read's primary."""
    for arr in reads:
        active = None
        for a in arr:
            if a.active:
                active = a
                break
        if active is None:
            continue
        split, second_best = get_split_alignment(
            active, arr, centromeres, improper_pair_penalty)
        active.secondary = split
        if split is not None:
            split.mapq_data = MapQData(
                second_best_score=second_best,
                score=score_alignment(split, active.mate_alignment, 0.0,
                                      improper_pair_penalty))
            split.primary = active
