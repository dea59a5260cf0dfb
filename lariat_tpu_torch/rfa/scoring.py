"""Alignment pair scoring (reference inference/lariat.go:590-624, 1102-1133)."""

from __future__ import annotations

from typing import Optional

from .types import Alignment


def is_pair(read1: Alignment, read2: Alignment) -> bool:
    """Proper-pair test: opposite strands, same contig, -35 <= dist < 750
    (lariat.go:1102-1133)."""
    if read1.reversed_ == read2.reversed_ or read1.contig != read2.contig:
        return False
    if read1.reversed_:
        forward, reverse = read2, read1
    else:
        forward, reverse = read1, read2
    dist = reverse.pos - forward.pos
    return -35 <= dist < 750


def _part(a: Alignment) -> float:
    """Per-alignment term of scoreAlignment (cached; all terms are exact
    multiples of 0.5 so the cached partial sum is bit-identical to the
    sequential accumulation)."""
    p = a.score_part
    if p is None:
        p = a.mismatches * -2.0 + a.indels * -3.0
        if a.soft_clipped > 0:
            p -= 5.0 * a.soft_clipped
            p -= a.soft_clipped_length * 0.5
        a.score_part = p
    return p


def score_alignment(aln: Optional[Alignment], mate: Optional[Alignment],
                    log_molecule_penalty: float,
                    improper_pair_penalty: float) -> float:
    """scoreAlignment (lariat.go:599-624): mismatch -2, indel -3, soft clip
    -5/side -0.5/base, improper-pair penalty, molecule penalty."""
    score = 0.0
    if aln is not None:
        score += _part(aln)
    if mate is not None:
        score += _part(mate)
    if mate is None or aln is None or not is_pair(aln, mate):
        score += improper_pair_penalty
    if aln is not None and not aln.active_molecule:
        score += log_molecule_penalty
    return score


def _read_arrays(arr):
    """Static per-read score arrays (part0, pos, reversed, contig_id),
    cached on arr[0] — the covered fields are immutable after
    GetAlignments. Falls back to per-call string contig ids when an
    Alignment was built outside get_alignments (contig_id unassigned)."""
    import numpy as np

    t = arr[0].score_arrays
    if t is None or len(t[0]) != len(arr):
        part0 = 0.0 + np.array([_part(a) for a in arr], np.float64)
        pos = np.array([a.pos for a in arr], np.int64)
        rev = np.array([a.reversed_ for a in arr], bool)
        if all(a.contig_id >= 0 for a in arr):
            cid = np.array([a.contig_id for a in arr], np.int64)
        else:
            cid = None
        t = (part0, pos, rev, cid)
        # Always (re)attach so a length change (e.g. appended split-read
        # supplementaries) refreshes the cache instead of recomputing on
        # every later call while a stale tuple lingers.
        arr[0].score_arrays = t
    elif __debug__ and len(arr) > 0:
        # The cache is only sound if the covered fields never mutate after
        # get_alignments; spot-check the first entry cheaply.
        assert t[1][0] == arr[0].pos and bool(t[2][0]) == bool(arr[0].reversed_), \
            "Alignment pos/reversed_ mutated after score-array caching"
    return t


def pair_total_matrix(arr, mates, improper_pair_penalty: float,
                      log_molecule_penalty: float):
    """(n_a, n_m) matrix of score_alignment(arr[i], mates[j], lmp, ipp).

    Bit-identical to the scalar calls: the float additions replay the exact
    scalar order ((0 + part_a) + part_b, then +ipp when not a proper pair,
    then +lmp when arr[i] has no active molecule).
    """
    import numpy as np

    pa, posa, ra, ca = _read_arrays(arr)
    pm, posm, rm, cm = _read_arrays(mates)
    if ca is None or cm is None:
        ids = {}
        ca = np.array([ids.setdefault(a.contig, len(ids)) for a in arr])
        cm = np.array([ids.setdefault(m.contig, len(ids)) for m in mates])
    dist = np.where(ra[:, None], posa[:, None] - posm[None, :],
                    posm[None, :] - posa[:, None])
    pair = ((ra[:, None] != rm[None, :]) & (ca[:, None] == cm[None, :])
            & (dist >= -35) & (dist < 750))
    tot = pa[:, None] + pm[None, :]
    tot = np.where(pair, tot, tot + improper_pair_penalty)
    if log_molecule_penalty != 0.0:
        act = np.array([a.active_molecule for a in arr], bool)
        tot = np.where(act[:, None], tot, tot + log_molecule_penalty)
    return tot


def single_total_vector(arr, improper_pair_penalty: float,
                        log_molecule_penalty: float):
    """(n_a,) vector of score_alignment(arr[i], None, lmp, ipp)."""
    import numpy as np

    pa = _read_arrays(arr)[0]
    tot = pa + improper_pair_penalty
    if log_molecule_penalty != 0.0:
        act = np.array([a.active_molecule for a in arr], bool)
        tot = np.where(act, tot, tot + log_molecule_penalty)
    return tot


def pseudo_count_alignment_score(aln: Alignment,
                                 log_molecule_penalty: float) -> float:
    """psuedoCountAlignmentScore (lariat.go:590-597): hypothetical unmapped
    25bp-alignment hypothesis."""
    pseudo_len = 25.0
    score = 0.0
    score -= 10.0                                       # max soft-clip sides
    score -= (len(aln.read_seq) - pseudo_len) * 0.5     # soft-clip length
    score += log_molecule_penalty
    return score
