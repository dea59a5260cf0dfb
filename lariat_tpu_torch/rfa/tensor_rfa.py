"""fastScore as masked (source x sink) tensor algebra (VERDICT r2 item 2).

The RFA move optimizer's inner loop — fastScore(source, sink) for every
candidate sink of the current source (lariat.go:1179-1307) — is a masked
reduction over the reads the source and sink share. This module expresses it
as dense per-barcode tensors:

  EX[m, r]   sink m's best_alignment_for_read contains read r
  LAP[m, r]  log_alignment_probability of that best alignment
  PB[m, r]   is_pair(best[m, r], best[m, mate(r)]) (static: best tables are
             immutable during optimization; mate(r) = r ^ 1)
  LENBEST[m] len(best_alignment_for_read)

and evaluates a whole source row (one source -> all candidate sinks) with
vectorized masked updates that REPLAY the scalar loop's float-addition order
exactly (masked lanes keep their previous value via np.where — never "+ 0.0"
— so results are byte-identical to rfa.optimizer.fast_score; asserted by
tests/test_tensor_rfa.py). The greedy sweep becomes propose (tensor row) ->
serialize-accept (the winning move is re-derived with the scalar fast_score,
which also re-checks the mismatch-locus invariants, then accepted on host) —
SURVEY.md section 7 step 4's "propose-then-serialize-accept".

A copy of lariat_tpu/rfa/tensor_rfa.py. Its jax.jit twin of the row kernel
(``_row_jit`` / ``_row_kernel_jnp``, selected by ``LARIAT_RFA_JIT``) is here
``_row_torch``: the same masked updates as a sequential loop of float64
``torch.where`` over the source's alignments, on the CPU (the workers never
touch CUDA), unpadded (the reference pads to power-of-two buckets only to
bound JAX retracing), and bit-identical to the numpy rows (no reduction).
The numpy rows stay the default; ``LARIAT_RFA_JIT=1`` selects the torch
rows and the CLI's summary then says ``rows: jit``.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from .scoring import is_pair
from .types import CandidateMolecule

# dense (M, R) tensors above this many cells fall back to the scalar sweep
MAX_CELLS = 40_000_000


class RFATensors:
    """Per-barcode dense tensors over (molecule, read)."""

    def __init__(self, molecules: List[CandidateMolecule], n_reads: int):
        M = len(molecules)
        self.M = M
        self.R = n_reads
        self.molecules = molecules
        self.EX = np.zeros((M, n_reads), bool)
        self.LAP = np.zeros((M, n_reads), np.float64)
        self.PB = np.zeros((M, n_reads), bool)
        self.LENBEST = np.zeros(M, np.int64)
        for m, mol in enumerate(molecules):
            best = mol.best_alignment_for_read
            self.LENBEST[m] = len(best)
            for read_id in best.keys():
                aln = best.get(read_id)
                self.EX[m, read_id] = True
                self.LAP[m, read_id] = aln.log_alignment_probability
            for read_id in best.keys():
                mate = best.get(read_id ^ 1)
                if mate is not None and is_pair(best.get(read_id), mate):
                    self.PB[m, read_id] = True

    @classmethod
    def build(cls, molecules: List[CandidateMolecule],
              alignments) -> Optional["RFATensors"]:
        """None when the dense layout would be too large (fallback scalar)."""
        n_reads = len(alignments)
        if not molecules or len(molecules) * n_reads > MAX_CELLS:
            return None
        return cls(molecules, n_reads)

    # ------------------------------------------------------------- proposals

    def fast_score_row(self, source: CandidateMolecule, src_idx: int,
                       K: np.ndarray, log_unpaired_probability: float):
        """(change[K], num[K]) for moving source's movable reads into each
        candidate sink, byte-identical to scalar fast_score per sink.

        K must not contain src_idx (the scalar loop's source==sink special
        cases all hinge on source.id != sink.id being true)."""
        if rows_jit():
            return self._row_torch(source, src_idx, K,
                                   log_unpaired_probability)
        return self._row_numpy(source, src_idx, K, log_unpaired_probability)

    def _row_numpy(self, source, src_idx, K, lup):
        EXK = self.EX[K]
        LAPK = self.LAP[K]
        PBK = self.PB[K]
        nK = len(K)
        ac = np.zeros(nK)
        num = np.zeros(nK, np.int64)
        half = lup / 2.0
        act = source.active_alignments
        for a in act.values():               # exact map iteration order
            r = a.read_id
            mask = EXK[:, r]
            # alignment_change += sink_lap - src_lap   (one add per lane)
            ac = np.where(mask, ac + (LAPK[:, r]
                                      - a.log_alignment_probability), ac)
            src_mate = act.get(a.mate_id)
            if src_mate is not None:
                shmp = is_pair(a, src_mate)
                sink_hmp = EXK[:, a.mate_id] & PBK[:, r]
            else:
                shmp = False
                sink_hmp = np.zeros(nK, bool)
            if shmp:
                ac = np.where(mask & ~sink_hmp, ac + half, ac)
            else:
                ac = np.where(mask & sink_hmp, ac - half, ac)
            num = num + mask
        return self._finish_row(source, K, ac, num)

    def _finish_row(self, source, K, ac, num):
        """Molecule birth/death + empty/fill terms, replaying the scalar
        change-accumulation order, then + alignment_change."""
        nK = len(K)
        n_src_act = len(source.active_alignments)
        n_src_best = len(source.best_alignment_for_read)
        change = np.zeros(nK)
        # source death (scalar order: change -= len(src.best) * -0.5)
        if _is_active(n_src_act, 0, n_src_best):
            saa = _is_active_vec(np.full(nK, n_src_act), -num, n_src_best)
            change = np.where(~saa, change - (n_src_best * -0.5), change)
        # sink birth
        cK = np.array([len(self.molecules[k].active_alignments) for k in K],
                      np.int64)
        sbb = _is_active_vec(cK, 0, self.LENBEST[K])
        sba = _is_active_vec(cK, num, self.LENBEST[K])
        change = np.where(sba & ~sbb,
                          change + (self.LENBEST[K] * -0.5), change)
        emptied = (n_src_act - num == 0) & (num > 0)
        change = np.where(emptied, change - (-3.0), change)
        filled = (cK == 0) & (num > 0)
        change = np.where(filled, change + (-3.0), change)
        change = change + ac
        return change, num


    def _row_torch(self, source, src_idx, K, lup):
        """The torch twin of ``_row_numpy`` (the reference's ``_row_jit``):
        per source alignment, in the map's order, ``ac + (LAPK[:, r] -
        sl)`` under its mask, then the ``+ lup / 2.0`` or ``- lup / 2.0``
        select, in float64 on the CPU; birth/death terms on the host."""
        import torch

        EXK = torch.from_numpy(self.EX[K])
        LAPK = torch.from_numpy(self.LAP[K])
        PBK = torch.from_numpy(self.PB[K])
        nK = len(K)
        ac = torch.zeros(nK, dtype=torch.float64)
        num = torch.zeros(nK, dtype=torch.int64)
        half = lup / 2.0
        act = source.active_alignments
        for a in act.values():
            r = a.read_id
            sm = act.get(a.mate_id)
            shmp = sm is not None and is_pair(a, sm)
            mask = EXK[:, r]
            ac = torch.where(mask, ac + (LAPK[:, r]
                                         - a.log_alignment_probability), ac)
            if sm is not None:
                sink_hmp = EXK[:, a.mate_id] & PBK[:, r]
                if shmp:
                    ac = torch.where(mask & ~sink_hmp, ac + half, ac)
                else:
                    ac = torch.where(mask & sink_hmp, ac - half, ac)
            num = num + mask
        return self._finish_row(source, K, ac.numpy(), num.numpy())


def rows_jit() -> bool:
    """``LARIAT_RFA_JIT`` set (not empty, not 0): the torch rows."""
    return os.environ.get("LARIAT_RFA_JIT") not in (None, "", "0")


def _is_active(n_act: int, delta: int, n_best: int) -> bool:
    active = n_act + delta
    if active <= 4:
        return False
    if active / n_best < 0.1:
        return False
    return True


def _is_active_vec(n_act: np.ndarray, delta, n_best) -> np.ndarray:
    active = n_act + delta
    return (active > 4) & (active / n_best >= 0.1)
