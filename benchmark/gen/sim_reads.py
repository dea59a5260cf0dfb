"""Barcoded 10x-style linked reads from a genome, vectorised.

The molecule model is that of the repository's ``tools/sim_reads.py``:
each barcode carries a few long molecules placed on contigs in proportion
to their length, and each molecule sheds read pairs at uniform positions.
What a traffic mix adds to it (keys of the mix file):

- ``insert``, ``insert_sd``, ``insert_max``: the fragment length is drawn
  from a normal law of mean ``insert`` and this spread, drawn again while
  it falls under the read length or over ``insert_max``;
- read 1 comes off either end of its fragment (forward at the left end,
  read 2 reverse at the right; or the other way round), each with
  probability one half;
- ``indel_rate`` a base, ``indel_len_p``, ``indel_len_max``: each read
  takes ``Binomial(read_len, indel_rate)`` indels (at most
  ``MAX_INDELS``), insertion or deletion alike, of
  ``Geometric(indel_len_p)`` bases capped at ``indel_len_max``, at inner
  positions of the read;
- ``error_rate``: ``Binomial(read_len, error_rate)`` substitutions a read
  by a uniform base.

Truth is in the qname in the reference's colon format
(``sim:BC:contig:molecule:i:pos1:pos2``: each read's leftmost base,
contig-relative), so the CLI's ``-simulated`` accounting works; the
strands and each gapped read's alignment are kept beside the reads for the
judge. Records are barcode-grouped, in the 9-line format that
``FastQReader`` reads, written as plain FASTQ.

Everything is drawn from one generator seeded by the run's seed, in whole
arrays (the few gapped reads one by one), so a run's reads take seconds
where the per-read tool took minutes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_LUT = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclasses.dataclass
class Reads:
    """One run's read pairs, barcode-grouped, in file order."""
    barcodes: list          # str, one per barcode
    bc_of: np.ndarray       # (N,) barcode index of each pair
    qnames: list            # str, one per pair
    contig: np.ndarray      # (N,) contig index of the molecule
    pos1: np.ndarray        # (N,) read 1's truth start (contig-relative)
    pos2: np.ndarray        # (N,) read 2's truth start (leftmost base)
    r1: np.ndarray          # (N, L) uint8 codes 0-3, as written
    r2: np.ndarray          # (N, L) uint8 codes 0-3, as written
    rev: np.ndarray         # (N, 2) read 1's and read 2's truth strand
    gapped: dict            # 2 * pair + mate: truth CIGAR [(op, len)], on
                            # the genome strand, of each read with indels

    @property
    def n(self) -> int:
        return len(self.qnames)

    def group_bounds(self) -> np.ndarray:
        """(B + 1,) offsets of each barcode's first pair, then N."""
        starts = np.flatnonzero(np.diff(self.bc_of, prepend=-1))
        return np.append(starts, self.n)


def rng_for(seed: int) -> np.random.Generator:
    """The run's generator: any whole number, negative ones too."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0)])


def make_barcodes(rng: np.random.Generator, n: int) -> list:
    """Unique 14-mers: 7 random bases, then 7 bases spelling the index
    (two bits a base, low bits first), as ``make_barcode`` does."""
    head = rng.integers(0, 4, (n, 7))
    idx = np.arange(n)[:, None] >> (2 * np.arange(7))[None, :]
    codes = np.concatenate([head, idx & 3], axis=1).astype(np.uint8)
    return [row.tobytes().decode() for row in _LUT[codes]]


MAX_INDELS = 4


def _inserts(rng, n, mean, sd, lo, hi) -> np.ndarray:
    """``n`` fragment lengths from N(mean, sd), drawn again outside
    [lo, hi]."""
    out = np.rint(rng.normal(mean, sd, n)).astype(np.int64)
    bad = np.flatnonzero((out < lo) | (out > hi))
    while bad.size:
        out[bad] = np.rint(rng.normal(mean, sd, bad.size)).astype(np.int64)
        bad = bad[(out[bad] < lo) | (out[bad] > hi)]
    return out


def _gapped(rng, codes, start, k, L, p, dmax):
    """One read of ``L`` bases from genome offset ``start`` with ``k``
    indels: (its bases on the genome strand, its truth CIGAR)."""
    at = np.sort(rng.choice(np.arange(1, L), k, replace=False)).tolist()
    kinds = rng.integers(0, 2, k).tolist()
    lens = np.minimum(rng.geometric(p, k), dmax).tolist()
    parts, cig, g, q = [], [], start, 0
    for a, kind, ln in zip(at, kinds, lens):
        if a <= q:
            continue
        parts.append(np.asarray(codes[g:g + a - q]))
        cig.append((0, a - q))
        g, q = g + a - q, a
        if kind == 0:
            ln = min(ln, L - q - 1)
            if ln <= 0:
                continue
            parts.append(rng.integers(0, 4, ln).astype(np.uint8))
            cig.append((1, ln))
            q += ln
        else:
            cig.append((2, ln))
            g += ln
    parts.append(np.asarray(codes[g:g + L - q]))
    cig.append((0, L - q))
    return np.concatenate(parts), cig


def simulate(codes: np.ndarray, contigs: list, n_barcodes: int, mix: dict,
             seed: int) -> Reads:
    """``n_barcodes`` x ``mix["pairs_per_bc"]`` pairs from the genome
    ``codes`` (uint8 0-3, contigs concatenated; ``contigs`` is [(name,
    offset, length)]), by the traffic mix ``mix``."""
    rng = rng_for(seed)
    L, M = int(mix["read_len"]), int(mix["molecules_per_bc"])
    pairs_per_bc = int(mix["pairs_per_bc"])
    ins_max, dmax = int(mix["insert_max"]), int(mix["indel_len_max"])
    # room past a read's leftmost base for its deletions
    span = ins_max + MAX_INDELS * dmax
    lens = np.array([c[2] for c in contigs], dtype=np.int64)
    offs = np.array([c[1] for c in contigs], dtype=np.int64)
    barcodes = make_barcodes(rng, n_barcodes)

    # molecules: a contig by length, a start, a length cut to the contig
    mol_contig = rng.choice(len(contigs), size=(n_barcodes, M),
                            p=lens / lens.sum())
    clen = lens[mol_contig]
    mlen = np.minimum(int(mix["molecule_len"]), clen - span - 1)
    mstart = rng.integers(0, clen - mlen - span)

    # pairs: molecule m of a barcode sheds pairs_per_bc // M pairs, the
    # first pairs_per_bc % M molecules one more
    per = np.full(M, pairs_per_bc // M)
    per[:pairs_per_bc % M] += 1
    mol_of = np.repeat(np.arange(M), per)                  # (P,)
    i_of = np.concatenate([np.arange(k) for k in per])     # (P,)
    N = n_barcodes * pairs_per_bc
    bc_of = np.repeat(np.arange(n_barcodes), pairs_per_bc)
    mol = np.tile(mol_of, n_barcodes)
    contig = mol_contig[bc_of, mol]
    left = mstart[bc_of, mol] + rng.integers(0, mlen[bc_of, mol])
    right = left + _inserts(rng, N, mix["insert"], mix["insert_sd"], L,
                            ins_max) - L
    flip = rng.random(N) < 0.5
    pos1 = np.where(flip, right, left)
    pos2 = np.where(flip, left, right)
    rev = np.stack([flip, ~flip], 1)

    # each read on the genome strand (read 1s, then read 2s), its indels,
    # its substitutions, then the reverse ones reverse-complemented
    start = np.concatenate([offs[contig] + pos1, offs[contig] + pos2])
    cols = np.arange(L, dtype=np.int64)[None, :]
    reads = codes[start[:, None] + cols]
    gapped = {}
    k = np.minimum(rng.binomial(L, float(mix["indel_rate"]), 2 * N),
                   MAX_INDELS)
    p = float(mix["indel_len_p"])
    for r in np.flatnonzero(k).tolist():
        reads[r], cig = _gapped(rng, codes, int(start[r]), int(k[r]), L, p,
                                dmax)
        if len(cig) > 1:
            gapped[2 * (r % N) + r // N] = cig
    n_sub = rng.binomial(L, float(mix["error_rate"]), 2 * N)
    rows = np.repeat(np.arange(2 * N), n_sub)
    reads[rows, rng.integers(0, L, rows.size)] = rng.integers(
        0, 4, rows.size).astype(np.uint8)
    back = np.concatenate([rev[:, 0], rev[:, 1]])
    reads[back] = (3 - reads[back])[:, ::-1]

    names = [c[0] for c in contigs]
    qnames = [f"sim:{barcodes[b]}:{names[c]}:{m}:{i}:{p1}:{p2}"
              for b, c, m, i, p1, p2 in zip(
                  bc_of.tolist(), contig.tolist(), mol.tolist(),
                  np.tile(i_of, n_barcodes).tolist(), pos1.tolist(),
                  pos2.tolist())]
    return Reads(barcodes=barcodes, bc_of=bc_of, qnames=qnames,
                 contig=contig, pos1=pos1, pos2=pos2, r1=reads[:N],
                 r2=reads[N:], rev=rev, gapped=gapped)


def write_fastq(path: str, reads: Reads, start: int = 0,
                end: int | None = None) -> int:
    """Pairs ``start:end`` of ``reads`` as plain barcode-grouped FASTQ;
    returns the pairs written."""
    end = reads.n if end is None else end
    L = reads.r1.shape[1]
    qual = b"I" * L
    t1 = _LUT[reads.r1[start:end]]
    t2 = _LUT[reads.r2[start:end]]
    tail = {}
    parts = []
    for j in range(end - start):
        k = start + j
        b = int(reads.bc_of[k])
        t = tail.get(b)
        if t is None:
            bc = reads.barcodes[b]
            t = tail[b] = (f"\n{bc}-1,{bc}\n{'J' * 14}\nACGTACGT\n"
                           f"IIIIIIII\n").encode()
        parts += (b"@", reads.qnames[k].encode(), b" rg\n", t1[j].tobytes(),
                  b"\n", qual, b"\n", t2[j].tobytes(), b"\n", qual, t)
    with open(path, "wb") as f:
        f.write(b"".join(parts))
    return end - start
