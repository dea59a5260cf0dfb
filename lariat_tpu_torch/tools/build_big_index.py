"""Build a large index offline and save it as an uncompressed .lariat.npz:
the port of tools/build_big_index.py, on the port's ``index/fmindex.py``.

    python -m lariat_tpu_torch.tools.build_big_index data_big/hg38sim.fa \\
        --sa-intv 32

Saves the UNCOMPRESSED ``.lariat.npz`` next to the FASTA (compressing ~9
GB of high-entropy arrays costs tens of minutes for next to nothing;
``np.load`` reads both). A 3.1 Gbp genome peaks near 90 GB of RAM (int64
SA-IS over the 6.2 Gbp doubled FMD text).
"""

from __future__ import annotations

import argparse
import resource
import sys
import time

import numpy as np

from ..index import fmindex


def save_uncompressed(fm, prefix: str) -> None:
    np.savez(
        prefix + ".lariat.npz",
        l_pac=fm.l_pac, primary=fm.primary, L2=fm.L2,
        bwt_codes=fm.bwt_codes, sa_intv=fm.sa_intv,
        sa_samples=fm.sa_samples, pac=fm.pac,
        occ_ckpt=fm.occ_ckpt,
        contig_names=np.array([c.name for c in fm.contigs]),
        contig_offsets=np.array([c.offset for c in fm.contigs]),
        contig_lengths=np.array([c.length for c in fm.contigs]),
        amb_offsets=np.array([a.offset for a in fm.ambs], dtype=np.int64),
        amb_lengths=np.array([a.length for a in fm.ambs], dtype=np.int64),
        amb_bases=np.array([a.base for a in fm.ambs]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lariat_tpu_torch.tools.build_big_index")
    p.add_argument("fasta")
    p.add_argument("--sa-intv", type=int, default=32)
    args = p.parse_args(argv)
    t0 = time.time()
    fm = fmindex.build_index(args.fasta, sa_intv=args.sa_intv)
    t_build = time.time() - t0
    peak_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"build: {t_build:.0f}s, peak RSS {peak_gb:.1f} GB, "
          f"l_pac={fm.l_pac:,}, sa_intv={fm.sa_intv}", flush=True)
    t0 = time.time()
    save_uncompressed(fm, args.fasta)
    print(f"save: {time.time() - t0:.0f}s -> {args.fasta}.lariat.npz",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
