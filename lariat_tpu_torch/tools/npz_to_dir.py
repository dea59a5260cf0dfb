"""Convert a .lariat.npz index to the mmap-able .lariat.d directory format:
the port of tools/npz_to_dir.py, on the port's ``index/fmindex.py``.

    python -m lariat_tpu_torch.tools.npz_to_dir data_big/hg38sim.fa

Computes occ_ckpt if the npz predates its persistence. The directory
format loads in milliseconds (``np.load(mmap_mode='r')``); the npz needs a
full stream-read into anonymous memory (minutes at hg38 scale).
"""

from __future__ import annotations

import sys
import time

from ..index.fmindex import FMIndex


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if not args:
        print("usage: python -m lariat_tpu_torch.tools.npz_to_dir <prefix>",
              file=sys.stderr)
        return 2
    prefix = args[0]
    t0 = time.time()
    fm = FMIndex.load(prefix)
    print(f"load npz (+occ if missing): {time.time() - t0:.0f}s", flush=True)
    t0 = time.time()
    fm.save_dir(prefix)
    print(f"save dir: {time.time() - t0:.0f}s -> {prefix}.lariat.d",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
