"""Regenerate data_big/ (the bench's chr20- and hg38-scale inputs) with the
port's index builder: the port of tools/gen_data_big.py.

    python -m lariat_tpu_torch.tools.gen_data_big [DIR]    # default data_big/

The same steps and sizes as the reference: chr20 scale first (a 64 Mbp
genome, ``tools/synth_genome.py --scale 0.0208 --seed 7``, and 10,000
barcodes x 100 pairs), then hg38 scale (``--scale 1.0`` with its
centromeres; the 200k, 50k and 10k read sets). The genomes and reads come
from ``tools/synth_genome.py`` and ``tools/sim_reads.py`` run as
subprocesses; each index is built by the port's ``index/fmindex.py`` and
written as the mmap-able ``.lariat.d`` directory. After each build a line
gives its seconds and the process's peak RSS. The port's build holds only
the text, T$, the suffix array and SA-IS's own vectors at once: the hg38
step peaks at about 70 GiB of RSS (the reference's build near 124 GB) and
takes about half an hour on an 8-core H100 host.

    python -m lariat_tpu_torch.tools.gen_data_big DIR --cut 0.36

builds only what ``chip_smoke.py``'s hg38 phase reads, with the hg38 step's
genome at that scale (0.36: 1.11 Gbp, a doubled text past 2^31): the
genome, its centromeres, its index and the 10k read set. Give it a
directory of its own: its genome keeps the name ``hg38sim.fa``.

    python -m lariat_tpu_torch.tools.gen_data_big DIR --chr20

builds only the chr20 step, what ``chip_smoke.py``'s chr20 x 1M phase
reads: ``chr20sim.fa`` (64,228,320 bp), its index and
``sim1m_chr20.fastq.gz`` (10,000 barcodes x 100 pairs), at the reference's
sizes and seeds.

    python -m lariat_tpu_torch.tools.gen_data_big DIR --hg38 [--cut SCALE]

builds only the hg38 step: ``hg38sim.fa`` (3.09 Gbp, or ``--cut``'s
scale), its centromeres, its index and the 200k, 50k and 10k read sets
(4,000, 1,000 and 200 barcodes x 50 pairs), what ``chip_smoke.py``'s hg38
phases read; nothing of chr20.

Every output is written under a ``.part`` name and renamed into place when
complete, so an output that exists is whole; each step runs only when its
output is missing. One generator at a time: ``DIR/.gen.lock`` is held with
``fcntl.flock`` for the whole run, so a second generator blocks until the
first is done (or dies: the kernel drops its lock) and then finds every
output present and builds nothing. Each step's seconds are printed on a
line of their own.
"""

from __future__ import annotations

import argparse
import fcntl
import os
import resource
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO, "data_big")


# the chr20 step: the genome's scale and seed, barcodes x pairs a barcode
CHR20_SCALE = 0.0208
CHR20_READS = (10000, 100)
# the hg38 step's read sets: (file, barcodes, pairs a barcode)
HG38_READS = (("sim200k.fastq.gz", 4000, 50), ("sim50k.fastq.gz", 1000, 50),
              ("sim10k.fastq.gz", 200, 50))


def run(args: list) -> None:
    """One of the repository's generator scripts, as a subprocess; its
    seconds on a line of their own."""
    print("+", " ".join(args), flush=True)
    t0 = time.time()
    subprocess.run([sys.executable] + args, check=True, cwd=REPO)
    print(f"{os.path.basename(args[0])}: {time.time() - t0:.1f} s",
          flush=True)


def build(fa: str, sa_intv: int = 32) -> None:
    """The index of ``fa`` (port ``fmindex``) written to
    ``fa.lariat.d``, through a ``.part`` directory renamed when done."""
    from ..index import fmindex
    t0 = time.time()
    fm = fmindex.build_index(fa, sa_intv=sa_intv)
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"build {fa}: {time.time() - t0:.1f} s, peak RSS {peak:.2f} GiB, "
          f"l_pac={fm.l_pac:,}", flush=True)
    t0 = time.time()
    part = fa + ".part"
    shutil.rmtree(part + ".lariat.d", ignore_errors=True)
    fm.save_dir(part)
    shutil.rmtree(fa + ".lariat.d", ignore_errors=True)
    os.replace(part + ".lariat.d", fa + ".lariat.d")
    print(f"save_dir: {time.time() - t0:.0f}s", flush=True)


def _reads(fa: str, out: str, barcodes: int, pairs_per_bc: int) -> None:
    if os.path.exists(out):
        return
    part = out[:-len(".fastq.gz")] + ".part.fastq.gz"
    run(["tools/sim_reads.py", fa, part, "--barcodes", str(barcodes),
         "--pairs-per-bc", str(pairs_per_bc)])
    os.replace(part, out)


def generate(db: str, cut: float = 0.0, chr20: bool = False,
             chr20_scale: float = CHR20_SCALE,
             chr20_reads: tuple = CHR20_READS, hg38: bool = False,
             hg38_reads: tuple = HG38_READS) -> None:
    """Every missing output of ``db``, in the reference's order; with
    ``chr20``, only the chr20 step, its genome at ``chr20_scale`` and
    ``chr20_reads`` (barcodes, pairs a barcode); with ``hg38``, only the
    hg38 step, its genome at ``cut`` when given and ``hg38_reads``; with
    ``cut`` alone, only the hg38 step's genome at that scale, its index
    and the 10k read set. The sizes are the reference's unless a test
    shrinks them."""
    os.makedirs(db, exist_ok=True)
    # --- chr20 scale (~64 Mbp) + 1M pairs ---
    c20 = os.path.join(db, "chr20sim.fa")
    if not (cut or hg38) and not os.path.isdir(c20 + ".lariat.d"):
        run(["tools/synth_genome.py", c20, "--scale", str(chr20_scale),
             "--seed", "7"])
        build(c20)
    if not (cut or hg38):
        _reads(c20, os.path.join(db, "sim1m_chr20.fastq.gz"), *chr20_reads)
    if chr20:
        print("chr20 step complete", flush=True)
        return
    # --- hg38 scale (3.09 Gbp) + 200k/50k/10k pairs ---
    hg = os.path.join(db, "hg38sim.fa")
    if not os.path.isdir(hg + ".lariat.d"):
        run(["tools/synth_genome.py", hg, "--scale", str(cut or 1.0),
             "--seed", "7", "--centromeres",
             os.path.join(db, "hg38sim.centromeres.tsv")])
        build(hg)
    for name, bcs, ppb in hg38_reads:
        if hg38 or not cut or name == "sim10k.fastq.gz":
            _reads(hg, os.path.join(db, name), bcs, ppb)
    print("data_big complete", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="lariat_tpu_torch.tools.gen_data_big")
    p.add_argument("dir", nargs="?", default=DEFAULT_DIR,
                   help="output directory (default: data_big/ at the "
                        "repository root)")
    p.add_argument("--cut", type=float, default=0.0, metavar="SCALE",
                   help="the hg38 step's genome at this scale; alone, only "
                        "that genome, its index and the 10k read set")
    p.add_argument("--chr20", action="store_true",
                   help="only the chr20 step: its genome, index and 1M "
                        "pairs")
    p.add_argument("--hg38", action="store_true",
                   help="only the hg38 step: its genome, centromeres, index "
                        "and the 200k, 50k and 10k read sets")
    args = p.parse_args(argv)
    if args.chr20 and (args.cut or args.hg38):
        p.error("--chr20 and --cut or --hg38 build different steps: give "
                "one")
    db = os.path.abspath(args.dir)
    os.makedirs(db, exist_ok=True)
    with open(os.path.join(db, ".gen.lock"), "a") as lock:
        try:
            fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except BlockingIOError:
            print(f"another generator holds {db}/.gen.lock; waiting",
                  flush=True)
            fcntl.flock(lock, fcntl.LOCK_EX)
        generate(db, args.cut, args.chr20, hg38=args.hg38)
    return 0


if __name__ == "__main__":
    sys.exit(main())
