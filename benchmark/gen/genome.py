"""A configuration's genome and index, built once per checkout.

``ensure(config, cache_dir)`` returns the cache of one configuration,
building it in a subprocess when it is missing:

- ``genome.fa``: ``synth_genome``'s genome at the configuration's scale
  and seed, contig by contig in its order, so the bytes are those of
  ``synth_genome.py --scale S --seed X``;
- ``genome.cen.tsv``: its centromeres (the alpha-satellite arrays);
- ``genome.codes.npy`` and ``genome.contigs.json``: the same bases as one
  uint8 array (0-3) and [name, offset, length] a contig, which the read
  generator and the reference read;
- ``genome.fa.lariat.d/``: the port's index, built by its
  ``index/fmindex.py`` ``build_index`` and saved with ``save_dir``, as a
  user indexes a reference once;
- ``done.json``: the configuration's genome keys and the build's seconds,
  written last, so a cut build is rebuilt.

    python benchmark/gen/genome.py CONFIG.json CACHE_DIR
"""

from __future__ import annotations

import fcntl
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GENOME_KEYS = ("scale", "genome_seed", "centromeres", "sa_intv")


def genome_spec(config: dict) -> dict:
    return {k: config[k] for k in GENOME_KEYS}


def paths(cache_dir: str) -> dict:
    fa = os.path.join(cache_dir, "genome.fa")
    return {"fa": fa, "cen": os.path.join(cache_dir, "genome.cen.tsv"),
            "codes": os.path.join(cache_dir, "genome.codes.npy"),
            "contigs": os.path.join(cache_dir, "genome.contigs.json"),
            "index": fa + ".lariat.d",
            "done": os.path.join(cache_dir, "done.json")}


def _ready(cache_dir: str, spec: dict) -> bool:
    p = paths(cache_dir)
    try:
        with open(p["done"]) as f:
            return json.load(f).get("spec") == spec
    except (OSError, ValueError):
        return False


def ensure(config: dict, cache_dir: str, env: dict | None = None,
           log=None) -> dict:
    """The cache's paths; builds what is missing (one builder at a time,
    under a lock beside the cache)."""
    spec = genome_spec(config)
    os.makedirs(cache_dir, exist_ok=True)
    with open(cache_dir.rstrip("/") + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _ready(cache_dir, spec):
            with open(os.path.join(cache_dir, "config.json"), "w") as f:
                json.dump(spec, f)
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 os.path.join(cache_dir, "config.json"), cache_dir],
                env=env, stdout=log, stderr=subprocess.STDOUT)
            if r.returncode != 0 or not _ready(cache_dir, spec):
                raise RuntimeError(f"genome build failed ({r.returncode})")
    return paths(cache_dir)


def load_codes(cache_dir: str):
    """(codes, contigs): the genome as uint8 0-3 and [(name, offset,
    length)]."""
    p = paths(cache_dir)
    with open(p["contigs"]) as f:
        contigs = [tuple(c) for c in json.load(f)]
    return np.load(p["codes"], mmap_mode="r"), contigs


def build(spec: dict, cache_dir: str) -> None:
    sys.path.insert(0, HERE)
    import synth_genome as sg
    os.makedirs(cache_dir, exist_ok=True)
    p = paths(cache_dir)
    t0 = time.time()
    rng = np.random.default_rng(spec["genome_seed"])
    alu = rng.integers(0, 4, sg.ALU_LEN, dtype=np.uint8)
    line = rng.integers(0, 4, sg.LINE_LEN, dtype=np.uint8)
    sat = rng.integers(0, 4, sg.SAT_MONOMER, dtype=np.uint8)
    parts, contigs, cens, off = [], [], [], 0
    with open(p["fa"], "wb") as f:
        for name, size in sg.CONTIG_SIZES:
            n = int(size * spec["scale"])
            if n < 10_000:
                continue
            contig, (cs, ce) = sg.make_contig(rng, n, alu, line, sat)
            sg.add_segdups(rng, contig, n_dups=max(1, n // 60_000_000))
            sg.write_fasta_contig(f, name, contig)
            if cs >= 0:
                cens.append((name, cs, ce))
            parts.append(contig)
            contigs.append((name, off, n))
            off += n
    np.save(p["codes"], np.concatenate(parts))
    del parts
    with open(p["contigs"], "w") as f:
        json.dump(contigs, f)
    with open(p["cen"], "w") as f:
        for name, cs, ce in cens:
            f.write(f"{name}\t{cs}\t{ce}\n")
    t_genome = time.time() - t0
    print(f"genome: {off} bases in {t_genome:.1f} s", flush=True)

    from lariat_tpu_torch.index import fmindex
    t0 = time.time()
    fm = fmindex.build_index(p["fa"], sa_intv=spec["sa_intv"])
    part = p["fa"] + ".part"
    shutil.rmtree(part + ".lariat.d", ignore_errors=True)
    fm.save_dir(part)
    shutil.rmtree(p["index"], ignore_errors=True)
    os.replace(part + ".lariat.d", p["index"])
    t_index = time.time() - t0
    print(f"index: l_pac {fm.l_pac} in {t_index:.1f} s", flush=True)
    with open(p["done"], "w") as f:
        json.dump({"spec": spec, "bases": off, "genome_s": t_genome,
                   "index_s": t_index}, f)


if __name__ == "__main__":
    with open(sys.argv[1]) as fh:
        build(json.load(fh), sys.argv[2])
