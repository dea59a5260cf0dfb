"""The one-call device step with example arguments: the port of
``__graft_entry__.py`` ``entry()``.

    from lariat_tpu_torch.tools.entry import entry
    fn, args = entry()            # the card; entry("cpu"): the plain twins
    result = fn(*args)            # an align_step.AlignStepResult

``entry`` builds a 20 kb synthetic genome's index with the port's own
``index.fmindex``, puts it on the device (``DeviceFMIndex``,
``DeviceGenome``) and returns ``align_step_smem`` -- round-1 SMEM seeding
by K4b, the SA lookup on the card (K5's lookup entry), then K1's step
entry: reads oriented in place, each window staged from the pac, banded
extension -- with 64 reads x 100 bp drawn from that genome (odd draws
reverse complemented, one substitution each), their lengths and bwa's
scoring matrix. On a CPU device every kernel wrapper runs its plain twin.
The multi-chip dry run of the reference entry module waits for the port's
multi-GPU slice.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from ..align.ksw import fill_score_matrix
from ..device import get_device
from ..index import fmindex
from ..ops.fm_batch import DeviceFMIndex
from ..parallel.align_step import DeviceGenome, align_step_smem


def toy_genome(n: int = 20000, seed: int = 3):
    """(FMIndex, genome bytes): a random genome of ``n`` bases, its index
    built from a FASTA in a temporary directory that is removed after."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    g = bases[rng.integers(0, 4, n)]
    with tempfile.TemporaryDirectory(prefix="lariat_entry_") as d:
        path = os.path.join(d, "toy.fa")
        with open(path, "w") as f:
            s = g.tobytes().decode()
            f.write(">chrT\n")
            for i in range(0, len(s), 70):
                f.write(s[i:i + 70] + "\n")
        fm = fmindex.build_index(path)
    return fm, g.tobytes()


def make_reads(genome_codes: np.ndarray, batch: int, length: int,
               seed: int = 5):
    """(reads (batch, length) uint8 codes, lens): the reference's draws."""
    rng = np.random.default_rng(seed)
    reads = np.zeros((batch, length), np.uint8)
    lens = np.full(batch, length, np.int32)
    for i in range(batch):
        pos = int(rng.integers(0, len(genome_codes) - length))
        seg = genome_codes[pos:pos + length].copy()
        if rng.integers(0, 2):
            seg = (3 - seg)[::-1]
        p = int(rng.integers(0, length // 2))
        seg[p] = (seg[p] + 1) % 4
        reads[i] = seg
    return reads, lens


def entry(device=None):
    """(fn, example_args): ``align_step_smem`` and (genome, reads, lens,
    mat) on ``device`` (the card unless the caller asks for the CPU)."""
    dev = get_device(device)
    fm, g = toy_genome()
    codes = fmindex.NT4_TABLE[np.frombuffer(g, dtype=np.uint8)]
    dg = DeviceGenome.from_host(fm, DeviceFMIndex.from_host(fm, dev))
    reads, lens = make_reads(codes, batch=64, length=100)
    mat = fill_score_matrix(1, 4)

    def fn(genome, reads, lens, mat):
        return align_step_smem(genome, reads, lens, mat)

    return fn, (dg, torch.from_numpy(reads).to(dev),
                torch.from_numpy(lens).to(dev), mat)
