"""chip_smoke.py's barcode-complete FASTQ shards (phases 15 and 22): the
streamed helper cuts whole barcodes in input order, counts every pair, and
gives the shards of the helper that read the whole file into memory."""

import gzip
import os

import numpy as np
import pytest

import chip_smoke


def _whole_file_shards(reads, n, out_dir):
    """The helper as it was: the whole FASTQ read into a list of lines."""
    with gzip.open(reads, "rt") as f:
        lines = f.read().splitlines(keepends=True)
    recs = [lines[i:i + 9] for i in range(0, len(lines), 9)]
    groups = []
    for rec in recs:
        bc = rec[5].split(",")[0]
        if not groups or groups[-1][0] != bc:
            groups.append((bc, []))
        groups[-1][1].append("".join(rec))
    per = -(-len(groups) // n)
    out = []
    for h in range(n):
        part = groups[h * per:(h + 1) * per]
        path = os.path.join(out_dir, f"shard{h}.fastq.gz")
        with gzip.open(path, "wt", compresslevel=1) as f:
            for _, rs in part:
                f.writelines(rs)
        out.append((path, sum(len(rs) for _, rs in part)))
    return out


def _fastq(path, sizes, seed):
    """A gzip FASTQ of barcode groups of ``sizes`` pairs, in that order;
    one barcode comes back later as a group of its own."""
    rng = np.random.default_rng(seed)
    bcs = [f"{''.join(rng.choice(list('ACGT'), 14))}-1" for _ in sizes]
    if len(bcs) > 3:
        bcs[-1] = bcs[1]
    with gzip.open(path, "wt") as f:
        for g, (bc, k) in enumerate(zip(bcs, sizes)):
            for i in range(k):
                r = "".join(rng.choice(list("ACGT"), 30))
                f.write(f"@g{g}:p{i} x\n{r}\n{'I' * 30}\n{r[::-1]}\n"
                        f"{'I' * 30}\n{bc},{bc[:-2]}\nJJJJJJJJJJJJJJ\n"
                        f"ACGTACGT\nIIIIIIII\n")
    return bcs


def _records(path):
    with gzip.open(path, "rt") as f:
        lines = f.read().splitlines(keepends=True)
    return ["".join(lines[i:i + 9]) for i in range(0, len(lines), 9)]


@pytest.mark.parametrize("sizes,n", [([5] * 8, 4), ([3, 1, 7, 2, 9, 4, 6], 4),
                                     ([2, 2, 2], 4), ([4, 1, 3, 5, 2], 3)])
def test_streamed_shards_match_the_whole_file_helper(tmp_path, sizes, n):
    reads = str(tmp_path / "r.fastq.gz")
    _fastq(reads, sizes, seed=len(sizes) * 10 + n)
    new, old = tmp_path / "new", tmp_path / "old"
    new.mkdir()
    old.mkdir()
    got = chip_smoke._fastq_shards(reads, n, str(new))
    want = _whole_file_shards(reads, n, str(old))
    assert [k for _, k in got] == [k for _, k in want]
    assert [_records(p) for p, _ in got] == [_records(p) for p, _ in want]
    # every pair once, in input order
    assert sum(k for _, k in got) == sum(sizes)
    assert [r for p, _ in got for r in _records(p)] == _records(reads)
    # whole barcode groups: a shard starts where a group starts
    starts, seen = set(), None
    for r in _records(reads):
        bc = r.split("\n")[5]
        if bc != seen:
            starts.add(r)
        seen = bc
    assert all(_records(p)[0] in starts for p, k in got if k)
