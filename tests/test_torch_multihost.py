"""The port's multi-host driver on torch.distributed (gloo), on the CPU: a
4-process run coordinated through a file, held against one run of the port's
CLI and of the JAX package's CLI over all the shards; a rendezvous that one
process reaches long after the other; a failed init; and the shard plan and
single-process path of tests/test_multihost.py, held against the JAX CLI."""

import gzip
import json
import os
import struct
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from lariat_tpu_torch.cli import load_reference
from lariat_tpu_torch.io.bamread import BamFile
from lariat_tpu_torch.parallel import multihost
from lariat_tpu_torch.rfa.pipeline import RFAStats

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMP = bytes.maketrans(b"ACGT", b"TGCA")
QUAL = "I" * 100


def _genome(tmp_path, n, seed):
    rng = np.random.default_rng(seed)
    genome = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].tobytes()
    fasta = tmp_path / "g.fa"
    with open(fasta, "w") as f:
        f.write(">chr1\n")
        s = genome.decode()
        for i in range(0, len(s), 70):
            f.write(s[i:i + 70] + "\n")
    return genome, str(fasta)


def _pair_lines(genome, bc, pos, qname):
    r1 = genome[pos:pos + 100].decode()
    r2 = genome[pos + 200:pos + 300].translate(COMP)[::-1].decode()
    return (f"@{qname} rg\n{r1}\n{QUAL}\n{r2}\n{QUAL}\n"
            f"{bc},{bc.split('-')[0]}\nJJJJJJJJJJJJJJ\nACGTACGT\nIIIIIIII\n")


def _sim_shard_lines(genome, barcodes, first, pairs_per_bc=8):
    """A barcode-complete shard of simulated reads, the truth in the qname
    (fields 5 and 6)."""
    out = []
    for b, bc in enumerate(barcodes):
        for i in range(pairs_per_bc):
            pos = 1500 + ((first + b) * pairs_per_bc + i) * 250
            out.append(_pair_lines(genome, bc, pos,
                                   f"sim:x:x:x:x:{pos}:{pos + 200}"))
    return "".join(out)


def _env():
    return {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1",
            "JAX_PLATFORMS": "cpu"}


def _records(path):
    """A BAM's records past its header, each as its raw bytes."""
    bam = BamFile(str(path))
    data, off, out = bam.data, bam._records_start, []
    while off < len(data):
        n = 4 + struct.unpack_from("<i", data, off)[0]
        out.append(bytes(data[off:off + n]))
        off += n
    return out


def _cli_records(module, reads, fasta, out_dir, tmp_path):
    """``module``'s CLI (the port's or the JAX package's) on the host path
    over ``reads``, as host 0 of chunk 0, merged by the port's cat_bams."""
    r = subprocess.run([sys.executable, "-m", module, "-reads", str(reads),
                        "-genome", fasta, "-output", str(out_dir),
                        "-threads", "2", "-use_device", "off",
                        "-first_chunk", "-simulated"],
                       capture_output=True, text=True, cwd=tmp_path,
                       env=_env(), timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    return _cat_bams(f"{out_dir}.bam", out_dir)


def _result(pr, timeout=300):
    """A multihost process's one result line, once it has exited 0."""
    out, err = pr.communicate(timeout=timeout)
    assert pr.returncode == 0, err[-2000:]
    line = [s for s in out.splitlines() if s.startswith('{"host"')]
    assert len(line) == 1, out[-2000:]
    return json.loads(line[0])


def _cat_bams(out, *dirs):
    r = subprocess.run([sys.executable, "-m",
                        "lariat_tpu_torch.tools.cat_bams", "-o", str(out),
                        "--auto", *map(str, dirs)],
                       capture_output=True, text=True, cwd=REPO,
                       env=_env(), timeout=120)
    assert r.returncode == 0, r.stderr
    return _records(out)


def test_four_processes_through_a_file(tmp_path):
    """Four processes, each aligning its own barcode-complete shard, sum
    their stats with one all_reduce after a file:// rendezvous: every
    process reports the same global stats, the sum of the locals, and
    the merged BAMs hold the records of one process over all four shards,
    the port's CLI's and the JAX package's alike (RFA seeds each read from
    its own name, so the split changes none)."""
    genome, fasta = _genome(tmp_path, 60000, 11)
    bcs = [f"{a}{b}CAGAGAAAGAT-1" for a in "ACGT" for b in "AC"]
    shards, text = [], []
    for h in range(4):
        lines = _sim_shard_lines(genome, bcs[2 * h:2 * h + 2], 2 * h)
        fq = tmp_path / f"shard{h}.fastq.gz"
        with gzip.open(fq, "wt") as f:
            f.write(lines)
        shards.append(str(fq))
        text.append(lines)
    load_reference(fasta)        # one index build, before the processes
    init = f"file://{tmp_path / 'pg_rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "lariat_tpu_torch.parallel.multihost",
         "-coordinator", init, "-num_processes", "4", "-process_id", str(h),
         "-reads", shards[h], "-genome", fasta,
         "-output_base", str(tmp_path / "mh"), "-threads", "2",
         "-use_device", "off", "-init_timeout", "240", "-simulated"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=tmp_path) for h in range(4)]
    try:
        outs = [_result(pr) for pr in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    assert [o["host"] for o in outs] == [0, 1, 2, 3]
    assert all(o["rc"] == 0 for o in outs)
    want = [sum(col) for col in zip(*(o["local_stats"] for o in outs))]
    assert all(o["global_stats"] == want for o in outs)
    assert want[0] == 4 * 2 * 8 * 2          # every mate counted once
    assert all(o["local_stats"][0] == 32 for o in outs)

    # one process over all four shards, barcode order kept
    whole = tmp_path / "all.fastq.gz"
    with gzip.open(whole, "wt") as f:
        f.write("".join(text))
    single = _cli_records("lariat_tpu_torch.cli", whole, fasta,
                          tmp_path / "one", tmp_path)
    jax_one = _cli_records("lariat_tpu.cli", whole, fasta,
                           tmp_path / "jax_one", tmp_path)
    merged = _cat_bams(tmp_path / "merged.bam",
                       *(o["output_dir"] for o in outs))
    assert len(merged) == 4 * 2 * 8 * 2
    assert sorted(merged) == sorted(single)
    assert sorted(merged) == sorted(jax_one)


def test_late_rendezvous_waits_for_the_slowest_shard(tmp_path):
    """A process that ends its shard first waits at the rendezvous for one
    that starts long after it (a shard that runs hours longer, at genome
    scale): with the default -init_timeout both report the summed stats."""
    assert multihost.INIT_TIMEOUT_S >= 24 * 3600
    genome, fasta = _genome(tmp_path, 30000, 5)
    bcs = ["AAACAGAGAAAGAT-1", "CCCAGAGAGAAGAT-1"]
    shards = []
    for h in range(2):
        fq = tmp_path / f"shard{h}.fastq.gz"
        with gzip.open(fq, "wt") as f:
            f.write(_sim_shard_lines(genome, bcs[h:h + 1], h, 6))
        shards.append(str(fq))
    load_reference(fasta)
    rdv = tmp_path / "pg_rendezvous"

    def start(h):
        return subprocess.Popen(
            [sys.executable, "-m", "lariat_tpu_torch.parallel.multihost",
             "-coordinator", f"file://{rdv}", "-num_processes", "2",
             "-process_id", str(h), "-reads", shards[h], "-genome", fasta,
             "-output_base", str(tmp_path / "mh"), "-threads", "1",
             "-use_device", "off", "-simulated"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_env(), cwd=tmp_path)

    procs = [start(0)]
    try:
        t0 = time.time()
        while not rdv.exists():       # process 0 has reached the rendezvous
            assert procs[0].poll() is None, procs[0].communicate()[1][-2000:]
            assert time.time() - t0 < 120
            time.sleep(0.2)
        time.sleep(10)
        procs.append(start(1))
        outs = [_result(pr) for pr in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    want = [a + b for a, b in zip(outs[0]["local_stats"],
                                  outs[1]["local_stats"])]
    assert want[0] == 2 * 6 * 2
    assert [o["global_stats"] for o in outs] == [want, want]


@pytest.mark.parametrize("coordinator", ["tcp://127.0.0.1:1",
                                         "bogus://nowhere"])
def test_failed_init_exits_nonzero_without_a_result(tmp_path, coordinator):
    """A process group that does not come up (nothing listens, or an init
    method torch does not know) fails the process: nonzero exit, no result
    line, where the reference reports its local stats instead."""
    genome, fasta = _genome(tmp_path, 30000, 8)
    fq = tmp_path / "s.fastq.gz"
    with gzip.open(fq, "wt") as f:
        f.write(_sim_shard_lines(genome, ["AAACAGAGAAAGAT-1"], 0, 6))
    r = subprocess.run(
        [sys.executable, "-m", "lariat_tpu_torch.parallel.multihost",
         "-coordinator", coordinator, "-num_processes", "2",
         "-process_id", "1", "-reads", str(fq), "-genome", fasta,
         "-output_base", str(tmp_path / "mh"), "-threads", "1",
         "-use_device", "off", "-init_timeout", "5"],
        capture_output=True, text=True, cwd=tmp_path, env=_env(),
        timeout=180)
    assert r.returncode != 0
    assert not [s for s in r.stdout.splitlines() if s.startswith("{")]
    assert "Lariat completed successfully" in r.stdout   # the CLI ran first


def test_init_method():
    assert multihost.init_method("host0:29500") == "tcp://host0:29500"
    assert multihost.init_method("file:///x/y") == "file:///x/y"
    with pytest.raises(ValueError, match="coordinator"):
        multihost.init_distributed(None, num_processes=2)


def test_plan_and_run_two_shards(tmp_path):
    """tests/test_multihost.py's shard plan and degenerate single-process
    path on the port: two plans, no process group, each shard through the
    CLI's host path, the outputs merged by the port's cat_bams equal to the
    JAX package's CLI over both shards, the stats' sum the local values."""
    genome, fasta = _genome(tmp_path, 30000, 8)
    shard_paths, text = [], []
    for shard in range(2):
        fq = tmp_path / f"shard{shard}.fastq.gz"
        bc = ["AAACAGAGAAAGAT-1", "CCCAGAGAGAAGAT-1"][shard]
        lines = "".join(_pair_lines(genome, bc, 2000 + shard * 9000 + i * 300,
                                    f"s{shard}r{i}") for i in range(6))
        with gzip.open(fq, "wt") as f:
            f.write(lines)
        shard_paths.append(str(fq))
        text.append(lines)
    plans = multihost.plan_host_shards(shard_paths, str(tmp_path / "o"), 2)
    assert len(plans) == 2
    assert plans[0].first_chunk and not plans[1].first_chunk
    assert [p.output_dir for p in plans] == [str(tmp_path / "o/host000"),
                                            str(tmp_path / "o/host001")]
    assert multihost.plan_host_shards(shard_paths, "b", 4)[1].host_id == 1
    assert len(multihost.plan_host_shards(shard_paths, "b", 4)) == 2
    assert multihost.init_distributed(num_processes=1) is False
    for plan in plans:
        rc, _stats = multihost.run_host(plan, fasta, threads=1,
                                        use_device="off")
        assert rc == 0
    merged = _cat_bams(tmp_path / "merged.bam", plans[0].output_dir,
                       plans[1].output_dir)
    assert len(merged) == 24
    whole = tmp_path / "all.fastq.gz"
    with gzip.open(whole, "wt") as f:
        f.write("".join(text))
    r = subprocess.run([sys.executable, "-m", "lariat_tpu.cli",
                        "-reads", str(whole), "-genome", fasta,
                        "-output", str(tmp_path / "jax_one"), "-threads", "1",
                        "-use_device", "off", "-first_chunk"],
                       capture_output=True, text=True, cwd=tmp_path,
                       env=_env(), timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert sorted(merged) == sorted(_cat_bams(tmp_path / "jax_one.bam",
                                              tmp_path / "jax_one"))
    st = RFAStats(total=10, correct=9, total_mapq10=8, correct_mapq10=7)
    assert not torch.distributed.is_initialized()
    assert multihost.global_stats_psum(st) == [10, 9, 8, 7]
