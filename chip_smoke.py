#!/usr/bin/env python3
"""Drive lariat_tpu_torch once on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py            # from the repository root, one GPU
    python3 chip_smoke.py --hg38-data DIR    # phase 18's inputs elsewhere
    python3 chip_smoke.py --chr20-data DIR   # phase 20's inputs elsewhere

(--hg38-data DIR also holds phase 21's inputs; phase 22 reads both, on a
host with four cards.)

Phases (one line each with its seconds, failures end the run nonzero):
  1. environment: the card (nvidia-smi name, power limit), torch, nvcc;
     requires torch.cuda.is_available();
  2. build: every kernel from lariat_tpu_torch/csrc with nvcc (sm_90a),
     ptxas's registers and spills, and each kernel's instructions, with
     its DPX, PRMT and POPC instructions, as `cuobjdump -sass` finds them;
  3. kernels: each kernel's wrapper on the card at main-path shapes against
     its plain PyTorch version on the same inputs, exact (tolerance 0:
     integer DP), with kernel and plain times (CUDA events, median of 7;
     the plain K1-K3 median of 3, T1's of 1) and the kernel's bound (the
     larger of its operations over the int32 peak and its bytes over the
     memory peak, both from the card's attributes;
     tools/kernel_roofline.py):
     K1-K3 (K1's rows run, warp steps and band cells printed), K2b on
     K2's z and on random z (walk steps and windows staged printed), K1,
     K3 and K2 (with K2b on its z) again on their edge shapes (the tiled path
     past 256 or 192 query columns, qlen 0, tlen 0, tlen < 32, qlen not a
     multiple of C, N codes, minsc 0; w 0, w >= qlen, rows past qlen + w;
     K1 also at zdrop 5, 0 and -1, z-drops at rows 0-3, h0 <= o_ins +
     e_ins), and T1 in all six variants at 8192 x 192 x 576 on planted
     inputs and on the ablation tool's random ones, and at 4096 x 300 x
     576 (two column tiles) on both kinds, each variant's ms and ns a warp
     step (ms x SMs / the kernel's step count) beside K1's tile entry on
     the same planted tasks;
  4. data: a chr20-scale synthetic genome (tools/synth_genome.py --scale
     0.0208 --seed 7, ~64 Mbp), 10,000 read pairs of 151 bp
     (tools/sim_reads.py) and the index, under build/smoke/ (reused);
  5. seeding kernels: K4a-K4c and K5 on that index (fused occ table about
     1.0 M rows x 48 B) and 4,096 reads of the FASTQ against their twins,
     exact, with kernel and plain times (CUDA events, median of 7; the
     twins' median of 3, one timing of the K4a, K4b and planes twins, each
     a second or more): K4a at round 1's phase-A budget, at phase B's
     budget and at round 2, each in int32 and int64 indices, with its
     lanes' transition counts; K4b over every (read, e) lane in int32 and
     int64, with its extensions and rows fetched beside the distinct rows;
     K4c in int32 and int64; K5 as the SA lookup runs it (one launch of 512 steps over
     65,536 rows, int32 and int64) with its longest walk, beside its
     phase-1 shape (64 steps) and the whole lookup (sa_lookup_batch_host);
     K1's descriptor entry on a wave of 8,192 extensions of
     reads from that genome, against build_qt plus the twin; then the
     device collect (collect_seeds_rbegs_device) on 250 reads of the
     FASTQ and six low-complexity ones, which blow K4a's step cap, so it
     runs K4b: seeds and rbegs equal to the native C++ seeder's, with no
     SA sample uploaded; one warm collect of the 4,096 reads with the
     seeding trace on (smem_device.SEED_TRACE, LARIAT_SEED_TRACE's
     [seedtrace] lines), equal to the native seeder's, its ms summed by
     tag beside the call's wall; then, off every path, K4a's planes entry (round 1
     at an 8L budget, round 2 with bwd_init at 32L, int32 and int64) and K9
     on its planes (both layouts, round 1's mid L + 2 and round 2's mids,
     the collect's caps, caps that overflow and then L, whose flags must
     read 0) against their twins, exact, timed with their byte bounds (K9
     with its wrapper in both layouts and int64, in device time as a spun
     single call and as the mean of 200 back-to-back calls from a CUDA
     graph, with what one call enqueues -- K9 and at most one memset -- by
     torch.profiler; its twin, the stable argsort and gathers, is also its
     library yardstick: one timing under both names), one packed call
     captured in a CUDA graph and replayed, K9's round-1 slots against
     K4a's direct slots, and the launches of one planes-then-compaction
     pass;
 5b. align step on that index: K7 (the exact match on the reads as they
     are, the seed mask in the kernel; both N rules, int32 and int64, on
     reads with N, lens 0, under the seed length, L and past L + 31; its
     occ1 entry on rows around primary), K8 (the window fetch: negative
     starts, starts near and past l_pac, every in-word offset), K1's step
     entry (reverse hits, windows across 0 and l_pac, unmapped lanes, N)
     and K5's lookup entry (the samples added on the card) against their
     twins and the lookup against sa_lookup_batch_host, each timed at the
     step's shapes with its bound (K7 and the step entry also in device
     time alone; K7 with its longest chain and device us a step; the step
     entry beside K8 + orientation + the tile entry, the path it
     replaces); K7, K8 and the step entry again at positions and
     rows on both sides of 2^31 (int64; a rank table and a pac of 2.4e9
     bases made on the card, the text's halves complementary), and there
     too K4a's slots and planes entries (rounds 1 and 2), K9 on those
     planes, K4b, K4c, K5's walk and K1's descriptor entry, each kernel's
     fused rows (K9: kept x0, K1: target positions) below and above 2^31
     printed, both sides required; then align_step and align_step_smem at
     8,192 x 151 (launches counted over that run: every extension through
     the step entry, no K8 launch), every field equal to the same steps on
     the twins on the card (int32 and int64); then tools/device_step.py to
     a complete JSON line;
  6. host-native: the port's own host path (lariat_tpu_torch.cli
     -use_device off -threads 8), a subprocess;
  7. the port (-use_device on -threads 8), a subprocess whose CLI resets
     the kernel launch counts before its main loop and prints them after,
     with the router's knobs set so that it has no reason to host-route
     (LARIAT_PRIME_THREADS at the run's most batches, a 600 s
     LARIAT_PRIME_TAIL_GRACE, LARIAT_PRIME_MIN_FRAC=0; printed);
  8. the port again with LARIAT_DEVICE_SEED=1 and the same knobs: seeding
     and its SA walks on the device (K4a, K4c, K5), each K5 launch logged
     (rows, max_steps, longest walk, walks past 64 steps), one launch a
     lookup;
 8b. the port at the router's defaults: its primed / host-routed split;
 8c. the port through the resident server (parallel/device_server.py) on
     the card: the server starts as a subprocess and writes its ready file
     after its build, upload and prewarm; the CLI primes through it
     (LARIAT_DEVICE_SOCKET) and must not initialise CUDA; the server stops
     on request, exits 0 and logs its kernel launches;
  9. tools: two measurement entry points as subprocesses -- the T1
     ablation at full size and the priming profile over 2,000 pairs of the
     data above, once with host and once with device seeding -- each to a
     complete final JSON line (the kernel roofline runs in the bench);
 10. checks: BAM records of the four port runs identical to host-native
     file for file; every pair primed in runs 7 and 8, primed plus
     host-routed pairs all the pairs and some primed in 8b and 8c; K1-K3
     and K2b launched in the server; every kernel launched on
     its own path (K1-K3 in the port run, K4a, K4c and K5 in the
     device-seeded run, K4b -- which runs only when K4a blows its step cap
     -- in phase 5's collect, T1 in the ablation tool, K7 in the align
     steps of phase 5b; K8, which no path launches since the steps stage
     their windows in K1's step entry, is only held against its twin; the
     planes entry and K9, off every path in the reference too, in phase
     5's pass);
 11. whole BAM: every BAM of the four port runs against host-native's as a
     whole file (lariat_tpu_torch/io/bamcompare.py): the decompressed
     streams equal with only the @PG CL field set to one value, every BGZF
     block past the header that covers the same stream range equal byte
     for byte, the EOF block; blocks and bytes compared printed per file;
 12. bench: python -m lariat_tpu_torch.tools.bench (the 4.6 Mb genome,
     320 x 100 pairs, 5 workers, host-native and device-primed through
     the resident server, a warm-up and the median of 3 each; the RFA row
     probe, the record diff rate, the roofline and the device step), its
     JSON line printed and held: both rates, primed pairs in the device
     median, a diff rate of 0, the torch rows in the probe, the device
     step present, the roofline's sections with every share of a peak in
     (0, 100%] and K6's bound (fm_rank), hg38 said skipped without
     data_big/, K1 (every launch through its descriptor entry), K2 and
     K2b launched in its server (K3's count printed: no rescue window
     survives on its proper pairs), K4b, K5 and K1 in its device step;
 13. probe and entry: python -m lariat_tpu_torch.tools.probe_device (launch
     latency, 8 MB transfers pageable and pinned, K1 at B 128 and 1,024,
     its twin at 1,024 and 8,192), its lines printed; then tools/entry.py's
     align_step_smem on the card (64 x 100, a 20 kb index), its launches
     counted (K4b, K5's lookup entry, K1's step entry), every field equal
     to the same step on the CPU.
 14. dryrun multichip: tools/entry.py's dryrun_multichip(4) -- the priming
     path over a 1.2 Mb toy genome and 64 barcodes x 32 pairs, once on one
     device and once with every wave split over four (four distinct cards
     when there are four, else cuda:0 four times) -- the packed records
     bit-identical, at least 16 split waves, no device with more than
     twice another's real tasks; the cards used, each device's real tasks
     and the launches of K1, K2, K2b and K3 in each run (counted from 0
     just before it) printed, K1, K2 and K2b required in the split run;
 15. multihost: phase 4's reads cut into 4 barcode-complete shards, 4
     `python -m lariat_tpu_torch.parallel.multihost` processes on the card
     (file:// rendezvous, -use_device on, -simulated, -threads 2 each, the
     all-primed router knobs, LARIAT_WAVE_TRACE=1): every process primes
     all its pairs, the global stats agree across processes and equal the
     sum of the locals (every read counted), the [wtrace] lines number
     the CLI's waves, and the merged position-bucketed records (the
     port's cat_bams --auto) equal host-native's as a sorted list, the
     barcode-sorted ones in order; each process's pairs/s and kernel
     launches and the [wtrace] lines' build, dispatch and download ms
     summed by site (with the longest line) printed.
 16. port run, Python replay: the port's CLI with LARIAT_NO_NATIVE_ALIGN1=1
     (the Python replay of chain2aln and the Python reg2aln ladder, no
     native session) on a smaller read set -- 2,000 pairs, 40 barcodes x
     50 from tools/sim_reads.py on phase 4's genome, cut from 10,000
     because the replay runs in the priming threads' interpreter -- with
     the all-primed knobs, after a host-native run on the same reads:
     every pair primed, BAM records (and whole files, CL normalised) equal
     host-native's, K1 launched through its tile entry only, K2 and K2b
     launched; its pairs/s beside host-native's;
 17. auto seeding, background upload: in this process, LARIAT_DEVICE_SEED
     unset, an engine on the card with DEVICE_SEED_AUTO_MIN_LPAC at 0 on
     the instance primes batches of phase 16's reads one after another
     until one seeds on the device (K4a launched), every batch's regions
     equal to a host-seeded engine's. The batches before it are
     host-seeded by construction (auto mode's first seeding call starts
     the upload and returns None); the phase prints the upload's seconds,
     each batch's seconds and how many batches finished while the upload
     was in flight.
 18. hg38 scale, on data_big/'s hg38sim.fa, its .lariat.d, sim10k.fastq.gz
     (200 barcodes x 50 pairs) and hg38sim.centromeres.tsv, which
     `python -m lariat_tpu_torch.tools.gen_data_big` builds (for about an
     hour; never this script; --hg38-data points elsewhere): without them
     one line says the phase was not run and why. Else the index loaded
     as the CLI loads it (its seconds), the seeding index on the card in
     int64 (asserted), the device collect on 4,096 reads equal to the
     native C++ seeder's, K4a (round 1), K4c and K5 (65,536 lookup rows)
     against their twins and timed beside phase 5's figures, K5's longest
     walk, K1's descriptor entry on an int64 wave; host-native with
     -centromeres, then the port with every pair primed, with auto
     seeding (LARIAT_DEVICE_SEED unset) and with LARIAT_DEVICE_SEED=1:
     all 10,000 pairs primed, none host-routed, K1 (every launch through
     its descriptor entry), K2 and K2b launched, K3 wherever a mate was
     rescued, K4a, K4c and K5 launched exactly when a batch seeded on the
     device (every batch when forced), records and whole files equal to
     host-native's; each run's index load s, the upload's s, the batches
     each seeder served and the host-seeded ones before the first
     device-seeded one, pairs/s and the busy fraction printed.
 19. messy reads: a FASTQ of 400 barcodes x 24 pairs of the soak test's
     reads (lariat_tpu_torch/tools/messy_reads.py: indels, N runs,
     chimeras, homopolymers, junk, mates of 1-24 bases) drawn from phase
     4's genome; host-native, then the port all primed with host seeding
     and with LARIAT_DEVICE_SEED=1: every pair primed, records and whole
     files equal to host-native's, K1, K2 and K2b launched (K3 when a mate
     was rescued, K4a, K4c and K5 when seeded on the device), each kernel
     that ran printed with its launches and its largest launch (tasks,
     lanes, reads or rows: the path log's ``largest_launches``).
 20. chr20 x 1M pairs, the reference's chr20_1m run, on data_big/'s
     chr20sim.fa, its .lariat.d and sim1m_chr20.fastq.gz (10,000 barcodes
     x 100 pairs), which `python -m lariat_tpu_torch.tools.gen_data_big
     DIR --chr20` builds (never this script; --chr20-data points
     elsewhere): without them one line says the phase was not run. Else
     five CLI runs of 8 workers with -simulated: host-native, the router
     at its defaults, the router without dormancy (LARIAT_PRIME_MIN_FRAC=0,
     its batches growing toward the 16,384-pair cap) with host and with
     device seeding, and through the resident server; each run's pairs/s,
     primed and host-routed pairs, dormancy (when, and the pairs primed by
     then), largest primed batch, kernels' launches and largest launches,
     the card's peak allocated memory in the priming process, the CLI's
     peak RSS (the largest ru_maxrss among its processes, read by a
     wrapper process), wall and simulated accuracy; 1,000,000 pairs a run,
     records and whole files equal to host-native's, the no-dormancy runs
     primed, the host-seeded one a batch of 4,096 pairs or more, K4a, K4c
     and K5 launched in the device-seeded one.
 21. hg38 x 200k, the CLI's device modes, on --hg38-data's hg38sim.fa, its
     .lariat.d, centromeres and sim200k.fastq.gz (4,000 barcodes x 50
     pairs, the reference bench's hg38_device_8w input), which `python -m
     lariat_tpu_torch.tools.gen_data_big DIR --hg38` builds (never this
     script): without them one line says the phase was not run. Else five
     CLI runs of 8 workers with -centromeres, -simulated and auto seeding
     (LARIAT_DEVICE_SEED unset): host-native, the router at its defaults
     (-use_device auto, in-process engine), the router without dormancy,
     through the resident server at its defaults (the bench's
     hg38_device_8w) and without dormancy; each run's phase 20 figures,
     plus the batches each seeder served, the host-seeded ones before the
     first device-seeded one, the upload's s, K4b's launches, and for the
     server runs its ready time split into imports, load, upload and
     prewarm and its peak RSS; 200,000 pairs a run, primed plus
     host-routed all of them, records and whole files equal to
     host-native's, the no-dormancy run seeding batches on the device
     (K4a, K4c and K5 launched), no batch host-seeded in the server, the
     server's no-dormancy run priming pairs with K1 (every launch through
     its descriptor entry), K2, K2b, K4a, K4c and K5 launched, and K3
     wherever a mate was rescued. Phase 18's
     device collect also takes phase 5's low-complexity reads on the hg38
     index, so K4b runs on a real index past 2^31 (seeds equal to native,
     K4b exact against its twin on the collect's lanes).
 22. four cards, one multihost process a card: only on a host with four
     cards and with phase 20's or phase 21's inputs (else one line says
     which is missing). Each input is cut into four barcode-complete
     shards of whole barcodes in input order (250,000 pairs each at chr20,
     50,000 at hg38); with C the host's CPUs and W = min(8, C // 4): a.
     one host-native process of 4W workers over the whole input; b. four
     `python -m lariat_tpu_torch.parallel.multihost` processes of W
     workers (file:// rendezvous), -use_device off; c. the same on the
     cards, process h with LARIAT_TORCH_DEVICE=cuda:h and the router
     without dormancy (LARIAT_PRIME_MIN_FRAC=0); d. each through its own
     resident server on cuda:h and its own socket, the router at its
     defaults; -simulated (and -centromeres at hg38), auto seeding. Each
     process's pairs/s and wall, primed and host-routed pairs, batches
     each seeder served, card peak, peak RSS and -simulated line, each
     mode's aggregate pairs/s (all pairs over the first start to the last
     exit) and the host's MemAvailable before it printed; nvidia-smi's
     compute apps sampled every 2 s. Checks, every mode run first: each
     process exits 0 with its JSON line, the global stats equal in the
     four, to their locals' sum and to a's; b's merge (cat_bams --auto)
     holds a's records; each process's directory in c and d equals its
     directory in b as records and as whole files; each card carries
     exactly its process (the server in d, where no CLI holds a context),
     none on two cards, by the path log's device and CUDA contexts and by
     nvidia-smi (a host whose nvidia-smi lists no app of the run is said
     so); K1, K2 and K2b launched on every card (K3 where a mate
     was rescued; K4a, K4c and K5 in d at hg38) with a nonzero card peak.
     A failed process gets the others' process groups killed.
Then each kernel's loss on its path (launches x (ms - bound ms)), a
kernels JSON line (each kernel's launches on its path, max abs
error, ms, plain ms, bound ms and what sets it, and library_ms: null where
no single PyTorch call computes the function -- these recurrences -- and
for K9 the stable argsort and gathers; K4a, K4c, K5 and K1 with an "hg38"
entry, phase 18's launches and ms or null, K4b's its collect's launches;
every kernel with "messy", "chr20_1m" and "hg38_200k" entries,
[launches, largest launch] in each run of phases 19, 20 and 21 (b-e), or
null, and a "four_cards" entry, phase 22's launches in c and d a card, or
null) and, last,
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import glob
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SMOKE = os.path.join(REPO, "build", "smoke")
# chr20-scale genome of tools/gen_data_big.py; 10,000 pairs; 8 workers
SCALE, BARCODES, PAIRS_PER_BC, THREADS = 0.0208, 200, 50, 8

KERNEL_INFO = {   # name -> (source, the TPU kernel it replaces)
    "sw_extend": ("lariat_tpu_torch/csrc/sw_extend.cu",
                  "lariat_tpu/ops/sw_extend_pallas.py:50"),
    "sw_global": ("lariat_tpu_torch/csrc/sw_global.cu",
                  "lariat_tpu/ops/sw_global_pallas.py:40"),
    "traceback": ("lariat_tpu_torch/csrc/traceback.cu",
                  "lariat_tpu/ops/sw_global_pallas.py:295"),
    "sw_local": ("lariat_tpu_torch/csrc/sw_local.cu",
                 "lariat_tpu/ops/sw_local_pallas.py:49"),
    "extend_ablate": ("lariat_tpu_torch/csrc/extend_ablate.cu",
                      "tools/extend_ablate.py:49"),
    "smem_twoptr": ("lariat_tpu_torch/csrc/smem.cu",
                    "lariat_tpu/ops/smem_device.py:117"),
    "smem_exhaustive": ("lariat_tpu_torch/csrc/smem.cu",
                        "lariat_tpu/ops/smem_device.py:62"),
    "smem_strategy1": ("lariat_tpu_torch/csrc/smem.cu",
                       "lariat_tpu/ops/smem_device.py:465"),
    "sa_walk": ("lariat_tpu_torch/csrc/sa_walk.cu",
                "lariat_tpu/parallel/align_step.py:86"),
    "exact_match": ("lariat_tpu_torch/csrc/exact_match.cu",
                    "lariat_tpu/ops/fm_batch.py:366"),
    "fetch_window": ("lariat_tpu_torch/csrc/fetch_window.cu",
                     "lariat_tpu/parallel/align_step.py:156"),
    "smem_planes": ("lariat_tpu_torch/csrc/smem.cu",
                    "lariat_tpu/ops/smem_device.py:387"),
    "compact": ("lariat_tpu_torch/csrc/compact.cu",
                "lariat_tpu/ops/smem_device.py:391"),
}
CLI_KERNELS = ("sw_extend", "sw_global", "traceback", "sw_local")
SEED_KERNELS = ("smem_twoptr", "smem_strategy1", "sa_walk")
STEP_KERNELS = ("exact_match", "fetch_window")
# kernels that no path launches: K8 stays the port of the reference's
# fetch_window_batch, held against its twin in phase 5b, while the align
# steps stage their windows in K1's step entry (phase 5b checks 0 launches);
# K4a's planes entry and K9 are off every path in the reference too, and
# their launches are those of phase 5's planes-then-compaction pass
OFF_PATH = ("fetch_window", "smem_planes", "compact")
# the device align step's batch (bench.py's device step detail)
STEP_B, STEP_L = 8192, 151
PROFILE_PAIRS = 2000
# phases 16-17: 40 barcodes x PAIRS_PER_BC = 2,000 pairs
REPLAY_BARCODES = 40
# phase 17: reads a batch, and the most seconds it waits for the upload
AUTO_BATCH, AUTO_WAIT_S = 512, 120
SEED_READS = 4096
FALLBACK_READS = 250
# phase 18: data_big/'s hg38-scale inputs (tools/gen_data_big.py's names)
HG38_DIR = os.path.join(REPO, "data_big")
HG38_INPUTS = ("hg38sim.fa", "hg38sim.fa.lariat.d", "sim10k.fastq.gz",
               "hg38sim.centromeres.tsv")
HG38_PAIRS = 10_000     # sim10k: 200 barcodes x 50 pairs
# the messy-read phase: the soak test's pairs (lariat_tpu_torch/tools/
# messy_reads.py) on phase 4's genome
MESSY_BARCODES, MESSY_PAIRS = 400, 24
# the chr20 x 1M phase: the reference's chr20_1m run on what
# `python -m lariat_tpu_torch.tools.gen_data_big DIR --chr20` builds
CHR20_INPUTS = ("chr20sim.fa", "chr20sim.fa.lariat.d", "sim1m_chr20.fastq.gz")
CHR20_PAIRS = 1_000_000     # 10,000 barcodes x 100 pairs
CHR20_TIMEOUT = 3000        # s a CLI run may take
# run c's largest primed batch must reach this: 2 s of priming at 2,048
# pairs/s, under half of one thread's slowest measured rate
CHR20_MIN_BATCH = 4096
# phase 21: the hg38 genome and its 200k read set (4,000 barcodes x 50
# pairs), what `python -m lariat_tpu_torch.tools.gen_data_big DIR --hg38`
# builds; the reference bench's hg38_device_8w input
HG38_200K_INPUTS = ("hg38sim.fa", "hg38sim.fa.lariat.d",
                    "hg38sim.centromeres.tsv", "sim200k.fastq.gz")
HG38_200K_PAIRS = 200_000
HG38_200K_TIMEOUT = 1800    # s a CLI run may take
HG38_READY_S = 900          # s the server may take to load, upload, prewarm
# phase 22: one multihost process a card on a host with four cards, over
# four barcode-complete shards of phase 20's and phase 21's reads
FOUR = 4
FOUR_SHARD_PAIRS = {"chr20_1m": 250_000, "hg38_200k": 50_000}
FOUR_TIMEOUT = 1800         # s a mode's processes may take
CARD = "cuda:{}"            # process h's LARIAT_TORCH_DEVICE
SMI_EVERY_S = 2.0           # s between two samples of nvidia-smi's apps
# reads whose two-pointer lanes outrun K4a's step cap on a genome of this
# size (no exact copy of them in the synthetic genome)
LOW_COMPLEXITY = [b"A" * 151, b"AT" * 75, b"ACG" * 50, b"AC" * 75,
                  b"AAT" * 50, b"C" * 151]


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.time()
        print(f"[phase] {self.name} ...", flush=True)
        return self

    def __exit__(self, exc_type, exc, tb):
        status = "ok" if exc_type is None else "FAILED"
        print(f"[phase] {self.name}: {status} in "
              f"{time.time() - self.t0:.2f}s", flush=True)
        return False


# runs a command, then writes the largest peak RSS among the processes it
# waited for (ru_maxrss of RUSAGE_CHILDREN, KiB) on stderr's last line;
# a small process of its own, since a child's ru_maxrss counts the RSS of
# the process that forked it up to its exec
_PEAK_WRAP = ("import resource, subprocess, sys; "
              "rc = subprocess.run(sys.argv[1:]).returncode; "
              "print('\\npeak rss KiB', resource.getrusage("
              "resource.RUSAGE_CHILDREN).ru_maxrss, file=sys.stderr); "
              "sys.exit(rc)")


def _run(cmd, timeout, log=None, env=None, peak=None):
    """Run ``cmd`` from the repository root; its stdout. ``peak``, a dict,
    gets ``rss_gib``: the largest peak RSS among the command's processes
    (its workers too), through ``_PEAK_WRAP``."""
    wrap = [sys.executable, "-c", _PEAK_WRAP] if peak is not None else []
    proc = subprocess.Popen([*wrap, *cmd], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=REPO,
                            env=env, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)        # the command and all it started
        proc.communicate()
        raise
    if peak is not None:
        stderr, _, last = stderr.rstrip("\n").rpartition("\n")
        peak["rss_gib"] = int(last.split()[-1]) / 2**20
    if log:
        with open(log, "w") as f:
            f.write(f"$ {' '.join(cmd)}\n{stdout}\n--- stderr ---\n"
                    f"{stderr}")
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd[:4])} ... failed "
                           f"({proc.returncode}):\n{stderr[-3000:]}")
    return stdout


def _meminfo_gib(key: str) -> float:
    """A /proc/meminfo field (MemTotal, MemAvailable ...) in GiB."""
    with open("/proc/meminfo") as f:
        mem = dict(line.split(":", 1) for line in f)
    return int(mem[key].split()[0]) / 2**20


def phase_environment():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no card listed")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()} python {sys.version.split()[0]}")
    from lariat_tpu_torch.ops import _build
    nv = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                        text=True, check=True, timeout=60).stdout
    print(nv.strip().splitlines()[-1])
    print(f"host RAM: {_meminfo_gib('MemTotal'):.1f} GiB total, "
          f"{_meminfo_gib('MemAvailable'):.1f} GiB available; "
          f"{os.cpu_count()} CPUs")
    return smi


def phase_build():
    from lariat_tpu_torch.ops import _build
    out = _build.build(ptxas_report=True)
    for line in out.splitlines():
        if "Used" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    _build.load()
    print(f"  library {os.path.relpath(_build.library_path(), REPO)}")
    _sass_report(_build.library_path(), os.path.dirname(_build._nvcc()))


def _sass_report(lib, bin_dir):
    """Count, per kernel of the library, its sm_90a SASS instructions and
    among them the DPX (VI*), PRMT and POPC instructions."""
    tool = os.path.join(bin_dir, "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if tool is None:
        print("  sass: cuobjdump not found")
        return
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=120).stdout
    fn, counts = None, {}
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                     line)
        if fn and m:
            c = counts.setdefault(fn, {"total": 0})
            c["total"] += 1
            op = m.group(1)
            if op.startswith("VI") or op in ("PRMT", "POPC"):
                c[op] = c.get(op, 0) + 1
    for fn, c in counts.items():
        print(f"  sass {fn}: {json.dumps(dict(sorted(c.items())))}")


def _peaks():
    """int32 ops/s and bytes/s of the card, from its attributes."""
    from lariat_tpu_torch.ops import _build
    from lariat_tpu_torch.tools.kernel_roofline import peaks
    return peaks(_build.device_attributes(0))


def _bound(pk, ops, nbytes):
    """(ms, what sets it): the larger of ops over the int32 peak and bytes
    over the memory peak."""
    t_ops = ops / pk["int32_ops_s"] * 1e3
    t_bytes = nbytes / pk["mem_B_s"] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _band_cells(qlen, rows, w) -> int:
    from lariat_tpu_torch.tools.kernel_roofline import band_cells_batch
    return band_cells_batch(qlen, rows, w)


def _k1_steps(run, want, B) -> int:
    """The warp steps K1 ran over a batch, summed over its tasks: ``run``
    is a K1 entry given a (B,) int32 ``steps`` output, which the kernel
    fills; its result must equal ``want``."""
    import torch
    st = torch.full((B,), -1, dtype=torch.int32, device="cuda")
    got = run(st)
    torch.cuda.synchronize()
    if _max_abs_err(got, want) or int(st.min()) < 0:
        raise AssertionError("K1 with its step count differs or left a "
                             "task uncounted")
    return int(st.long().sum())


def _nbytes(*tensors) -> int:
    from lariat_tpu_torch.tools.kernel_roofline import nbytes
    return nbytes(*tensors)


def _median_ms(fn, n=7):
    import torch
    from lariat_tpu_torch.tools import median_ms
    return median_ms(fn, torch.device("cuda", torch.cuda.current_device()),
                     n)


def _max_abs_err(got, want) -> int:
    if tuple(got.shape) != tuple(want.shape):
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    return int((got.to("cpu").long() - want.to("cpu").long()).abs().max())


def phase_kernels(pk, seed=1):
    """K1-K3 and K2b at main-path shapes, K2/K2b/K3 on their edge shapes,
    and T1; returns name -> (max abs err, kernel ms, plain ms, shape,
    bound ms, what sets the bound)."""
    import numpy as np
    import torch
    from lariat_tpu_torch.ops import sw_batch, sw_extend, sw_global, sw_local
    from lariat_tpu_torch.tools.kernel_roofline import OPS_PER_CELL as OPS
    from lariat_tpu_torch.tools.kernel_turns import (k1_inputs, k2_inputs,
                                                     planted)
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    D = dict(o_del=6, e_del=1, o_ins=6, e_ins=1)
    S3 = dict(match_sc=1, mismatch_sc=-4, n_sc=-1)
    res = {}

    def cuda(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]

    # K1 at the production extend tier 8192 x 192 x 576
    q, qlen, t, tlen, w, h0 = k1_inputs(rng)
    B, Lq, Lt = q.shape[0], q.shape[1], t.shape[1]
    qd, qld, td, tld, wd, h0d = cuda(q, qlen, t, tlen, w, h0)
    mat = sw_extend.score_matrix(1, -4, -1, dev)
    ext = dict(D, end_bonus=5, zdrop=100)

    def k1():
        return sw_extend.extend_batch(qd, qld, td, tld, wd, h0d, **ext, **S3)

    def p1():
        return sw_batch.extend_batch(qd, qld, td, tld, mat, wd, h0d,
                                     packed=True, **ext)

    got, want = k1(), p1()
    torch.cuda.synchronize()
    err = _max_abs_err(got[:6], want)
    if err or int(got[6:].abs().max()):
        raise AssertionError(f"K1 sw_extend differs from its plain version "
                             f"(max abs err {err})")
    # operations: the band cells of the rows each task ran (the twin's
    # count, its stopping row included), at the band ksw_extend2 narrows w
    # to
    _, rows = sw_batch.extend_batch(qd, qld, td, tld, mat, wd, h0d,
                                    packed=True, rows_run=True, **ext)
    rows = rows.cpu().numpy()
    w_eff = sw_batch._adjust_w(torch.from_numpy(qlen), torch.from_numpy(w),
                               1, 5, 6, 1, 6, 1).numpy()
    cells = _band_cells(qlen, rows, w_eff)
    steps = _k1_steps(lambda st: sw_extend.extend_batch(
        qd, qld, td, tld, wd, h0d, **ext, **S3, steps=st), got, B)
    print(f"  K1 schedule: {int(rows.sum())} rows run (the twin's), "
          f"{steps} warp steps (the kernel's count), {cells} band cells")
    res["sw_extend"] = (err, _median_ms(k1), _median_ms(p1, n=3), (B, Lq, Lt),
                        *_bound(pk, OPS["extend"] * cells,
                                _nbytes(qd, qld, td, tld, wd, h0d, got)),
                        {"rows_run": int(rows.sum()), "warp_steps": steps,
                         "band_cells": cells})

    # K2 + K2b at the reg2aln chunk 2048 x 192 x 384
    B, Lq, Lt = 2048, 192, 384
    q, qlen, t, tlen, w = k2_inputs(rng, B, Lq, Lt)
    qd, qld, td, tld, wd = cuda(q, qlen, t, tlen, w)
    S = Lq + Lt

    def k2():
        return sw_global.global_batch(qd, qld, td, tld, wd, **D, **S3)

    def p2():
        return sw_global.global_batch_plain(qd, qld, td, tld, wd, **D, **S3)

    (gs, gz), (ws, wz) = k2(), p2()
    torch.cuda.synchronize()
    err = max(_max_abs_err(gs, ws), _max_abs_err(gz, wz))
    if err:
        raise AssertionError(f"K2 sw_global differs (max abs err {err})")
    ops = OPS["global"] * _band_cells(qlen, tlen, w)
    res["sw_global"] = (err, _median_ms(k2), _median_ms(p2, n=3), (B, Lq, Lt),
                        *_bound(pk, ops, _nbytes(qd, qld, td, tld, wd, gs,
                                                 gz)))
    res["traceback"] = _k2b(gz, qld, tld, wd, gs, S, pk)
    # K3: 4096 rescue DPs, read 151 (Lq 192) in the pestat window
    # high - low + 151 = 686 (Lt 704)
    B, Lq, Lt = 4096, 192, 704
    qlen = np.full(B, 151, np.int32)
    tlen = np.full(B, 686, np.int32)
    q, t = planted(rng, qlen, tlen, Lq, Lt)
    minsc = np.full(B, 19, np.int32)
    qd, qld, td, tld, md = cuda(q, qlen, t, tlen, minsc)

    def k3():
        return sw_local.local_batch(qd, qld, td, tld, md, **D, **S3)

    def p3():
        return sw_local.local_batch_plain(qd, qld, td, tld, md, **D, **S3)

    got, want = k3(), p3()
    torch.cuda.synchronize()
    err = _max_abs_err(got, want)
    if err:
        raise AssertionError(f"K3 sw_local differs (max abs err {err})")
    ops = OPS["local"] * int((qlen.astype(np.int64) * tlen).sum())
    res["sw_local"] = (err, _median_ms(k3), _median_ms(p3, n=3), (B, Lq, Lt),
                       *_bound(pk, ops, _nbytes(qd, qld, td, tld, md, got)))
    for name, (e, ms, pms, shape, bms, by, *_) in res.items():
        print(f"  {name} {shape}: exact (max abs err {e}); kernel "
              f"{ms:.3f} ms, plain {pms:.3f} ms; bound {bms:.4f} ms "
              f"({by}), {100 * bms / ms:.1f}% of it")
    _k1_edges(cuda)
    _edges(cuda, D, S3)
    res["extend_ablate"] = _t1_vs_plain(rng, cuda, pk)
    return res


def _k2b(gz, qld, tld, wd, gs, S, pk):
    """K2b on K2's z of the reg2aln chunk, timed with its bound, and on
    random z bytes of the same shape (every walk a random path), each
    against its twin, exact, with the windows of z its warps staged (the
    kernel's own count) beside the walk steps."""
    import numpy as np
    import torch
    from lariat_tpu_torch.ops import sw_global
    B = gz.shape[0]
    out = {}
    zr = torch.from_numpy(np.random.default_rng(29).integers(
        0, 256, tuple(gz.shape), dtype=np.uint8)).to(gz.device)
    for name, z in (("k2_z", gz), ("random_z", zr)):
        wnd = torch.full((B,), -1, dtype=torch.int32, device=gz.device)
        got = sw_global.traceback_ops_fused(z, qld, tld, wd, gs, S,
                                            windows=wnd)
        want = sw_global.traceback_ops_fused_plain(z, qld, tld, wd, gs, S)
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        if err or int(wnd.min()) < 0:
            raise AssertionError(f"K2b traceback differs on {name} (max abs "
                                 f"err {err}) or left a task uncounted")
        ops_b = got[:, :S // 4].cpu().numpy()
        steps = sum((((ops_b >> (2 * k)) & 3) != 3).sum(1)
                    for k in range(4))
        wn = wnd.cpu().numpy()
        out[name] = {"walk_steps": int(steps.sum()),
                     "walk_steps_max": int(steps.max()),
                     "windows_sum": int(wn.sum()),
                     "windows_max": int(wn.max()),
                     "windows_mean": float(wn.mean())}
        if name == "k2_z":
            # bytes: one 32-byte sector of z a walk step, the lengths in,
            # the blob out
            bms, by = _bound(pk, 0, 32 * int(steps.sum())
                             + _nbytes(qld, tld, wd, gs, got))

            def k2b():
                return sw_global.traceback_ops_fused(gz, qld, tld, wd, gs, S)

            def p2b():
                return sw_global.traceback_ops_fused_plain(gz, qld, tld, wd,
                                                           gs, S)
            ms, pms = _median_ms(k2b), _median_ms(p2b)
    print(f"  K2b ({B}, S {S}): exact on K2's z and on random z; "
          f"{json.dumps(out)}")
    return (0, ms, pms, (B, S), bms, by, out)


def _k1_edges(cuda):
    """K1 on its edge shapes against its twin (on the card), exact, at
    zdrop 100, 5, 0 and -1: qlen 0, tlen 0, tlen < 32, qlen not a multiple
    of C, w 0, w >= qlen, rows past qlen + w, a negative w (the empty row 0
    with beg == qlen: the gscore-0 case), h0 <= o_ins + e_ins, unrelated
    targets that z-drop within rows 0-3 (and later tasks that z-drop while
    their later rows are in flight), N codes, and Lq 448 (two tiles past
    256 columns)."""
    import numpy as np
    import torch
    from lariat_tpu_torch.ops import sw_batch, sw_extend
    from lariat_tpu_torch.tools.kernel_turns import planted
    rng = np.random.default_rng(13)
    report = []
    for B, Lq, Lt in ((512, 192, 576), (512, 448, 320)):
        qlen = rng.integers(1, Lq + 1, B).astype(np.int32)
        tlen = np.minimum(qlen + rng.integers(-20, 200, B), Lt).clip(
            1).astype(np.int32)
        w = rng.integers(0, 101, B).astype(np.int32)
        h0 = rng.integers(0, 120, B).astype(np.int32)
        qlen[:8] = 0, 40, 25, 37, 60, 30, 20, 9
        tlen[:8] = Lt, 0, 20, Lt, Lt, Lt, min(60, Lt), 31
        w[3:8] = 12, 0, 35, 3, 9
        h0[7:10] = 5, 7, 2
        qlen[10:12], w[10:12], tlen[10:12] = (4, 5), (-4, -2), (10, 10)
        qlen[12:14] = Lq, min(Lq, 257)
        junk = np.zeros(B, bool)
        junk[14:40] = True                    # unrelated targets
        q, t = planted(rng, qlen, tlen, Lq, Lt, n_frac=0.05)
        at0 = rng.random(B) < 0.5             # half planted at column 0
        for b in np.nonzero(at0 & ~junk)[0]:
            n = int(min(qlen[b], tlen[b]))
            t[b, :n] = q[b, :n]
        t[junk] = rng.integers(0, 4, (int(junk.sum()), Lt))
        args = cuda(q, qlen, t, tlen, w, h0)
        mat = sw_extend.score_matrix(1, -4, -1, args[0].device)
        w_eff = sw_batch._adjust_w(torch.from_numpy(qlen),
                                   torch.from_numpy(w), 1, 5, 6, 1, 6,
                                   1).numpy()
        n_band = np.minimum(tlen, np.where(w_eff < 0, 0, qlen + w_eff))
        for zdrop in (100, 5, 0, -1):
            got = sw_extend.extend_batch(*args, zdrop=zdrop)
            want, rows = sw_batch.extend_batch(
                args[0], args[1], args[2], args[3], mat, args[4], args[5],
                zdrop=zdrop, packed=True, rows_run=True)
            torch.cuda.synchronize()
            if _max_abs_err(got[:6], want) or int(got[6:].abs().max()):
                raise AssertionError(f"K1 sw_extend differs on the edge "
                                     f"shapes ({B}, {Lq}, {Lt}), zdrop "
                                     f"{zdrop}")
            early = int((rows.cpu().numpy() < n_band).sum())
            report.append(f"({B}, {Lq}, {Lt}) zdrop {zdrop}: {early} "
                          f"stopped early")
    print(f"  K1 edge shapes exact: {'; '.join(report)}")


def _edges(cuda, D, S3):
    """K3 (both passes) and K2 with K2b on their edge shapes, exact
    against the twins: query columns past one tile (Lq 448), qlen 0, tlen
    0, tlen < 32, qlen not a multiple of 6, N codes, minsc 0; w 0,
    w >= qlen, rows past qlen + w (empty bands)."""
    import numpy as np
    import torch
    from lariat_tpu_torch.ops import sw_global, sw_local
    from lariat_tpu_torch.tools.kernel_turns import planted
    rng = np.random.default_rng(11)
    B, Lq, Lt = 512, 448, 704
    qlen = rng.integers(1, Lq + 1, B).astype(np.int32)
    tlen = rng.integers(1, Lt + 1, B).astype(np.int32)
    qlen[[0, 3, 4, 5, 6]] = 0, 151, 448, 193, 192
    tlen[[1, 2, 7]] = 0, 20, 31
    minsc = np.where(rng.random(B) < 0.3, 0, 19).astype(np.int32)
    q, t = planted(rng, qlen, tlen, Lq, Lt, n_frac=0.05)
    args = cuda(q, qlen, t, tlen, minsc)
    got = sw_local.local_two_pass(*args, **D, **S3)
    want = sw_local.local_two_pass(*(a.cpu() for a in args), **D, **S3)
    torch.cuda.synchronize()
    if _max_abs_err(got, want):
        raise AssertionError("K3 sw_local differs on the edge shapes")
    B, Lq, Lt = 512, 448, 512
    qlen = rng.integers(0, Lq + 1, B).astype(np.int32)
    tlen = np.clip(qlen + rng.integers(-40, 41, B), 1, Lt).astype(np.int32)
    w = rng.integers(0, 60, B).astype(np.int32)
    w[0], qlen[1], tlen[2], tlen[3], tlen[4] = 0, 0, 0, 10, 31
    w[5] = qlen[5] + 5                                  # w >= qlen
    w[6], tlen[6] = 3, min(int(qlen[6]) + 40, Lt)       # rows past qlen + w
    q, t = planted(rng, qlen, tlen, Lq, Lt, n_frac=0.05)
    args = cuda(q, qlen, t, tlen, w)
    gs, gz = sw_global.global_batch(*args, **D, **S3)
    ws, wz = sw_global.global_batch_plain(*args, **D, **S3)
    torch.cuda.synchronize()
    if max(_max_abs_err(gs, ws), _max_abs_err(gz, wz)):
        raise AssertionError("K2 sw_global differs on the edge shapes")
    S = Lq + Lt
    got = sw_global.traceback_ops_fused(gz, args[1], args[3], args[4], gs, S)
    want = sw_global.traceback_ops_fused_plain(wz, args[1], args[3],
                                               args[4], ws, S)
    torch.cuda.synchronize()
    if _max_abs_err(got, want):
        raise AssertionError("K2b traceback differs on the edge shapes")
    print("  edge shapes: K3 two-pass (512, 448, 704), K2 + K2b (512, 448, "
          "512): exact")


def _t1_vs_plain(rng, cuda, pk):
    """T1 against its twin in all six variants at 8192 x 192 x 576 and at
    4096 x 300 x 576 (two column tiles), each on planted inputs and on
    random ones (the ablation tool's codes; at Lq 300 with qlen 1-300),
    exact. Timed: every variant's kernel, and at Lq 192 on the planted
    inputs its twin, its warp steps (the kernel's count) and ns a warp
    step (ms x SMs / steps), beside K1's tile entry on the same planted
    tasks (qlen, tlen, w, h0 of the params). The bound is the baseline's
    on the planted inputs."""
    import numpy as np
    import torch
    from lariat_tpu_torch.ops import extend_ablate, sw_extend
    from lariat_tpu_torch.tools.kernel_roofline import OPS_PER_CELL
    from lariat_tpu_torch.tools.extend_ablate import (inputs,
                                                      ns_per_warp_step,
                                                      warp_steps)
    from lariat_tpu_torch.tools.kernel_turns import t1_inputs
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    B, Lq, Lt, B2, Lq2 = 8192, 192, 576, 4096, 300
    sets, p192 = {}, None
    for lq, b, qmax in ((Lq, B, 151), (Lq2, B2, Lq2)):
        q, t, params = t1_inputs(rng, b, lq, Lt, qmax=qmax)
        if lq == Lq:
            p192 = params
        sets[(lq, "planted")] = cuda(q, t, params)
        qr, tr, pr = inputs(b, lq, Lt, dev)
        if lq == Lq2:   # the tool's qlen 151 stays inside one tile
            pr[:, 0] = torch.from_numpy(rng.integers(
                1, lq + 1, b).astype(np.int32)).to(dev)
        sets[(lq, "random")] = (qr, tr, pr)
    qd, td, pd = sets[(Lq, "planted")]
    k1_args = (qd, pd[:, 0].contiguous(), td, pd[:, 1].contiguous(),
               pd[:, 2].contiguous(), pd[:, 3].contiguous())

    def k1(steps=None):
        return sw_extend.extend_batch(*k1_args, steps=steps)

    k1_steps = _k1_steps(k1, k1(), B)
    k1_ms = _median_ms(k1)
    k1_ns = ns_per_warp_step(k1_ms, k1_steps, sms)
    print(f"  K1 tile entry on T1's planted tasks ({B}, {Lq}, {Lt}): "
          f"{k1_ms:.3f} ms, {k1_steps} warp steps, {k1_ns:.1f} ns a warp "
          f"step ({sms} SMs)")
    out = {"k1_tile_same_tasks": {"ms": k1_ms, "warp_steps": k1_steps,
                                  "ns_per_warp_step": k1_ns},
           "variants": {}}
    err, base = 0, None
    for name, (half, kw) in extend_ablate.VARIANTS.items():
        Lv = Lt // 2 if half else Lt
        times = {}
        for (lq, kind), (qd, td, pd) in sets.items():
            def k():
                return extend_ablate.run_variant(qd, td, pd, Lv, **kw)

            def p():
                return extend_ablate.run_variant_plain(qd, td, pd, Lv, **kw)

            got, want = k(), p()
            torch.cuda.synchronize()
            e = _max_abs_err(got, want)
            if e:
                raise AssertionError(f"T1 extend_ablate {name} (Lq {lq}, "
                                     f"{kind}) differs from its plain "
                                     f"version (max abs err {e})")
            err = max(err, e)
            times[f"{kind}_{lq}"] = _median_ms(k)
            if (lq, kind) != (Lq, "planted"):
                continue
            times["plain"] = _median_ms(p, n=1)
            steps = warp_steps(qd, td, pd, Lv, **kw)
            if base is None:
                # the band cells up to the rows the baseline's outputs
                # prove visited (its best row max_i, its best to-the-end
                # row max_ie)
                o = got.cpu().numpy()
                ops = OPS_PER_CELL["extend"] * _band_cells(
                    p192[:, 0], np.maximum(o[2], o[4]) + 1, p192[:, 2])
                base = (times[f"{kind}_{lq}"], times["plain"],
                        *_bound(pk, ops, _nbytes(qd, td, pd, got)))
        ms = times[f"planted_{Lq}"]
        ns = ns_per_warp_step(ms, steps, sms)
        out["variants"][name] = {**times, "warp_steps": steps,
                                 "ns_per_warp_step": ns}
        print(f"  extend_ablate {name} (Lt {Lv}): exact at Lq {Lq} and "
              f"{Lq2}, planted and random; Lq {Lq} planted kernel "
              f"{ms:.3f} ms, {steps} warp steps, {ns:.1f} ns a warp step "
              f"(K1's tile entry {k1_ns:.1f}), plain {times['plain']:.3f} "
              f"ms; random {times[f'random_{Lq}']:.3f} ms; Lq {Lq2} "
              f"planted {times[f'planted_{Lq2}']:.3f} ms, random "
              f"{times[f'random_{Lq2}']:.3f} ms")
    return (err, base[0], base[1], (B, Lq, Lt), base[2], base[3], out)


def phase_data(scale: float, barcodes: int, pairs_per_bc: int):
    os.makedirs(SMOKE, exist_ok=True)
    tag = f"s{scale}_b{barcodes}_p{pairs_per_bc}"
    fasta = os.path.join(SMOKE, f"genome_{scale}.fa")
    reads = os.path.join(SMOKE, f"reads_{tag}.fastq.gz")
    if not os.path.exists(fasta + ".done"):
        _run([sys.executable, "tools/synth_genome.py", fasta, "--scale",
              str(scale), "--seed", "7"], timeout=600)
        open(fasta + ".done", "w").close()
    if not os.path.exists(reads + ".done"):
        _run([sys.executable, "tools/sim_reads.py", fasta, reads,
              "--barcodes", str(barcodes), "--pairs-per-bc",
              str(pairs_per_bc)], timeout=600)
        open(reads + ".done", "w").close()
    # the index, built (or loaded) and saved beside the FASTA by the CLIs'
    # own load_reference, in a subprocess
    info = _run([sys.executable, "-c",
                 "import sys; "
                 "from lariat_tpu_torch.cli import load_reference; "
                 "fm = load_reference(sys.argv[1]); "
                 "print(fm.l_pac, len(fm.contigs))", fasta], timeout=900)
    l_pac, n_contigs = (int(v) for v in info.split()[-2:])
    print(f"  genome {l_pac:,} bp, {n_contigs} contigs; reads "
          f"{os.path.relpath(reads, REPO)}")
    return fasta, reads


def phase_seeding(fasta, reads_path, pk):
    """K4a-K4c and K5 against their twins on the chr20-scale index, at the
    shapes of one 4,096-read seeding batch, then the device collect on a
    batch whose low-complexity reads send it to K4b (``_fallback_collect``);
    returns name -> (max abs err, kernel ms, plain ms, shape, bound ms,
    what sets it) and the K4b launches of that collect.

    The seeding kernels' bounds are bytes: 48 for each distinct fused row
    that the twins' ranks read on these inputs (``fm_batch.rank_rows``,
    ``lf_row``), each read once, plus their own inputs and outputs. They
    count no operations. K4a's lanes also count the rows they fetch (aux;
    one when both ranks of an extension share a block). K4a runs at round
    1's phase-A budget (timed), at phase B's 8L budget on the stragglers
    and at round 2, each in int32 and int64 indices; its walk lengths come
    out beside its time."""
    import numpy as np
    import torch
    from lariat_tpu_torch.align.engine import encode_read
    from lariat_tpu_torch.cli import load_reference
    from lariat_tpu_torch.config import AlignerConfig
    from lariat_tpu_torch.ops import fm_batch, smem_device as sd
    from lariat_tpu_torch.parallel import align_step
    from lariat_tpu_torch.tools.kernel_turns import seed_batch
    dev = torch.device("cuda")
    fm = load_reference(fasta)
    opt = AlignerConfig()
    fmd = fm_batch.DeviceFMIndex.from_host(fm, dev)
    g = align_step.DeviceGenome.from_host(fm, fmd)
    print(f"  index: fused {tuple(fmd.fused.shape)} int32 rows, "
          f"{fmd.idx_dtype}, seq_len {fmd.seq_len:,}")
    rmat, lens, qs = seed_batch(reads_path, SEED_READS)
    R, L = rmat.shape

    def put(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    def err(got, want):
        e = max(_max_abs_err(a, b) for a, b in zip(got, want))
        if e:
            raise AssertionError(f"differs from its plain version (max abs "
                                 f"err {e})")
        return e

    def no_rows():
        # a bool per fused row, which a twin sets where its ranks read
        return torch.zeros(fmd.fused.shape[0], dtype=torch.bool, device=dev)

    res = {}
    rd, lens_d = put(rmat), put(lens)
    fmd64 = fm_batch.DeviceFMIndex(fmd.fused, fmd.L2.long(), fmd.primary,
                                   fmd.seq_len)
    min_seed = opt.min_seed_len

    def k4a(f, reads, se, ee, mi, md, steps, bwd, cap):
        return sd.min_starts_twoptr(f, reads, se, ee, mi, L,
                                    max_steps=steps, min_seed=min_seed,
                                    cap=cap, mid=md, bwd_init=bwd)

    def p4a(f, reads, se, ee, mi, md, steps, bwd, cap, touched=None):
        meta, big, aux = sd.min_starts_twoptr_plain(
            f, reads, se, ee, mi.to(f.idx_dtype), md, L, sd._budget(steps),
            bwd, min_seed, cap, touched)
        sd._twoptr_flags(meta, aux, cap)
        return meta, big, aux

    # round 1 at its phase-A budget (3L), as the collect runs it
    runs = {"round1": (rd, put(np.zeros(R), np.int32), lens_d,
                       put(np.ones(R), np.int64),
                       put(np.full(R, L + 2), np.int32), 3 * L, False,
                       sd.CAP1)}
    meta1, big1, _ = k4a(fmd, *runs["round1"])
    meta1 = meta1.cpu().numpy()
    # phase B: round 1's stragglers rerun at 8L, padded as the collect
    # pads them, with the six low-complexity reads, which outrun round 1's
    # budget on this genome (phase 5's collect runs them too)
    idx = np.nonzero(meta1[:, sd.CAP1 + 1] == 0)[0]
    lc = [encode_read(s) for s in LOW_COMPLEXITY]
    nb = len(idx) + len(lc)
    Rs = sd._pad_pow2(nb)
    rmat_b = np.full((Rs, L), 4, np.uint8)
    rmat_b[:len(idx)] = rmat[idx]
    end_b = np.zeros(Rs, np.int64)
    end_b[:len(idx)] = lens[idx]
    for k, s in enumerate(lc, start=len(idx)):
        rmat_b[k, :len(s)] = s
        end_b[k] = len(s)
    mid_b = np.zeros(Rs, np.int64)
    mid_b[:nb] = L + 2
    runs["phaseB"] = (put(rmat_b), put(np.zeros(Rs), np.int32),
                      put(end_b, np.int32), put(np.ones(Rs), np.int64),
                      put(mid_b, np.int32), 8 * L, False, sd.CAP1)
    # round 2 on the reseed requests of round 1, as the collect builds them
    ri1, m1 = sd._slots(meta1, big1.cpu().numpy(), sd.CAP1, R)
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    re = (m1[:, 4] - m1[:, 3] >= split_len) & (m1[:, 2] <= opt.split_width)
    n2 = int(re.sum())
    R2 = sd._pad_pow2(n2)
    mid2, end2, mi2, rows2 = (np.zeros(R2, np.int64) for _ in range(4))
    mi2 += 1
    mid2[:n2] = (m1[re, 3] + m1[re, 4]) >> 1
    end2[:n2] = lens[ri1[re]]
    mi2[:n2] = m1[re, 2] + 1
    rows2[:n2] = ri1[re]
    runs["round2"] = (rd[put(rows2)], put(mid2, np.int32),
                      put(end2, np.int32), put(mi2), put(mid2, np.int32),
                      4 * L, True, sd.CAP2)
    # each run against the twin in int32 and int64 indices; the walk
    # lengths (aux, over the lanes before the padding) and times of the
    # int32 runs
    real = {"round1": R, "phaseB": nb, "round2": n2}
    stats, e4a = {}, 0
    t4a = no_rows()
    for name, a in runs.items():
        for f in (fmd, fmd64):
            got = k4a(f, *a)
            want = p4a(f, *a, touched=t4a if name == "round1" else None)
            e4a = max(e4a, err(got, want))
        aux = got[2][:real[name]].cpu().numpy().astype(np.int64)
        ms = _median_ms(lambda: k4a(fmd, *a))
        tr = aux[:, 1]
        stats[name] = {"lanes": real[name],
                       "transitions_max": int(tr.max()),
                       "transitions_median": float(np.median(tr)),
                       "transitions_sum": int(tr.sum()),
                       "rows_sum": int(aux[:, 2].sum()), "ms": ms,
                       "us_per_transition": 1e3 * ms / max(int(tr.max()),
                                                           1)}
        print(f"  K4a {name} ({stats[name]['lanes']} lanes): exact in int32 "
              f"and int64; {json.dumps(stats[name])}")
    print(f"  K4a round 1: flags {int(meta1[0, -1]) & 3}, "
          f"{int(meta1[:, sd.CAP1].sum())} seeds, {len(idx)} stragglers; "
          f"phase B: those and {len(lc)} low-complexity reads; round 2: "
          f"{n2} reseed lanes")

    def k4a_r1():
        return sd.min_starts_twoptr(fmd, *runs["round1"][:4], L,
                                    max_steps=3 * L, min_seed=min_seed,
                                    cap=sd.CAP1, mid=runs["round1"][4])[:2]

    def p4a_r1():
        return p4a(fmd, *runs["round1"])[:2]

    r1 = stats["round1"]
    rows4a = int(t4a.sum())
    res["smem_twoptr"] = (e4a, r1["ms"], _median_ms(p4a_r1, n=1), (R, L),
                          *_bound(pk, 0, 48 * rows4a + _nbytes(
                              *runs["round1"][:5], *k4a_r1())),
                          {"transitions": stats, "rows_distinct": rows4a})

    ri = put(np.repeat(np.arange(R), L), np.int32)
    ee = put(np.tile(np.arange(1, L + 1), R), np.int32)
    mi = put(np.ones(R * L), np.int64)

    def k4b():
        return sd.min_starts_kernel(fmd, rd, ri, ee, mi, L)

    def p4b():
        return sd.min_starts_kernel_plain(fmd, rd, ri, ee, mi, L)

    # int64 and int32 indices, each with the lanes' counters; the int32
    # run's rows bound it
    e4b = 0
    for f in (fmd64, fmd):
        cnt = torch.full((R * L, 2), -1, dtype=torch.int32, device=dev)
        out4b = sd.min_starts_kernel(f, rd, ri, ee, mi, L, counts=cnt)
        t4b = no_rows()
        want4b = sd.min_starts_kernel_plain(f, rd, ri, ee, mi, L, t4b)
        e4b = max(e4b, err(out4b, want4b))
        if int(cnt.min()) < 0:
            raise AssertionError("K4b left a lane uncounted")
    c = cnt.long()
    n_ext, n_rows = int(c[:, 0].sum()), int(c[:, 1].sum())
    info4b = {"lanes": R * L, "extensions": n_ext,
              "extensions_max": int(c[:, 0].max()), "rows_fetched": n_rows,
              "rows_per_extension": n_rows / max(n_ext, 1),
              "rows_distinct": int(t4b.sum())}
    print(f"  K4b ({R * L} lanes): exact in int32 and int64; "
          f"{json.dumps(info4b)}")
    res["smem_exhaustive"] = (e4b, _median_ms(k4b), _median_ms(p4b, n=1),
                              (R * L,),
                              *_bound(pk, 0, 48 * int(t4b.sum()) + _nbytes(
                                  rd, ri, ee, mi, *out4b)), info4b)
    cap3 = max(2, L // opt.min_seed_len + 2)

    def s1(f):
        return (f, rd, lens_d, int(opt.max_mem_intv), L, opt.min_seed_len,
                cap3)

    def k4c():
        return sd.strategy1(*s1(fmd))

    def p4c():
        return sd.pack_r3(*sd.strategy1_plain(*s1(fmd)))

    # int32 and int64 indices; the int32 run's rows bound it
    e4c = err(sd.strategy1(*s1(fmd64)),
              sd.pack_r3(*sd.strategy1_plain(*s1(fmd64))))
    out4c = k4c()
    t4c = no_rows()
    want4c = sd.strategy1_plain(*s1(fmd), touched=t4c)
    res["smem_strategy1"] = (max(e4c, err(out4c, sd.pack_r3(*want4c))),
                             _median_ms(k4c), _median_ms(p4c, n=3), (R, L),
                             *_bound(pk, 0, 48 * int(t4c.sum()) + _nbytes(
                                 rd, lens_d, *out4c)))
    res["sa_walk"] = _k5_lookup(fm, fmd, fmd64, g, pk, no_rows, err)
    planes_res, planes_launches = _planes_k9(pk, fmd, fmd64, runs, L,
                                             no_rows, err)
    res.update(planes_res)
    for name, (e, ms, pms, shape, bms, by, *_) in res.items():
        print(f"  {name} {shape}: exact (max abs err {e}); kernel "
              f"{ms:.3f} ms, plain {pms:.3f} ms; bound {bms:.4f} ms "
              f"({by}), {100 * bms / ms:.1f}% of it")
    print(f"  K4a: {r1['us_per_transition']:.3f} us a transition of the "
          f"longest lane ({r1['transitions_max']} transitions in "
          f"{r1['ms']:.3f} ms) beside its bound")
    res["sw_extend_desc"] = _k1_desc_wave(fm, pk)
    res["seed_trace"] = _traced_collect(fm, fmd, g, qs, opt)
    return (res, _fallback_collect(fm, fmd, g, qs[:FALLBACK_READS], opt),
            planes_launches)


def _same_seeds(got, want, n, what):
    """A device collect's (seeds, rbegs) equal to the native C++ seeder's,
    read for read, over ``n`` reads."""
    import numpy as np
    if not len(got[0]) == len(got[1]) == len(want[0]) == n:
        raise AssertionError(f"{what}: read count")
    for i, (gm, gr, wm, wr) in enumerate(zip(*got, *want)):
        if not (np.array_equal(gm, np.asarray(wm).reshape(-1, 5))
                and np.array_equal(gr, np.asarray(wr))):
            raise AssertionError(f"{what}: read {i} differs from the "
                                 f"native seeder")


def _traced_collect(fm, fmd, g, qs, opt):
    """One warm collect_seeds_rbegs_device of the batch's reads with the
    seeding trace on (``smem_device.SEED_TRACE``, what LARIAT_SEED_TRACE=1
    sets at import): its seeds and rbegs equal to the native C++ seeder's,
    the [seedtrace] ms summed by tag printed beside the call's wall."""
    import contextlib
    import io
    import numpy as np
    from lariat_tpu_torch.index import native_ops
    from lariat_tpu_torch.ops import smem_device as sd
    want = native_ops.collect_seeds_rbegs_batch(fm, qs, opt)
    if want is None:
        raise RuntimeError("native seeding unavailable")
    sd.collect_seeds_rbegs_device(fmd, g, fm, qs, opt)   # warm
    buf, prev = io.StringIO(), sd.SEED_TRACE
    sd.SEED_TRACE = True
    try:
        with contextlib.redirect_stdout(buf):
            t0 = time.time()
            got = sd.collect_seeds_rbegs_device(fmd, g, fm, qs, opt)
            wall = (time.time() - t0) * 1e3
    finally:
        sd.SEED_TRACE = prev
    _same_seeds(got, want, len(qs), "traced collect")
    sums, notes = {}, []
    for line in buf.getvalue().splitlines():
        m = re.fullmatch(r"\[seedtrace\] (.+?) +(-?[0-9.]+)ms", line)
        if m:
            sums[m.group(1)] = sums.get(m.group(1), 0.0) + float(m.group(2))
        elif line.startswith("[seedtrace] "):
            notes.append(line[len("[seedtrace] "):])
    if "merge+sort" not in sums or "sa walk" not in sums:
        raise AssertionError(f"seeding trace: {buf.getvalue()!r}")
    print(f"  seeding trace, one warm device collect of {len(qs)} reads, "
          f"ms by tag: {json.dumps(sums)} (sum {sum(sums.values()):.1f} of "
          f"{wall:.1f} ms wall; {'; '.join(notes)})")
    return {"ms_by_tag": sums, "wall_ms": wall, "notes": notes}


def _k5_lookup(fm, fmd, fmd64, g, pk, no_rows, err):
    """K5 as the SA lookup runs it, one launch at the whole budget
    (``align_step.LOOKUP_STEPS``) over 65,536 random rows (``kernel_turns.
    lookup_rows``), against its twin in int32 and int64 indices, timed with
    its bound (48 bytes a distinct fused row the twin's walks read, plus
    inputs and outputs); beside it the phase-1 shape of earlier trees (64
    steps), the whole ``sa_lookup_batch_host`` (the launch, the download and
    the host sample add, positions checked against the twin's walk), the
    longest walk's steps and the us a step of that walk."""
    import numpy as np
    import torch
    from lariat_tpu_torch.parallel import align_step
    from lariat_tpu_torch.tools.kernel_turns import lookup_rows
    dev = fmd.device
    rows = lookup_rows(fm.seq_len)
    n5 = len(rows)
    steps = align_step.LOOKUP_STEPS
    e5 = 0
    for f in (fmd64, fmd):        # the int32 run's inputs are kept
        gf = align_step.DeviceGenome.from_host(fm, f)
        k5 = (gf, torch.from_numpy(rows).to(dev, f.idx_dtype),
              torch.zeros(n5, dtype=f.idx_dtype, device=dev),
              torch.zeros(n5, dtype=torch.bool, device=dev), steps)
        out5 = align_step.sa_walk_chunk(*k5)
        t5 = no_rows()
        want5 = align_step.sa_walk_chunk_plain(*k5, touched=t5)
        e5 = max(e5, err([out5], [want5]))
        if not bool(out5[2].bool().all()):
            raise AssertionError("K5: a walk outlived the lookup's budget")

    def k5k():
        return align_step.sa_walk_chunk(*k5)

    def k5p1():
        return align_step.sa_walk_chunk(*k5[:4], 64)

    def lookup():
        return align_step.sa_lookup_batch_host(g, fm, rows)

    sa = np.asarray(fm.sa_samples)
    wk, ws = (want5[i].cpu().numpy().astype(np.int64) for i in (0, 1))
    if not np.array_equal(lookup(), sa[wk // fm.sa_intv] + ws):
        raise AssertionError("the SA lookup differs from its twin's walk")
    ms = _median_ms(k5k)
    longest = int(ws.max())
    info = {"max_steps": steps, "longest": longest,
            "mean_steps": float(ws.mean()),
            "past_64": int((ws > 64).sum()),
            "us_per_step_longest": 1e3 * ms / max(longest, 1),
            "phase1_ms": _median_ms(k5p1), "lookup_ms": _median_ms(lookup),
            "rows_distinct": int(t5.sum())}
    print(f"  K5 one launch ({n5} rows, {steps} steps): exact in int32 and "
          f"int64; {json.dumps(info)}")
    return (e5, ms, _median_ms(lambda: align_step.sa_walk_chunk_plain(*k5),
                               n=3), (n5, steps),
            *_bound(pk, 0, 48 * int(t5.sum()) + _nbytes(*k5[1:4], out5)),
            info)


def _k1_desc_wave(fm, pk, dtypes=None):
    """K1's descriptor entry (``resident.extend_wave_resident`` on the
    card: one launch) on a wave built from the index's genome against
    build_qt plus the twin on the card, exact, with int32 and int64
    descriptors (``dtypes``; int64 alone where positions pass 2^31): 8,192
    extensions of 2,048 reads drawn from both strands
    (2% substitutions, 1% N), right extensions (qdir = tdir = 1) and left
    ones (qdir = tdir = -1), reverse-strand tstart >= l_pac, and tasks that
    run off the read or off either end of the doubled text. Returns, from
    the first dtype's run, the descriptor entry's ms with its bound, the
    tile entry's on build_qt's tiles of the same wave with its bound, the ms of
    the path the descriptor entry replaces (build_qt, the descriptor
    columns, the tile entry), each a median of 7, and the wave's rows run
    (the twin's), band cells and warp steps (the kernel's count)."""
    import numpy as np
    import torch
    from lariat_tpu_torch.ops import _build, resident, sw_batch, sw_extend
    from lariat_tpu_torch.tools.kernel_roofline import OPS_PER_CELL
    dev = torch.device("cuda")
    rng = np.random.default_rng(17)
    l_pac, n, n_reads, B, Lq, Lt = int(fm.l_pac), 151, 2048, 8192, 192, 256
    P = rng.integers(0, 2 * l_pac - n, n_reads)
    P = np.where((P < l_pac) & (P + n > l_pac), P - n, P)  # one strand
    reads = []
    for p0 in P:
        r = np.array(fm.fetch_fmd(int(p0), int(p0) + n), np.uint8)
        mut = rng.random(n) < 0.02
        r[mut] = (r[mut] + 1) % 4
        r[rng.random(n) < 0.01] = 4
        reads.append(r)
    rid = rng.integers(0, n_reads, B)
    s0 = rng.integers(1, n, B)
    right = rng.random(B) < 0.5
    qdir = np.where(right, 1, -1)
    qstart = np.where(right, s0, s0 - 1)
    qlen = np.where(right, n - s0, s0)
    tdir = qdir
    tstart = np.where(right, P[rid] + s0, P[rid] + s0 - 1)
    tlen = np.minimum(qlen + rng.integers(0, 100, B), Lt)
    h0 = rng.integers(19, 152, B)
    w = np.where(rng.random(B) < 0.8, 100, rng.integers(0, 100, B))
    off = np.arange(B) < 64                  # off the ends
    tstart[off] = np.where(np.arange(64) < 32, rng.integers(-40, 5, 64),
                           2 * l_pac - rng.integers(1, 40, 64))[:off.sum()]
    qstart[64:96] = rng.integers(n - 5, n + 20, 32)
    desc = resident.pack_desc(rid, qstart, qdir, qlen, tstart, tdir, tlen,
                              h0, w, l_pac)
    reads_d = resident.put_reads(reads, dev).codes
    pac_d = resident.pac_words_from_fm(fm, dev)
    opt_key = (6, 1, 6, 1, 5, 100, 1, -4)
    mat = sw_extend.score_matrix(1, -4, -1, dev)
    out = {"tstart_past_2_31": int((tstart >= 1 << 31).sum())}
    dtypes = dtypes or (np.int32, np.int64)
    for dt in dtypes:
        desc_d = torch.from_numpy(desc.astype(dt)).to(dev)

        def k1d(steps=None):
            return sw_extend.extend_desc(reads_d, pac_d, l_pac, desc_d, Lq, Lt,
                                         steps=steps)

        def cols():
            return [desc_d[:, k].to(torch.int32).contiguous()
                    for k in (resident.D_QL, resident.D_TL, resident.D_W,
                              resident.D_H0)]

        def tiles():
            q, t = resident.build_qt(reads_d, pac_d, l_pac, desc_d, Lq, Lt)
            ql, tl, wd, hd = cols()
            return sw_extend.extend_batch(q, ql, t, tl, wd, hd)

        # the CLI's call: one launch through the descriptor entry
        before = (_build.launches()["sw_extend"],
                  _build.entry_launches()["lariat_sw_extend_desc"])
        got = resident.extend_wave_resident(reads_d, pac_d, l_pac, desc_d,
                                            Lq, Lt, opt_key)
        after = (_build.launches()["sw_extend"],
                 _build.entry_launches()["lariat_sw_extend_desc"])
        if after != (before[0] + 1, before[1] + 1):
            raise AssertionError("K1's descriptor entry did not launch once")
        q, t = resident.build_qt(reads_d, pac_d, l_pac, desc_d, Lq, Lt)
        ql, tl, wd, hd = cols()
        want, rows = sw_batch.extend_batch(q, ql, t, tl, mat, wd, hd,
                                           packed=True, rows_run=True)
        qlt, tlt = q.to(torch.uint8), t.to(torch.uint8)

        def k1t():
            return sw_extend.extend_batch(qlt, ql, tlt, tl, wd, hd)

        torch.cuda.synchronize()
        if (_max_abs_err(got[:6], want) or int(got[6:].abs().max())
                or _max_abs_err(k1t(), got)):
            raise AssertionError(f"K1's descriptor entry differs from "
                                 f"build_qt + the twin or the tile entry "
                                 f"({dt.__name__})")
        if dt is dtypes[0]:
            rows = rows.cpu().numpy()
            w_eff = sw_batch._adjust_w(torch.from_numpy(qlen.astype(np.int32)),
                                       torch.from_numpy(w.astype(np.int32)),
                                       1, 5, 6, 1, 6, 1).numpy()
            cells = _band_cells(np.minimum(qlen, Lq), rows, w_eff)
            ops = OPS_PER_CELL["extend"] * cells
            # the descriptor entry must read its descriptors, each query
            # code and 2 bits a target row it runs, and write its rows
            n_rows = np.minimum(np.minimum(tlen, Lt),
                                np.where(w_eff < 0, 0,
                                         np.minimum(qlen, Lq) + w_eff))
            desc_bytes = (_nbytes(desc_d, got) + int(np.minimum(qlen, Lq).sum())
                          + int(np.maximum(n_rows, 0).sum() + 3) // 4)
            dbms, dby = _bound(pk, ops, desc_bytes)
            tbms, tby = _bound(pk, ops, _nbytes(qlt, tlt, ql, tl, wd, hd, got))
            out |= {"desc_ms": _median_ms(k1d), "desc_bound_ms": dbms,
                   "desc_bound_by": dby, "tiles_ms": _median_ms(k1t),
                   "tiles_bound_ms": tbms, "tiles_bound_by": tby,
                   "build_qt_and_tiles_ms": _median_ms(tiles),
                   "rows_run": int(rows.sum()), "band_cells": cells,
                   "warp_steps": _k1_steps(k1d, got, B)}
    good = int((want[0] > torch.from_numpy(h0).to(dev)).sum())
    print(f"  K1 descriptor entry, {B} extensions on {l_pac:,} bp ({good} "
          f"gained on h0): exact in "
          f"{' and '.join(np.dtype(d).name for d in dtypes)}, and equal to "
          f"the tile entry on build_qt's tiles; {json.dumps(out)}")
    return out


def _planes_k9(pk, fmd, fmd64, runs, L, no_rows, err):
    """K4a's planes entry and K9 (phase 5), off every path: round 1 of the
    4,096-read batch at an 8L budget and round 2 (bwd_init) on its reseed
    lanes at 32L, each in int32 and int64 indices against the planes twin;
    K9 on those planes in both layouts, at round 1's mid (L + 2) and round
    2's real mids, and at a cap that overflows, against its twins; K9's
    round-1 slots against K4a's direct slots where both finished. Returns
    (name -> result row, the launches of one planes-then-compaction pass
    over both rounds)."""
    import numpy as np
    import torch
    from lariat_tpu_torch.ops import _build, smem_device as sd
    from lariat_tpu_torch.tools.kernel_turns import (backtoback_ms,
                                                     device_split, events_ms)
    min_seed = 19
    rd, se1, ee1, mi1 = runs["round1"][:4]
    dev = rd.device
    rd2, se2, ee2, mi2, md2 = runs["round2"][:5]
    R = rd.shape[0]
    md1 = torch.full((R,), L + 2, dtype=torch.int32, device=dev)
    cases = {"round1": (rd, se1, ee1, mi1, 8 * L, False, md1, sd.CAP1),
             "round2": (rd2, se2, ee2, mi2, 32 * L, True, md2, sd.CAP2)}

    def planes(f, name):
        r, se, ee, mi, steps, bwd = cases[name][:6]
        return sd.min_starts_twoptr_planes(f, r, se, ee, mi, L,
                                           max_steps=steps, bwd_init=bwd)

    def planes_plain(f, name, touched=None):
        r, se, ee, mi, steps, bwd = cases[name][:6]
        return sd.min_starts_twoptr_plain(
            f, r, se.to(torch.int32), ee.to(torch.int32),
            mi.to(f.idx_dtype), None, L, sd._budget(steps), bwd, 0, 0,
            touched, planes=True)

    # the path: planes then the packed compaction, both rounds, int32
    _build.reset_launches()
    for name, (_, se, ee, _, _, _, md, cap) in cases.items():
        b, x0, x1, s, v, done, _ = planes(fmd, name)
        sd.compact_starts_packed(b, x0, x1, s, v, se, ee, md, done,
                                 min_seed, cap)
    torch.cuda.synchronize()
    drive = {k: _build.launches()[k] for k in ("smem_planes", "compact")}
    if drive != {"smem_planes": 2, "compact": 2}:
        raise AssertionError(f"planes pass launches: {drive}")

    res, info, kept = {}, {}, {}
    touched = no_rows()
    e_pl = 0
    for name in cases:
        for f in (fmd, fmd64):
            got = planes(f, name)
            want = planes_plain(f, name, touched if (
                name == "round1" and f is fmd) else None)
            e_pl = max(e_pl, err(got[:5] + got[6:], want))
            if bool(got[5]) != bool(want[5][:, 0].all()):
                raise AssertionError(f"planes {name}: done flag")
            kept[name, f.idx_dtype] = got
        aux = got[6].cpu().numpy().astype(np.int64)
        info[name] = {"lanes": int(aux.shape[0]), "done": bool(got[5]),
                      "transitions_max": int(aux[:, 1].max()),
                      "transitions_sum": int(aux[:, 1].sum()),
                      "rows_sum": int(aux[:, 2].sum())}
    # times and bounds of round 1: 48 B a distinct fused row its ranks
    # read, its inputs and its planes out
    for f, tag in ((fmd, ""), (fmd64, "_int64")):
        out = kept["round1", f.idx_dtype]
        info["round1"]["ms" + tag] = _median_ms(lambda: planes(f, "round1"))
        info["round1"]["bound" + tag] = _bound(
            pk, 0, 48 * int(touched.sum()) + _nbytes(rd, se1, ee1, mi1)
            + _nbytes(*out[:5], out[6]))
    print(f"  K4a planes entry: exact in int32 and int64 (round 1 {R} "
          f"lanes at 8L, round 2 {info['round2']['lanes']} lanes at 32L); "
          f"{json.dumps(info)}")
    r1 = info["round1"]
    res["smem_planes"] = (e_pl, r1["ms"],
                          _median_ms(lambda: planes_plain(fmd, "round1"),
                                     n=1),
                          (R, L), *r1["bound"],
                          {"rows_distinct": int(touched.sum()),
                           "ms_int64": r1["ms_int64"],
                           "bound_ms_int64": r1["bound_int64"][0],
                           "rounds": info})

    # K9 on those planes: both layouts, both rounds' mids, the collect's
    # caps, then min_seed 0 at a cap one below the longest lane's count
    # (an overflow), then at L (none: the flag and the flags column must
    # read 0 after the call that overflowed)
    e9, k9, ovf = 0, {}, []
    for (name, dt), (b, x0, x1, s, v, done, _) in kept.items():
        se, ee, md, cap = (cases[name][i] for i in (1, 2, 6, 7))
        args = (b, x0, x1, s, v, se, ee, md)
        for ms_, cp in ((min_seed, cap), (0, None), (0, L)):
            if cp is None:
                most = int(sd.compact_starts_plain(*args, 0, L)[5].max())
                cp = max(1, most - 1)
            got = sd.compact_starts(*args, ms_, cp)
            want = sd.compact_starts_plain(*args, ms_, cp)
            gpk = sd.compact_starts_packed(*args, done, ms_, cp)
            wpk = sd.compact_starts_packed_plain(*args, done, ms_, cp)
            e9 = max(e9, err(got, want), err([gpk], [wpk]))
            if ms_ == 0 and cp < L:
                ovf.append(bool(got[6]))
            elif ms_ == 0 and (bool(got[6]) or bool(
                    (gpk[:, -1] != int(bool(done))).any())):
                raise AssertionError("K9: the overflow of the call before "
                                     "stayed set")
            elif ms_:
                k9[f"{name}_seeds"] = int(got[5].long().sum())
    if not any(ovf):
        raise AssertionError(f"K9: no small cap overflowed: {ovf}")
    # one packed call captured in a CUDA graph (so the wrapper never waits
    # for the card) and replayed twice: an overflowing cap, then L
    b, x0, x1, s, v, done = kept["round1", fmd.idx_dtype][:6]
    args = (b, x0, x1, s, v, se1, ee1, md1)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        cap_out = [sd.compact_starts_packed(*args, done, 0, cp)
                   for cp in (2, L)]
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        e9 = max(e9, err(cap_out, [sd.compact_starts_packed_plain(
            *args, done, 0, cp) for cp in (2, L)]))
    del graph
    k9["graph_replays_exact"] = 2
    # K9's round-1 slots against K4a's direct slots (8L), lanes done in both
    b, x0, x1, s, v, done, aux = kept["round1", fmd.idx_dtype]
    qb, qe, cx0, cx1, cs, counts, _ = sd.compact_starts(
        b, x0, x1, s, v, se1, ee1, md1, min_seed, sd.CAP1)
    meta, big, _ = sd.min_starts_twoptr(fmd, rd, se1, ee1, mi1, L,
                                        max_steps=8 * L, min_seed=min_seed,
                                        cap=sd.CAP1, mid=md1)
    C = sd.CAP1
    both = (meta[:, C + 1] == 1) & (aux[:, 0] == 1)
    n = counts.clamp(max=C)
    k = torch.arange(C, device=dev)[None, :] < n[:, None]
    slots = (qb << 16) | qe
    same = ((meta[:, C] == n)
            & ((~k) | ((meta[:, :C] == slots)
                       & (big[:, :C] == cx0) & (big[:, C:2 * C] == cx1)
                       & (big[:, 2 * C:] == cs))).all(dim=1))
    if not bool(same[both].all()):
        raise AssertionError("K9's round-1 slots differ from K4a's")
    k9["lanes_checked_against_k4a"] = int(both.sum())
    # times and bounds at round 1 in int32 and int64, both layouts: with
    # the wrapper (median of 7), in device time as a spun single call and
    # as the mean of 200 calls back to back (a CUDA graph), and what one
    # call enqueues (torch.profiler). Bound: b and valid of every column,
    # x0, x1, s of the kept columns, the lanes' ranges, the outputs
    for f, tag in ((fmd, ""), (fmd64, "_int64")):
        b, x0, x1, s, v, done = kept["round1", f.idx_dtype][:6]
        args = (b, x0, x1, s, v, se1, ee1, md1)
        out = sd.compact_starts(*args, min_seed, C)
        pko = sd.compact_starts_packed(*args, done, min_seed, C)
        need = (_nbytes(b, v, se1, ee1, md1) + 3 * R * C * x0.element_size())
        calls = {"": lambda: sd.compact_starts(*args, min_seed, C),
                 "packed_": lambda: sd.compact_starts_packed(
                     *args, done, min_seed, C)}
        for lay, fn in calls.items():
            k9[f"{lay}ms{tag}"] = _median_ms(fn)
            k9[f"{lay}dev_ms{tag}"] = events_ms(fn)
            k9[f"{lay}b2b_ms{tag}"] = backtoback_ms(fn)
            split = device_split(fn)
            others = {n_: c for n_, (c, _) in split.items()
                      if n_ != "compact_kernel"}
            if (split.get("compact_kernel", [0])[0] != 1
                    or any(not n_.lower().startswith("memset")
                           for n_ in others)
                    or sum(others.values()) > 1):
                raise AssertionError(f"K9 call enqueues more than K9 and "
                                     f"one memset: {split}")
            k9[f"{lay}enqueued{tag}"] = split
        k9["bound" + tag] = _bound(pk, 0, need + _nbytes(*out[:7]))
        k9["packed_bound" + tag] = _bound(pk, 0, need + _nbytes(pko))
        if not tag:
            # the stable argsort and gathers are both the twin and the one
            # PyTorch route to this function: one timing, reported as
            # plain_ms and as library_ms
            k9["plain_ms"] = k9["library_ms"] = _median_ms(
                lambda: sd.compact_starts_plain(*args, min_seed, C), n=3)
    print(f"  K9: exact in both layouts, int32 and int64, mids L + 2 and "
          f"round 2's, caps 32/16, caps that overflow and then L (flags "
          f"reset), and replayed from a CUDA graph; {json.dumps(k9)}")
    res["compact"] = (e9, k9["ms"], k9["plain_ms"], (R, L), *k9["bound"],
                      {"library_ms": k9["library_ms"],
                       "library_ms_is_plain_ms": True,
                       **{key: k9[key] for key in k9
                          if key not in ("ms", "plain_ms", "library_ms",
                                         "bound")},
                       "bound_ms_int64": k9["bound_int64"][0],
                       "share_b2b": k9["bound"][0] / k9["b2b_ms"],
                       "share_dev": k9["bound"][0] / k9["dev_ms"],
                       "share_wrapper": k9["bound"][0] / k9["ms"]})
    return res, drive


def _fallback_collect(fm, fmd, g, qs, opt) -> int:
    """collect_seeds_rbegs_device, the main path's seeding call, on reads of
    the FASTQ plus low-complexity reads that blow K4a's step cap, so round
    1 takes the exhaustive fallback (K4b); its seeds and rbegs must equal
    the native C++ seeder's, and each K4b call of the collect its twin's on
    the same inputs (exact); the lanes and the largest interval row K4b
    returned are printed beside 2^31. Returns K4b's launches in that
    call."""
    import numpy as np
    from lariat_tpu_torch.align.engine import encode_read
    from lariat_tpu_torch.index import native_ops
    from lariat_tpu_torch.ops import _build, smem_device as sd
    reads = qs + [encode_read(s) for s in LOW_COMPLEXITY]
    want = native_ops.collect_seeds_rbegs_batch(fm, reads, opt)
    if want is None:
        raise RuntimeError("native seeding unavailable")
    calls = []
    k4b = sd.min_starts_kernel

    def logged(*a, **kw):
        out = k4b(*a, **kw)
        calls.append((a, out))
        return out

    _build.reset_launches()
    sd.min_starts_kernel = logged
    try:
        got = sd.collect_seeds_rbegs_device(fmd, g, fm, reads, opt)
    finally:
        sd.min_starts_kernel = k4b
    n = _build.launches()["smem_exhaustive"]
    if g.sa_samples is not None:
        raise AssertionError("the seeding path uploaded the SA samples")
    _same_seeds(got, want, len(reads), "fallback collect")
    err, lanes, top = 0, 0, 0
    for a, out in calls:
        err = max([err] + [_max_abs_err(x, y) for x, y in zip(
            out, sd.min_starts_kernel_plain(*a))])
        lanes += int(out[0].shape[0])
        ok = out[4]
        if bool(ok.any()):
            top = max(top, int((out[1][ok] + out[3][ok]).max()))
    if err:
        raise AssertionError(f"fallback collect: K4b differs from its twin "
                             f"(max abs err {err})")
    n_mems = sum(len(m) for m in got[0])
    print(f"  fallback collect: {len(reads)} reads ({len(LOW_COMPLEXITY)} "
          f"low-complexity), {n_mems} seeds, "
          f"{sum(len(r) for r in got[1])} rbegs, equal to native; K4b "
          f"launched {n} times over {lanes} lanes, exact against its twin "
          f"on them; largest row of its intervals {top:,} (2^31 = "
          f"{1 << 31:,}; {fmd.idx_dtype})")
    return n


def phase_align_step(fasta, pk, logs):
    """K7, K8, K1's step entry and K5's lookup entry against their twins on
    phase 4's index (int32 and int64), each timed at the align step's
    shapes with its bound; K7, K8 and the step entry past 2^31 on
    synthetic tables; then both align steps at 8,192 x 151 against the
    same steps on the twins, with the launches of the int32 kernel run;
    then tools/device_step.py. Returns (name -> (max abs err, kernel ms,
    plain ms, shape, bound ms, what sets it, info), the step entry's
    numbers, the step run's launches)."""
    import numpy as np
    import torch
    from lariat_tpu_torch.align.ksw import fill_score_matrix
    from lariat_tpu_torch.cli import load_reference
    from lariat_tpu_torch.ops import _build, fm_batch, resident, sw_batch
    from lariat_tpu_torch.ops import sw_extend
    from lariat_tpu_torch.parallel import align_step as st
    from lariat_tpu_torch.tools.device_step import step_reads
    from lariat_tpu_torch.tools.kernel_roofline import OPS_PER_CELL
    from lariat_tpu_torch.tools.kernel_turns import events_ms
    dev = torch.device("cuda")
    fm = load_reference(fasta)
    fmd = fm_batch.DeviceFMIndex.from_host(fm, dev)
    fmd64 = fm_batch.DeviceFMIndex(fmd.fused, fmd.L2.long(), fmd.primary,
                                   fmd.seq_len)
    genomes = {f.idx_dtype: st.DeviceGenome.from_host(fm, f)
               for f in (fmd, fmd64)}
    g = genomes[fmd.idx_dtype]
    B, L, seed_len, window = STEP_B, STEP_L, 32, 32
    reads_np, starts = step_reads(fm, B, L)
    mat = fill_score_matrix(1, 4)
    ext = dict(h0=st.STEP_H0, match_sc=1, mismatch_sc=-4, n_sc=-1,
               **st.STEP_SCORING)

    def put(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    def no_rows():
        return torch.zeros(fmd.fused.shape[0], dtype=torch.bool, device=dev)

    def same(got, want, what):
        for a, b in zip(got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"{what} differs from its twin "
                                     f"(max abs err {_max_abs_err(a, b)})")

    res = {}
    # K7 on the edges, on the reads as they are (the suffix form masks in
    # the kernel): Ns at the first base, the last, mid-read and in the seed
    # suffix; lens 0, 1, under and at the seed length, L, and past L + 31;
    # both rules, both forms, int32 and int64; its occ1 entry on rows
    # around primary
    rng = np.random.default_rng(31)
    er, el = reads_np[:4096].copy(), np.full(4096, L, np.int32)
    el[:64] = rng.integers(0, 40, 64)
    el[:8] = 0, 1, seed_len - 1, seed_len, L, L + 1, L + seed_len, L + 200
    rows = np.arange(64, 4096)
    er[rows[:512], 0] = 4
    er[rows[512:1024], el[rows[512:1024]] - 1] = 4
    er[rows[1024:1536], L // 2] = 4
    er[rows[1536:2048], L - 1 - rng.integers(1, seed_len, 512)] = 4
    es = np.maximum(el - seed_len, 0).astype(np.int32)
    p = fm.primary
    k1 = np.concatenate([np.arange(p - 300, p + 300), [-1, 0, fm.seq_len],
                         rng.integers(0, fm.seq_len, 60000)])
    c1 = rng.integers(0, 4, len(k1)).astype(np.int32)
    for f in (fmd, fmd64):
        for skip_n, start, mi in ((False, None, None), (True, es, seed_len),
                                  (True, None, None), (False, es, seed_len)):
            a = (put(er), put(el), None if start is None else put(start),
                 mi, skip_n)
            same(fm_batch.backward_search(f, *a),
                 fm_batch.backward_search_plain(f, *a),
                 f"K7 (skip_n {skip_n}, suffix {start is not None}, "
                 f"{f.idx_dtype})")
        kd = put(k1).to(f.idx_dtype)
        same([fm_batch.occ1_rank(f, kd, put(c1))],
             [fm_batch.occ1_batch(f, kd, put(c1))], "K7's occ1 entry")
    # K7 at the step's shape: the seed suffixes of the step's reads, read
    # in place, with its count of each read's rank steps
    rd, lens = put(reads_np), put(np.full(B, L, np.int32))
    s0 = torch.clamp(lens - seed_len, min=0)
    k7 = (fmd, rd, lens, s0, seed_len, True)
    t7 = no_rows()
    kk, ll = fm_batch.backward_search_plain(*k7, touched=t7)
    chain = torch.full((B,), -1, dtype=torch.int32, device=dev)
    got = fm_batch.backward_search(*k7, steps=chain)
    same(got, (kk, ll), "K7 at the step's shape")
    ms7 = _median_ms(lambda: fm_batch.backward_search(*k7))
    dev7 = events_ms(lambda: fm_batch.backward_search(*k7))
    longest = int(chain.max())
    # the bytes it must move: each read's seed bases, start and lens, the
    # distinct fused rows its ranks read, the intervals out
    res["exact_match"] = (0, ms7, _median_ms(
        lambda: fm_batch.backward_search_plain(*k7), n=3), (B, L, seed_len),
        *_bound(pk, 0, 48 * int(t7.sum()) + B * seed_len + _nbytes(
            lens, s0, *got)),
        {"rows_distinct": int(t7.sum()), "hits": int((kk <= ll).sum()),
         "dev_ms": dev7, "longest_chain": longest,
         "mean_chain": float(chain.float().mean()),
         "us_per_step": 1e3 * dev7 / max(longest, 1)})
    # K8 (off the steps' path; the port of fetch_window_batch): negative
    # starts, starts near and past l_pac, every offset
    n = fm.l_pac
    wl = L + window
    fs = np.concatenate([np.arange(-wl - 20, 20), np.arange(n - wl - 20,
                                                            n + 20),
                         np.arange(16) + 16 * rng.integers(0, n // 16, 1),
                         rng.integers(-wl, n, 8000)])
    for gg in genomes.values():
        sd = put(fs, np.int64)
        same([st.fetch_window_batch(gg, sd, wl)],
             [st.fetch_window_batch_plain(gg, sd, wl)], "K8")
    # K5's lookup entry on the step's rows (the suffix hits' first rows,
    # row 0 elsewhere) and LF's edge rows, against the twin and the host
    # lookup
    rows5 = torch.where(kk <= ll, kk, 0).cpu().numpy().astype(np.int64)
    rows5[:6] = [0, p, p - 1, p + 1, fm.seq_len, fm.seq_len - 1]
    for gg in genomes.values():
        kd = put(rows5).to(gg.fmd.idx_dtype)
        got = st.sa_lookup_batch(gg, kd)
        same([got], [st.sa_lookup_batch_plain(gg, kd)], "K5's lookup entry")
        if not np.array_equal(got.cpu().numpy(),
                              st.sa_lookup_batch_host(gg, fm, rows5)):
            raise AssertionError("K5's lookup entry differs from "
                                 "sa_lookup_batch_host")
    kd = put(rows5).to(fmd.idx_dtype)
    t5 = no_rows()
    st.sa_lookup_batch_plain(g, kd, touched=t5)
    pos_fmd = st.sa_lookup_batch(g, kd)
    res["sa_lookup"] = {
        "ms": _median_ms(lambda: st.sa_lookup_batch(g, kd)),
        "plain_ms": _median_ms(lambda: st.sa_lookup_batch_plain(g, kd), n=3),
        "rows": B, "rows_distinct": int(t5.sum())}
    bms, by = _bound(pk, 0, 48 * int(t5.sum()) + 8 * B
                     + _nbytes(kd, pos_fmd))
    res["sa_lookup"].update(bound_ms=bms, bound_by=by)
    # K8 at the step's shape: the step's own windows (the lookup's hits,
    # forward-projected)
    isr, fwd = st.forward_start(g, pos_fmd, s0, lens)
    got = st.fetch_window_batch(g, fwd, wl)
    same([got], [st.fetch_window_batch_plain(g, fwd, wl)], "K8 at the step")
    pos = fwd.cpu().numpy()[:, None] + np.arange(wl)[None, :]
    words = np.unique(pos[(pos >= 0) & (pos < n)] >> 4)
    res["fetch_window"] = (0, _median_ms(lambda: st.fetch_window_batch(
        g, fwd, wl)), _median_ms(lambda: st.fetch_window_batch_plain(
            g, fwd, wl), n=3), (B, wl),
        *_bound(pk, 0, 4 * len(words) + _nbytes(fwd, got)),
        {"pac_words_distinct": int(len(words)), "step_launches": 0})
    # K1's step entry on the edges (reverse hits, windows across 0 and
    # l_pac, unmapped lanes at -1 - qb, Ns, short reads), then at the
    # step's shape against the twin and against the path it replaces (K8,
    # the orientation, the tile entry), with its bound
    pac = g.pac()
    ef = rng.integers(0, n - L, 4096).astype(np.int64)
    ef[:8] = [-20, -5, -wl - 3, 0, n - L, n - L + 10, n - 3, n + 5]
    ef[8:12] = -1 - np.array([0, 5, 58, 118])
    eisr = put(rng.random(4096) < 0.5)
    for gg in genomes.values():
        a = (put(er), put(np.minimum(el, L)), put(ef), eisr, gg.pac(),
             gg.l_pac, window)
        same([sw_extend.extend_step(*a, **ext)],
             [sw_extend.extend_step_plain(*a, **ext)],
             f"K1's step entry on the edges ({gg.fmd.idx_dtype})")
    sa = (rd, lens, fwd, isr, pac, n, window)
    want = sw_extend.extend_step_plain(*sa, **ext)
    same([sw_extend.extend_step(*sa, **ext)], [want],
         "K1's step entry at the step")
    tgt = st.fetch_window_batch(g, fwd, wl)
    qry = sw_extend.orient_reads(rd, lens, isr)
    full = [torch.full((B,), v, dtype=torch.int32, device=dev)
            for v in (wl, window, st.STEP_H0)]
    tiles = dict((k, v) for k, v in ext.items() if k != "h0")

    def k8_orient_tiles():
        t = st.fetch_window_batch(g, fwd, wl)
        q = sw_extend.orient_reads(rd, lens, isr)
        return sw_extend.extend_batch(q, lens, t, *full, **tiles)

    same([k8_orient_tiles()], [want], "K8 + orientation + the tile entry")
    _, rows_run = sw_batch.extend_batch(
        qry, lens, tgt, full[0], sw_extend.score_matrix(1, -4, -1, dev),
        full[1], full[2], packed=True, rows_run=True, **st.STEP_SCORING)
    rows_np = rows_run.cpu().numpy()
    w_eff = sw_batch._adjust_w(lens.cpu(), full[1].cpu(), 1, 5, 6, 1, 6,
                               1).numpy()
    cells = _band_cells(np.full(B, L), rows_np, w_eff)
    step_bytes = (B * L + _nbytes(lens, fwd, isr, want) + 4 * len(words))
    sbms, sby = _bound(pk, OPS_PER_CELL["extend"] * cells, step_bytes)
    step = {"ms": _median_ms(lambda: sw_extend.extend_step(*sa, **ext)),
            "dev_ms": events_ms(lambda: sw_extend.extend_step(*sa, **ext)),
            "k8_orient_tiles_dev_ms": events_ms(k8_orient_tiles),
            "plain_ms": _median_ms(
                lambda: sw_extend.extend_step_plain(*sa, **ext), n=3),
            "k8_orient_tiles_ms": _median_ms(k8_orient_tiles),
            "tiles_ms": _median_ms(lambda: sw_extend.extend_batch(
                qry, lens, tgt, *full, **tiles)),
            "bound_ms": sbms, "bound_by": sby, "rows_run": int(rows_np.sum()),
            "band_cells": cells,
            "warp_steps": _k1_steps(lambda s: sw_extend.extend_step(
                *sa, steps=s, **ext), want, B)}
    for name in ("exact_match", "fetch_window"):
        e, ms, pms, shape, bms, by, info = res[name]
        print(f"  {name} {shape}: exact in int32 and int64; kernel "
              f"{ms:.3f} ms, plain {pms:.3f} ms; bound {bms:.4f} ms ({by}), "
              f"{100 * bms / ms:.1f}% of it; {json.dumps(info)}")
    print(f"  K1 step entry ({B} x {L}, window {wl}): exact on the edges and "
          f"at the step, equal to K8 + orientation + the tile entry; "
          f"{json.dumps(step)}")
    print(f"  K5 lookup entry ({B} rows): exact in int32 and int64, equal to "
          f"sa_lookup_batch_host; {json.dumps(res['sa_lookup'])}")
    _past_2_31(put, same)

    # the align steps at 8,192 x 151: the kernels' run counted
    steps = (st.align_step_smem, st.align_step)
    _build.reset_launches()
    runs = [fn(g, rd, lens, mat) for fn in steps]
    torch.cuda.synchronize()
    launches = _build.launches()
    entries = _build.entry_launches()
    for gg in genomes.values():
        for fn, got in zip(steps, runs if gg is g else
                           [fn(gg, rd, lens, mat) for fn in steps]):
            want = fn(gg, rd, lens, mat, plain=True)
            same(got, want, f"{fn.__name__} ({gg.fmd.idx_dtype})")
    # every extension through the step entry: no window fetch (K8) and no
    # oriented copy; the seed mask is K7's own
    want_on = {"smem_exhaustive": 1, "sa_walk": 2, "fetch_window": 0,
               "sw_extend": 2, "exact_match": 1}
    if any(launches[k] != v for k, v in want_on.items()) or \
            entries["lariat_sa_lookup"] != 2 or \
            entries["lariat_sw_extend_step"] != 2:
        raise AssertionError(f"the align steps' launches: {launches}, "
                             f"{entries}")
    for fn, r in zip(steps, runs):
        mapped = r.mapped.cpu().numpy()
        at = (r.pos.cpu().numpy() == starts) & mapped
        print(f"  {fn.__name__} ({B} x {L}): every field equal to the twins' "
              f"in int32 and int64; mapped {mapped.mean():.4f}, at the "
              f"planted start {at.mean():.4f}")
    print(f"  align step launches: {json.dumps(launches)}; entries "
          f"{json.dumps(entries)}")
    out = _last_json(
        _run([sys.executable, "-m", "lariat_tpu_torch.tools.device_step",
              fasta], timeout=600, log=os.path.join(logs, "device_step.log")),
        ("device", "card", "B", "L", "device_step_pairs_s", "device_step_ms",
         "device_step_mapped_frac", "device_step_parts_ms",
         "exact_step_pairs_s", "exact_step_ms", "exact_step_mapped_frac",
         "exact_step_parts_ms", "launches"), "device_step")
    if not (out["B"] == B and out["device_step_pairs_s"] > 0
            and out["device_step_mapped_frac"] > 0.9):
        raise AssertionError(f"device_step: {out}")
    print(f"  device_step: {json.dumps(out)}")
    res["sa_lookup"]["step_launches"] = entries["lariat_sa_lookup"]
    step["step_launches"] = entries["lariat_sw_extend_step"]
    return res, step, launches


# the synthetic tables past 2^31: a text of 2.4e9 codes (a multiple of
# 128), its primary row past 2^31
BIG_SEQ_LEN, BIG_PRIMARY = 2_400_000_000, 2_200_000_017


def _past_2_31(put, same):
    """K7 (both entries), K8 and K1's step entry against their twins at
    positions and rows on both sides of 2^31, int64 indices: a valid rank
    table of a random text of 2.4e9 codes made on the card (checkpoints the
    running counts of its words; about 0.9 GB) and a random 2-bit pac of
    as many bases (about 600 MB). The text's second half is the complement
    of its first, so each code is as frequent as its complement, as in a
    doubled text: a bidirectional interval then stays inside the table.
    Then the seeding kernels, K9 and K1's descriptor entry on the same
    tables (``_seeding_past_2_31``)."""
    import numpy as np
    import torch
    from lariat_tpu_torch.ops import fm_batch, resident, sw_extend
    from lariat_tpu_torch.parallel import align_step as st
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(41)
    n, nb, two31 = BIG_SEQ_LEN, BIG_SEQ_LEN // 128, 1 << 31
    w = torch.randint(0, 1 << 32, (nb, 8), generator=gen, device=dev)
    w[nb // 2:] = w[:nb // 2] ^ ((1 << 32) - 1)
    counts = torch.stack([fm_batch._popcount32(fm_batch._match(w, c)).sum(1)
                          for c in range(4)], dim=1)
    ckpt = torch.zeros((nb + 1, 4), dtype=torch.int64, device=dev)
    ckpt[1:] = counts.cumsum(0)
    fused = torch.zeros((nb + 1, 12), dtype=torch.int32, device=dev)
    fused[:, :4] = ckpt.to(torch.int32)
    fused[:nb, 4:] = (w - (w >> 31) * (1 << 32)).to(torch.int32)
    del w, counts
    L2 = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                    ckpt[-1].cumsum(0)])
    big = fm_batch.DeviceFMIndex(fused, L2, BIG_PRIMARY, n)
    rng = np.random.default_rng(43)
    B, L = 4096, STEP_L
    reads = rng.integers(0, 4, (B, L)).astype(np.uint8)
    reads[rng.random((B, L)) < 0.01] = 4
    lens = np.full(B, L, np.int32)
    lens[:64] = rng.integers(0, L + 40, 64)
    start = np.maximum(lens - 32, 0).astype(np.int32)
    touched = torch.zeros(nb + 1, dtype=torch.bool, device=dev)
    for skip_n, s, mi in ((True, start, 32), (False, start, 32),
                          (False, None, None)):
        a = (put(reads), put(lens), None if s is None else put(s), mi, skip_n)
        same(fm_batch.backward_search(big, *a),
             fm_batch.backward_search_plain(big, *a, touched=touched),
             f"K7 past 2^31 (skip_n {skip_n}, suffix {s is not None})")
    lo, hi = int(touched[:two31 >> 7].sum()), int(touched[two31 >> 7:].sum())
    k = np.concatenate([np.arange(two31 - 300, two31 + 300),
                        np.arange(BIG_PRIMARY - 200, BIG_PRIMARY + 200),
                        [-1, 0, n - 1, n], rng.integers(0, n + 1, 20000)])
    kd = put(k).to(torch.int64)
    cd = put(rng.integers(0, 4, len(k)), np.int32)
    same([fm_batch.occ1_rank(big, kd, cd)],
         [fm_batch.occ1_batch(big, kd, cd)], "K7's occ1 entry past 2^31")
    pac = torch.randint(0, 1 << 32, (n // 16,), generator=gen, device=dev)
    pac = (pac - (pac >> 31) * (1 << 32)).to(torch.int32)
    g = st.DeviceGenome(fmd=big, sa_intv=32, l_pac=n, pac_words=pac)
    wl = L + 32
    fs = np.concatenate([np.arange(two31 - wl - 20, two31 + 20),
                         np.arange(n - wl - 20, n + 20),
                         rng.integers(-wl, n, 4000)])
    sd = put(fs, np.int64)
    same([st.fetch_window_batch(g, sd, wl)],
         [st.fetch_window_batch_plain(g, sd, wl)], "K8 past 2^31")
    # the step entry on reads planted at their windows, both strands
    fwd = sd[:2048]
    isr = put(np.arange(2048) % 2 == 1)
    sl = put(np.full(2048, L, np.int32))
    win = resident.fetch_forward_batch(pac, n, fwd, L).to(torch.uint8)
    rd = sw_extend.orient_reads(win, sl, isr)
    ext = dict(h0=st.STEP_H0, match_sc=1, mismatch_sc=-4, n_sc=-1,
               **st.STEP_SCORING)
    a = (rd, sl, fwd, isr, pac, n, 32)
    got = sw_extend.extend_step(*a, **ext)
    same([got], [sw_extend.extend_step_plain(*a, **ext)],
         "K1's step entry past 2^31")
    full = int((got[0] >= L).sum())
    print(f"  past 2^31 (int64; text and pac of {n} bases, primary "
          f"{BIG_PRIMARY}): K7 both rules and forms equal to the twin over "
          f"{lo} fused rows below 2^31 and {hi} above, its occ1 entry on "
          f"{len(k)} rows, K8 on {len(fs)} windows, the step entry on 2048 "
          f"planted reads ({full} scored the whole read)")
    if not (lo and hi and full):
        raise AssertionError("the checks past 2^31 missed a side of it")
    sides = _seeding_past_2_31(big, g, pac, put, same)
    print(f"  past 2^31, [below, above] 2^31 on each kernel's side: fused "
          f"rows its twin read (K4a-K4c, K5), kept x0 values (K9), target "
          f"positions (K1's descriptor entry): {json.dumps(sides)}")
    if not all(lo and hi for lo, hi in sides.values()):
        raise AssertionError(f"a kernel past 2^31 touched one side: {sides}")
    del g, big, fused, pac
    torch.cuda.empty_cache()


def _seeding_past_2_31(big, g, pac, put, same):
    """On ``_past_2_31``'s tables (int64 indices), against their twins:
    K4a's slots entry and planes entry at round 1 (start 0, mid L + 2) and
    round 2 (bwd_init, mids inside the reads) on 4,096 random reads x L
    192 with 1% N; K9 in both layouts on those planes (min_seed 0; the
    rounds' caps, then 1 and L in turn); K4b on every (read, e) lane of
    512 of the reads; K4c; K5's walk from rows around 2^31, around the
    primary row and at random; K1's descriptor entry on 4,096 extensions
    (both directions) whose target windows straddle 2^31 or l_pac, the
    seam of the doubled text, their queries planted from the windows.
    Returns
    {kernel: [below, above]}: the fused rows its twin read below and
    above position 2^31, K9's kept x0 values and K1's target positions."""
    import numpy as np
    import torch
    from lariat_tpu_torch.ops import resident, smem_device as sd
    from lariat_tpu_torch.ops import sw_batch, sw_extend
    from lariat_tpu_torch.parallel import align_step as st
    dev = big.fused.device
    n, two31 = big.seq_len, 1 << 31
    cut = two31 >> 7                 # the first fused row past 2^31
    rng = np.random.default_rng(47)
    R, L, min_seed = 4096, 192, 19
    reads = rng.integers(0, 4, (R, L)).astype(np.uint8)
    reads[rng.random((R, L)) < 0.01] = 4
    lens = rng.integers(100, L + 1, R).astype(np.int32)
    lens[:3] = 0, 1, L
    reads[np.arange(L)[None, :] >= lens[:, None]] = 4
    rd, ld = put(reads), put(lens)
    sides = {}

    def rows():
        return torch.zeros(big.fused.shape[0], dtype=torch.bool, device=dev)

    def count(name, touched):
        sides[name] = [int(touched[:cut].sum()), int(touched[cut:].sum())]

    mid2 = rng.integers(0, np.maximum(lens, 1)).astype(np.int32)
    rounds = {"round 1": (put(np.zeros(R), np.int32), put(np.ones(R),
                                                           np.int64),
                          put(np.full(R, L + 2), np.int32), 8 * L, False,
                          sd.CAP1),
              "round 2": (put(mid2), put(rng.integers(1, 6, R), np.int64),
                          put(mid2), 4 * L, True, sd.CAP2)}
    t_slots, t_planes, kept = rows(), rows(), []
    for name, (se, mi, md, steps, bwd, cap) in rounds.items():
        budget = sd._budget(steps)
        got = sd.min_starts_twoptr(big, rd, se, ld, mi, L, max_steps=steps,
                                   min_seed=min_seed, cap=cap, mid=md,
                                   bwd_init=bwd)
        want = sd.min_starts_twoptr_plain(big, rd, se, ld, mi, md, L, budget,
                                          bwd, min_seed, cap, t_slots)
        sd._twoptr_flags(want[0], want[2], cap)
        same(got, want, f"K4a's slots entry past 2^31 ({name})")
        pl = sd.min_starts_twoptr_planes(big, rd, se, ld, mi, L,
                                         max_steps=steps, bwd_init=bwd)
        same(pl[:5] + pl[6:], sd.min_starts_twoptr_plain(
            big, rd, se, ld, mi, None, L, budget, bwd, 0, 0, t_planes,
            planes=True), f"K4a's planes entry past 2^31 ({name})")
        # min_seed 0: random reads hold few SMEMs of 19 bases
        a = (*pl[:5], se, ld, md)
        for cp in (cap, 1, L):
            got = sd.compact_starts(*a, 0, cp)
            same(got, sd.compact_starts_plain(*a, 0, cp),
                 f"K9 past 2^31 ({name}, cap {cp})")
            same([sd.compact_starts_packed(*a, pl[5], 0, cp)],
                 [sd.compact_starts_packed_plain(*a, pl[5], 0, cp)],
                 f"K9's packed layout past 2^31 ({name}, cap {cp})")
        filled = torch.arange(L, device=dev)[None, :] < got[5][:, None]
        kept.append(got[2][filled])
    count("smem_twoptr", t_slots)
    count("smem_planes", t_planes)
    x0 = torch.cat(kept)
    sides["compact"] = [int((x0 < two31).sum()), int((x0 >= two31).sum())]
    # K4b over every (read, e) lane of the first 512 reads
    ri = put(np.repeat(np.arange(512), L), np.int32)
    ee = put(np.tile(np.arange(1, L + 1), 512), np.int32)
    mi = put(np.ones(512 * L), np.int64)
    t4b = rows()
    same(sd.min_starts_kernel(big, rd, ri, ee, mi, L),
         sd.min_starts_kernel_plain(big, rd, ri, ee, mi, L, t4b),
         "K4b past 2^31")
    count("smem_exhaustive", t4b)
    t4c = rows()
    s1 = (big, rd, ld, 20, L, min_seed, L // min_seed + 2)
    same(sd.strategy1(*s1), sd.pack_r3(*sd.strategy1_plain(*s1, t4c)),
         "K4c past 2^31")
    count("smem_strategy1", t4c)
    # K5's walk at the lookup's budget
    p = big.primary
    k = np.concatenate([np.arange(two31 - 2000, two31 + 2000),
                        np.arange(p - 2000, p + 2000), [0, n - 1, n],
                        rng.integers(0, n + 1, 8000)])
    kd = put(k, np.int64)
    z = torch.zeros_like(kd)
    t5 = rows()
    same([st.sa_walk_chunk(g, kd, z, z.bool(), st.LOOKUP_STEPS)],
         [st.sa_walk_chunk_plain(g, kd, z, z.bool(), st.LOOKUP_STEPS, t5)],
         "K5's walk past 2^31")
    count("sa_walk", t5)
    # K1's descriptor entry: right extensions start below a seam and run
    # across it, left ones start above it and run back across it
    B, Lq, Lt, ql = 4096, 192, 256, 151
    seam = np.where(np.arange(B) < B // 2, two31, n)
    right = rng.random(B) < 0.5
    tdir = np.where(right, 1, -1)
    tstart = seam + np.where(right, -rng.integers(1, 150, B),
                             rng.integers(0, 150, B))
    tlen = np.minimum(ql + rng.integers(0, 100, B), Lt)
    codes = resident.fetch_fmd_batch(pac, n, put(tstart, np.int64),
                                     put(tdir, np.int64), ql).cpu().numpy()
    qr = np.where(right[:, None], codes, codes[:, ::-1]).astype(np.uint8)
    mut = rng.random(qr.shape) < 0.02
    qr[mut] = (qr[mut] + 1) % 4
    qr[rng.random(qr.shape) < 0.01] = 4
    qm = np.full((B, Lq), 4, np.uint8)
    qm[:, :ql] = qr
    h0 = rng.integers(19, 152, B)
    w = np.where(rng.random(B) < 0.8, 100, rng.integers(0, 100, B))
    desc = resident.pack_desc(np.arange(B), np.where(right, 0, ql - 1),
                              tdir, np.full(B, ql), tstart, tdir, tlen, h0,
                              w, n)
    rdq, dd = put(qm), put(desc)
    got = sw_extend.extend_desc(rdq, pac, n, dd, Lq, Lt)
    q, t = resident.build_qt(rdq, pac, n, dd, Lq, Lt)
    cols = [dd[:, c].to(torch.int32).contiguous() for c in (
        resident.D_QL, resident.D_TL, resident.D_W, resident.D_H0)]
    want = sw_batch.extend_batch(q, cols[0], t, cols[1],
                                 sw_extend.score_matrix(1, -4, -1, dev),
                                 cols[2], cols[3], packed=True)
    same([got[:6], got[6:]], [want, torch.zeros_like(got[6:])],
         "K1's descriptor entry past 2^31")
    pos = tstart[:, None] + np.arange(Lt)[None, :] * tdir[:, None]
    pos = pos[np.arange(Lt)[None, :] < tlen[:, None]]
    sides["sw_extend"] = [int((pos < two31).sum()), int((pos >= two31).sum())]
    gained = int((got[0] > torch.from_numpy(h0).to(dev)).sum())
    print(f"  past 2^31, seeding: K4a (both entries, rounds 1 and 2), K9 "
          f"(both layouts, caps {sd.CAP1}/{sd.CAP2}, 1, L), K4b ({512 * L} "
          f"lanes), K4c, K5's walk ({len(k)} rows) and K1's descriptor "
          f"entry ({B} extensions across 2^31 and l_pac, {gained} gained on "
          f"h0, int64 descriptors) equal to their twins")
    if not gained:
        raise AssertionError("K1 past 2^31: no extension scored")
    return sides


def _bam_records(path: str):
    """(record bytes past the header, record count) of a BAM: BGZF is
    multi-member gzip, so the stdlib reads it."""
    import gzip
    import struct
    with gzip.open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"BAM\x01":
        raise AssertionError(f"{path}: not a BAM")
    (l_text,) = struct.unpack_from("<i", data, 4)
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 8 + l_name
    body = data[off:]
    n, pos = 0, 0
    while pos < len(body):
        pos += 4 + struct.unpack_from("<i", body, pos)[0]
        n += 1
    if pos != len(body):
        raise AssertionError(f"{path}: truncated record")
    return body, n


def _cli(module, mode, fasta, reads, out_dir, threads, log, env, extra=(),
         timeout=900, peak=None):
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.time()
    stdout = _run([sys.executable, "-m", module, "-reads", reads, "-genome",
                   fasta, "-output", out_dir, "-threads", str(threads),
                   "-use_device", mode, "-first_chunk", *extra],
                  timeout=timeout, log=log, env=env, peak=peak)
    return stdout, time.time() - t0


def _summary(stdout):
    m = re.search(r"Processed (\d+) read pairs across (\d+) barcodes in "
                  r"([\d.]+)s \(([\d.]+) pairs/s\)", stdout)
    if not m:
        raise AssertionError("no 'Processed' summary line")
    return int(m.group(1)), float(m.group(4))


def _last_json(stdout, keys, what):
    """The last JSON line of a tool's output, holding every key of
    ``keys``."""
    lines = [s for s in stdout.splitlines() if s.startswith("{")]
    if not lines:
        raise AssertionError(f"{what}: no JSON line")
    out = json.loads(lines[-1])
    missing = set(keys) - set(out)
    if missing:
        raise AssertionError(f"{what}: final JSON lacks {sorted(missing)}")
    return out


def _check_roofline(roof):
    """The kernel roofline's JSON line (run by the bench): every section,
    every share of a peak in (0, 100%], the seeding section's counts."""
    from lariat_tpu_torch.tools.kernel_roofline import shares
    missing = {"device", "card", "attributes", "peaks", "extend",
               "global_tb", "local_2pass", "smem_seed", "fm_rank",
               "launches"} - set(roof)
    if missing:
        raise AssertionError(f"kernel_roofline lacks {sorted(missing)}")
    sh = shares(roof)
    if len(sh) != 6 or not all(0 < v <= 100 for v in sh.values()):
        raise AssertionError(f"kernel_roofline shares: {sh}")
    print(f"  kernel_roofline peaks {json.dumps(roof['peaks'])}")
    for k in ("extend", "global_tb", "local_2pass", "smem_seed", "fm_rank"):
        print(f"  kernel_roofline {k}: {json.dumps(roof[k])}")
    seed = roof["smem_seed"]
    if not (seed.get("reads_per_s", 0) > 0
            and seed.get("rbegs_total", 0) >= seed.get("mems_total", 0) > 0):
        raise AssertionError(f"kernel_roofline smem_seed: {seed}")
    if not 0 < roof["fm_rank"].get("bound_ms", 0) < roof["fm_rank"]["ms"]:
        raise AssertionError(f"kernel_roofline fm_rank: {roof['fm_rank']}")


def phase_tools(fasta, reads, env, logs):
    """The T1 ablation and the priming profile, each a subprocess of its
    own (the roofline runs in the bench); returns the ablation tool's T1
    launch count."""
    from lariat_tpu_torch.ops import extend_ablate

    def tool(name, *args, log=None, **extra_env):
        return _run([sys.executable, "-m", f"lariat_tpu_torch.tools.{name}",
                     *args], timeout=600,
                    log=os.path.join(logs, f"{log or name}.log"),
                    env={**env, **extra_env})

    out = tool("extend_ablate")
    lines = [json.loads(s) for s in out.splitlines() if s.startswith("{")]
    names = [x.get("variant") for x in lines[:-1]]
    if names != list(extend_ablate.VARIANTS):
        raise AssertionError(f"extend_ablate: variants {names}")
    for x in lines[:-1]:
        if not (x.get("ms", 0) > 0 and x.get("padded_cells_per_s", 0) > 0
                and x.get("warp_steps", 0) > 0
                and x.get("ns_per_warp_step", 0) > 0):
            raise AssertionError(f"extend_ablate: bad line {x}")
        print(f"  extend_ablate {x['variant']} (Lt {x['Lt']}): "
              f"{x['ms']:.3f} ms, {x['padded_cells_per_s']:.4g} padded "
              f"cells/s, {x['warp_steps']} warp steps, "
              f"{x['ns_per_warp_step']:.1f} ns a warp step")
    fin = _last_json(out, ("device", "card", "B", "Lq", "Lt", "timing",
                           "launches"), "extend_ablate")
    t1_launches = int(fin["launches"].get("extend_ablate", 0))
    print(f"  extend_ablate on {fin['card']}: {t1_launches} T1 launches")

    # the same 2,000 pairs seeded by host C++ and on the device
    for flag, seeder in (("0", "host"), ("1", "device")):
        prof = _last_json(
            tool("prime_profile", fasta, reads, str(PROFILE_PAIRS),
                 log=f"prime_profile_{seeder}", LARIAT_DEVICE_SEED=flag),
            ("device", "card", "pairs", "seeder", "index_upload_s", "seed_s",
             "seed_warm_s", "align_s", "rescue_s", "total_s", "pairs_per_s",
             "seed_profile", "prime_s", "prime_pairs_per_s", "extend_waves",
             "rescue_waves", "wave_wall_s", "launches"),
            "prime_profile")
        if not (prof["pairs"] == PROFILE_PAIRS and prof["seeder"] == seeder
                and prof["extend_waves"] > 0 and prof["rescue_waves"] > 0
                and (prof["seed_profile"] is not None) == (seeder == "device")
                and prof["prime_pairs_per_s"] > 0):
            raise AssertionError(f"prime_profile: {prof}")
        print(f"  prime_profile ({seeder} seeding): {json.dumps(prof)}")
    return t1_launches


def _port_run(fasta, reads, out, log, env, extra=(), info=None,
              timeout=900, mode="on"):
    """One port CLI run (``-use_device mode``): (pairs, pairs/s, primed,
    host pairs, the run's kernel launch counts); ``info``, when given, gets
    its busy fraction, index load s, device path line (``path_log``), wall
    s, peak RSS (``rss_gib``) and stdout."""
    peak = {} if info is not None else None
    stdout, wall = _cli("lariat_tpu_torch.cli", mode, fasta, reads,
                        os.path.join(SMOKE, out), THREADS, log, env, extra,
                        timeout, peak)
    n, rate = _summary(stdout)
    m = re.search(r"device waves: (\d+)\s+wave wall ([\d.]+)s\s+busy "
                  r"fraction ([\d.]+)\s+primed pairs (\d+)\s+host pairs "
                  r"(\d+)", stdout)
    if not m:
        raise AssertionError(f"no device summary line in {out}")
    lm = re.search(r"kernel launches: (\{.*\})", stdout)
    if not lm:
        raise AssertionError(f"no kernel launch line in {out}")
    launches = json.loads(lm.group(1))
    em = re.search(r"kernel entry launches: (\{.*\})", stdout)
    if not em:
        raise AssertionError(f"no kernel entry launch line in {out}")
    launches["entries"] = json.loads(em.group(1))
    wm = re.search(r"sa walks: (\[.*\])", stdout)
    if not wm:
        raise AssertionError(f"no SA walk line in {out}")
    launches["walks"] = json.loads(wm.group(1))
    dev_line = re.search(r"device priming on (.*)", stdout)
    print(f"  {out}: {n} pairs, {rate} pairs/s ({wall:.1f}s wall with index "
          f"load); device waves {m.group(1)}, busy fraction {m.group(3)}; "
          f"primed {m.group(4)}, host {m.group(5)}; "
          f"{dev_line.group(1) if dev_line else '?'}")
    print(f"  kernel launches in {out}: "
          f"{json.dumps({k: v for k, v in launches.items() if k != 'walks'})}")
    if info is not None:
        pm = re.search(r"device path: (\{.*\})", stdout)
        if not pm:
            raise AssertionError(f"no device path line in {out}")
        info.update(busy=float(m.group(3)), load_s=_index_load_s(stdout),
                    path=json.loads(pm.group(1)), wall=wall,
                    stdout=stdout, **peak)
    return n, rate, int(m.group(4)), int(m.group(5)), launches


def _index_load_s(stdout) -> float:
    """The CLI's index load seconds (mmap, codes cache, native hot)."""
    m = re.search(r"index load: ([\d.]+)s", stdout)
    if not m:
        raise AssertionError("no 'index load' line")
    return float(m.group(1))


_SERVER_SETUP = re.compile(r"\[device_server\] set-up: imports ([\d.]+)s, "
                           r"load ([\d.]+)s .*upload ([\d.]+)s")


def _server_run(fasta, reads, env, logs, out="out_port_server", extra=(),
                info=None, timeout=900, mode="on", ready_timeout=300):
    """The port's CLI (``-use_device mode``) through a resident server on
    the card: the server starts as a subprocess, loads, uploads and
    prewarms, and writes its ready file within ``ready_timeout`` s; the CLI
    primes through it (LARIAT_DEVICE_SOCKET) and never initialises CUDA;
    then ``stop``, and the server must exit 0 with its kernel launches in
    its log. Returns _port_run's tuple, the launches being the server's;
    ``info`` as _port_run's, its device path the server's, plus the
    server's peak RSS (``server_rss_gib``, through ``_PEAK_WRAP``) and its
    set-up (``server_setup``: ready, imports, load, upload and prewarm
    s)."""
    from lariat_tpu_torch.parallel.device_server import stop_server
    sock = os.path.join(SMOKE, "srv.sock")
    ready = os.path.join(SMOKE, "srv.ready")
    for f in (sock, ready):
        if os.path.exists(f):
            os.remove(f)
    log_path = os.path.join(logs, "server.log" if out == "out_port_server"
                            else f"{out[4:]}_server.log")
    wrap = [sys.executable, "-c", _PEAK_WRAP] if info is not None else []
    t0 = time.time()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [*wrap, sys.executable, "-m",
             "lariat_tpu_torch.parallel.device_server", "-genome", fasta,
             "-socket", sock, "-ready_file", ready, "-idle_timeout", "600"],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True)
    try:
        while not os.path.exists(ready):
            if proc.poll() is not None or time.time() - t0 > ready_timeout:
                raise RuntimeError(f"the server never became ready "
                                   f"(exit {proc.poll()})")
            time.sleep(0.2)
        ready_s = time.time() - t0
        peak = {} if info is not None else None
        stdout, wall = _cli("lariat_tpu_torch.cli", mode, fasta, reads,
                            os.path.join(SMOKE, out), THREADS,
                            os.path.join(logs, f"{out[4:]}.log"),
                            {**env, "LARIAT_DEVICE_SOCKET": sock}, extra,
                            timeout, peak)
        stop_server(sock)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)    # the wrapper and the server
            proc.wait()
    if rc != 0:
        raise AssertionError(f"the server exited {rc}")
    if f"device priming via server ({sock}" not in stdout:
        raise AssertionError("the CLI did not prime through the server")
    if "cuda initialized in the CLI process: False" not in stdout:
        raise AssertionError("the CLI initialised CUDA beside the server")
    n, rate = _summary(stdout)
    m = re.search(r"primed pairs (\d+)\s+host pairs (\d+)", stdout)
    with open(log_path) as f:
        slog = f.read()
    lm = re.search(r"kernel launches: (\{.*\})", slog)
    em = re.search(r"kernel entry launches: (\{.*\})", slog)
    pm = re.search(r"prewarm ([\d.]+)s", slog)
    if not (m and lm and em and pm):
        raise AssertionError("no priming split, prewarm or launch line")
    launches = json.loads(lm.group(1))
    launches["entries"] = json.loads(em.group(1))
    launches["walks"] = []
    sm = _SERVER_SETUP.search(slog)
    if not sm:
        raise AssertionError("no load and upload line in the server's log")
    setup = {"ready_s": round(ready_s, 3), "imports_s": float(sm.group(1)),
             "load_s": float(sm.group(2)), "upload_s": float(sm.group(3)),
             "prewarm_s": float(pm.group(1))}
    if info is not None:
        pm2 = re.search(r"device path: (\{.*\})", slog)
        rss = re.search(r"peak rss KiB (\d+)\s*$", slog)
        if not (pm2 and rss):
            raise AssertionError("no device path or peak RSS line in the "
                                 "server's log")
        info.update(busy=None, load_s=_index_load_s(stdout),
                    path=json.loads(pm2.group(1)), wall=wall, stdout=stdout,
                    server_rss_gib=int(rss.group(1)) / 2**20,
                    server_setup=setup, **peak)
    print(f"  {out}: {n} pairs, {rate} pairs/s ({wall:.1f}s wall "
          f"with index load); server ready after {ready_s:.1f}s (imports "
          f"{setup['imports_s']}s, load {setup['load_s']}s, upload "
          f"{setup['upload_s']}s, prewarm {setup['prewarm_s']}s; the rest "
          f"the interpreter's start and the listen); primed {m.group(1)}, "
          f"host "
          f"{m.group(2)}; the CLI never initialised CUDA")
    print(f"  kernel launches in the server: "
          f"{json.dumps({k: v for k, v in launches.items() if k != 'walks'})}")
    return n, rate, int(m.group(1)), int(m.group(2)), launches


def _cli_walks(walks, n_launches):
    """K5's launches in the device-seeded CLI run, one per SA lookup, as
    the CLI logged them: [rows (padded), max_steps, longest walk, walks
    past 64 steps] a launch, checked against the kernel's launch count."""
    if len(walks) != n_launches or any(w["max_steps"] != 512 for w in walks):
        raise AssertionError(f"K5: {n_launches} launches for {len(walks)} "
                             f"lookups")
    out = {"cli_launches": [[w["rows"], w["max_steps"], w["longest"],
                             w["past_64"]] for w in walks]}
    print(f"  K5 in the device-seeded run ([rows, max_steps, longest walk, "
          f"walks past 64] a launch): {json.dumps(out)}")
    return out


def _same_records(out, host="out_host") -> int:
    """The run ``out``'s BAMs hold the records of ``host``'s, file for
    file, byte for byte past the header; returns the record count."""
    names = sorted(os.path.basename(f) for f in glob.glob(
        os.path.join(SMOKE, host, "*.bam")))
    got_names = sorted(os.path.basename(f) for f in glob.glob(
        os.path.join(SMOKE, out, "*.bam")))
    if not names or names != got_names:
        raise AssertionError(f"BAM sets differ: {names} vs {got_names} "
                             f"({out})")
    n_rec = 0
    for name in names:
        a, n = _bam_records(os.path.join(SMOKE, host, name))
        b, _ = _bam_records(os.path.join(SMOKE, out, name))
        if a != b:
            raise AssertionError(f"{out}/{name}: records differ from "
                                 f"host-native")
        n_rec += n
    print(f"  {out}: {len(names)} BAMs, {n_rec} records byte-identical to "
          f"host-native ({host})")
    return n_rec


def phase_whole_bam(runs, host="out_host"):
    """Every BAM of each port run against host-native's (the run ``host``)
    as a whole file, CL normalised (io/bamcompare.py): the decompressed
    streams in full, every BGZF block past the header at the same stream
    range, the EOF block; each file's counts printed."""
    from lariat_tpu_torch.io.bamcompare import compare_bams
    names = sorted(os.path.basename(f) for f in glob.glob(
        os.path.join(SMOKE, host, "*.bam")))
    for run in runs:
        for name in names:
            rep = compare_bams(os.path.join(SMOKE, host, name),
                               os.path.join(SMOKE, run, name))
            print(f"  {run}/{name}: {rep['records']} records, "
                  f"{rep['stream_bytes']} stream bytes equal (CL "
                  f"normalised); {rep['blocks_compared']} of "
                  f"{rep['blocks']} BGZF blocks ({rep['bytes_compared']} "
                  f"bytes) equal byte for byte, {rep['header_blocks']} "
                  f"holding header bytes, {rep['shifted_blocks']} shifted "
                  f"by the CL's length")


def phase_bench(env, logs):
    """python -m lariat_tpu_torch.tools.bench in a subprocess: its JSON
    line, held to the port's bench contract; returns it."""
    # data_big/ is never generated here (hours at hg38 scale)
    out = _run([sys.executable, "-m", "lariat_tpu_torch.tools.bench"],
               timeout=700, log=os.path.join(logs, "bench.log"),
               env={**env, "LARIAT_BENCH_NO_GEN": "1"})
    res = _last_json(out, ("metric", "value", "unit", "vs_baseline",
                           "detail"), "bench")
    print(f"  bench result: {json.dumps(res)}")
    d = res["detail"]
    host, dev = d["cli_host_native_5w"], d["cli_device_primed_5w"]
    diff = d.get("device_vs_host_diff", {})
    step = d.get("device_step_launches", {})
    srv = dev.get("server_launches", {})
    bad = []
    if not ("pairs_s" in host and "pairs_s" in dev):
        bad.append("a mode has no pairs_s")
    if not dev.get("primed_pairs", 0) > 0:
        bad.append("the device median primed no pair")
    if diff.get("sam_diff_rate") != 0.0:
        bad.append(f"device vs host diff {diff}")
    if d.get("rfa_jit_probe", {}).get("rfa_rows") != "jit":
        bad.append(f"rfa probe {d.get('rfa_jit_probe')}")
    if not d.get("device_step_pairs_s", 0) > 0:
        bad.append(f"device step {d.get('device_step_error')}")
    if "roofline" not in d:
        bad.append(f"roofline {d.get('roofline_error')}")
    else:
        _check_roofline(d["roofline"])
    if not d.get("card"):
        bad.append("no card")
    skipped = "hg38 regime SKIPPED" in res["metric"]
    if skipped == os.path.isdir(os.path.join(REPO, "data_big")):
        bad.append(f"metric {res['metric']!r} with data_big/ "
                   f"{'present' if not skipped else 'absent'}")
    # K3 runs only where a mate rescue window survives, which the bench's
    # reads (all proper pairs) never give: its count is printed, not held
    idle = [k for k in ("sw_extend", "sw_global", "traceback")
            if srv.get(k, 0) <= 0]
    idle += [k for k in ("smem_exhaustive", "sa_walk", "sw_extend")
             if step.get(k, 0) <= 0]
    if idle:
        bad.append(f"kernels never launched on the bench's paths: {idle}")
    desc = dev.get("server_entry_launches", {}).get("lariat_sw_extend_desc")
    if desc != srv.get("sw_extend"):
        bad.append(f"{desc} of {srv.get('sw_extend')} K1 launches in the "
                   f"bench's server through the descriptor entry")
    if bad:
        raise AssertionError(f"bench: {bad}")
    print(f"  bench on {d['card']}: host-native {host['pairs_s']} pairs/s, "
          f"device-primed {dev['pairs_s']} pairs/s (primed "
          f"{dev['primed_pairs']}, host {dev['host_pairs']}); server "
          f"launches {json.dumps({k: srv[k] for k in CLI_KERNELS})}; device "
          f"step {d['device_step_pairs_s']:.1f} pairs/s")
    return res


def phase_probe_entry(env, logs):
    """python -m lariat_tpu_torch.tools.probe_device (its lines printed),
    then tools/entry.py's step on the card, its launches counted, every
    field against the same step on the CPU (the plain twins)."""
    import torch
    from lariat_tpu_torch.ops import _build
    from lariat_tpu_torch.tools.entry import entry
    out = _run([sys.executable, "-m", "lariat_tpu_torch.tools.probe_device"],
               timeout=600, log=os.path.join(logs, "probe_device.log"),
               env=env)
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    for x in lines:
        print(f"  probe {json.dumps(x)}")
    want = ["device", "launch_trivial", "download_8MB", "upload_8MB",
            "download_8MB", "upload_8MB", "k1_B128", "k1_B1024",
            "k1_plain_B1024", "k1_plain_B8192", "launches"]
    if [x["probe"] for x in lines] != want:
        raise AssertionError(f"probe_device: {[x['probe'] for x in lines]}")
    if lines[-1].get("sw_extend", 0) < 2 * 4:
        raise AssertionError(f"probe_device: K1 launches {lines[-1]}")
    fn, args = entry()
    torch.cuda.synchronize()
    _build.reset_launches()
    got = fn(*args)
    torch.cuda.synchronize()
    launches = _build.launches()
    entries = _build.entry_launches()
    cfn, cargs = entry("cpu")
    want = cfn(*cargs)
    for field in got._fields:
        a = getattr(got, field).cpu()
        b = getattr(want, field)
        if not torch.equal(a, b):
            raise AssertionError(f"entry(): {field} differs from the twins")
    idle = [k for k in ("smem_exhaustive", "sa_walk", "sw_extend")
            if launches.get(k, 0) <= 0]
    if idle:
        raise AssertionError(f"entry(): no launch of {idle}")
    print(f"  entry(): align_step_smem on 64 x 100 of a 20 kb index, every "
          f"field equal to the twins on the CPU ({int(got.mapped.sum())} "
          f"mapped); launches {json.dumps({k: v for k, v in launches.items() if v})}, "
          f"entries {json.dumps({k: v for k, v in entries.items() if v})}")


def phase_dryrun():
    """tools/entry.py's dryrun_multichip(4) on four distinct cards when
    there are four, else four shards on cuda:0: what it measured, its
    launches in each run checked."""
    import torch
    from lariat_tpu_torch.tools.entry import dryrun_multichip
    n = 4
    devices = (None if torch.cuda.device_count() >= n
               else ["cuda:0"] * n)
    res = dryrun_multichip(n, devices)
    single, split = res["launches_single"], res["launches_split"]
    print(f"  dryrun: {len(res['distinct'])} distinct cards "
          f"({', '.join(res['distinct'])}) for {n} shards; "
          f"{res['shard_waves']} split waves; {res['records']} records of "
          f"{res['barcodes']} barcodes bit-identical; real tasks a device "
          f"{res['per_dev_tasks']}; wall {res['wall_single_s']:.2f}s single, "
          f"{res['wall_split_s']:.2f}s split")
    print(f"  dryrun launches, single -> split: " + ", ".join(
        f"{k} {single.get(k, 0)} -> {split.get(k, 0)}" for k in CLI_KERNELS))
    idle = [k for k in ("sw_extend", "sw_global", "traceback")
            if split.get(k, 0) <= 0]
    if idle:
        raise AssertionError(f"the split dry run launched no {idle}")
    # each card of the split held its blocks' tensors: the peak of the
    # split run alone, above what the card held when it began
    peak = res["peak_split"]
    print(f"  dryrun split run's peak device memory by card, bytes above "
          f"its start: {json.dumps(peak)}")
    if set(peak) != set(res["distinct"]) or not all(
            v > 0 for v in peak.values()):
        raise AssertionError(f"a card of the split held nothing: {peak}")
    return res


def _fastq_records(reads):
    """(barcode, record text) of each 9-line record of a gzip FASTQ, in
    input order, the barcode from line 6; streamed."""
    import gzip
    with gzip.open(reads, "rt") as f:
        while True:
            rec = "".join(itertools.islice(f, 9))
            if not rec:
                return
            yield rec.split("\n", 6)[5].split(",")[0], rec


def _fastq_shards(reads, n, out_dir):
    """``reads`` cut into ``n`` barcode-complete gzip shards of whole
    barcodes in input order (a barcode group is a run of records with one
    barcode): [(path, pairs)]. Two streamed passes, one counting the groups
    and one writing them, so no more than a record is held at a time."""
    import gzip
    groups, last = 0, None
    for bc, _ in _fastq_records(reads):
        groups += bc != last
        last = bc
    per = -(-groups // n)
    paths = [os.path.join(out_dir, f"shard{h}.fastq.gz") for h in range(n)]
    pairs = [0] * n
    files = [gzip.open(p, "wt", compresslevel=1) for p in paths]
    try:
        g, last = -1, None
        for bc, rec in _fastq_records(reads):
            g += bc != last
            last = bc
            files[g // per].write(rec)
            pairs[g // per] += 1
    finally:
        for f in files:
            f.close()
    return list(zip(paths, pairs))


def _split_records(path: str) -> list:
    """The records of a BAM, each its bytes, in file order."""
    body, _ = _bam_records(path)
    out, off = [], 0
    while off < len(body):
        k = 4 + int.from_bytes(body[off:off + 4], "little")
        out.append(body[off:off + k])
        off += k
    return out


def _merge_matches(dirs, ref, merged, env):
    """The port's ``cat_bams --auto`` over the shard runs' output
    directories ``dirs`` into ``merged``; its position-bucketed records
    against those of the single run's directory ``ref`` as sorted lists,
    and the barcode-sorted records of ``dirs``, shard by shard, against
    ``ref``'s in order; raises on a difference. Returns the two record
    counts."""
    _run([sys.executable, "-m", "lariat_tpu_torch.tools.cat_bams", "-o",
          merged, "--auto", *dirs], timeout=600, env=env)
    got = sorted(_split_records(merged))
    want = sorted(r for path in sorted(glob.glob(os.path.join(
        ref, "*_pos_bucketed.bam"))) for r in _split_records(path))
    if got != want:
        raise AssertionError(f"merged records ({len(got)}) differ from "
                             f"the single run's ({len(want)})")
    bc = [r for d in dirs
          for r in _split_records(os.path.join(d, "bc_sorted_bam.bam"))]
    if bc != _split_records(os.path.join(ref, "bc_sorted_bam.bam")):
        raise AssertionError("barcode-sorted records differ from the "
                             "single run's")
    return len(got), len(bc)


# a [wtrace] line is one write, so another thread's print may end up on
# either side of it but never inside it
_WTRACE = re.compile(r"\[wtrace\] (\S+)\s+\([^)]*\)\s+build\s+(\d+)ms disp\s+"
                     r"(\d+)ms dl\s+(\d+)ms up\s+([\d.]+)MB dn\s+([\d.]+)MB\n")


def phase_multihost(fasta, reads, env, logs):
    """Four multihost processes on the card over barcode-complete shards of
    phase 4's reads, file:// rendezvous: each primes all its pairs, the
    global stats agree, and the merged records equal host-native's; each
    process's pairs/s and launches and the [wtrace] sums by site
    printed."""
    n = 4
    base = os.path.join(SMOKE, "multihost")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    shards = _fastq_shards(reads, n, base)
    knobs = {"LARIAT_PRIME_THREADS": "20", "LARIAT_PRIME_TAIL_GRACE": "600",
             "LARIAT_PRIME_MIN_FRAC": "0", "LARIAT_WAVE_TRACE": "1"}
    init = "file://" + os.path.join(base, "rendezvous")
    procs, paths = [], []
    try:
        for h, (shard, _) in enumerate(shards):
            paths.append(os.path.join(logs, f"multihost_{h}.log"))
            with open(paths[-1], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "lariat_tpu_torch.parallel.multihost", "-coordinator",
                     init, "-num_processes", str(n), "-process_id", str(h),
                     "-reads", shard, "-genome", fasta, "-output_base",
                     os.path.join(base, "out"), "-threads", "2",
                     "-use_device", "on", "-simulated"], cwd=REPO,
                    env={**env, **knobs},
                    stdout=log, stderr=subprocess.STDOUT))
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for h, path in enumerate(paths):
        with open(path) as f:
            outs.append(f.read())
        if rcs[h] != 0:
            raise AssertionError(f"multihost process {h} exited {rcs[h]}:\n"
                                 f"{outs[-1][-3000:]}")
    results, sums = [], {}
    for h, (out, (_, want)) in enumerate(zip(outs, shards)):
        res = _last_json(out, ("host", "rc", "output_dir", "local_stats",
                               "global_stats"), f"multihost {h}")
        n_pairs, rate = _summary(out)
        m = re.search(r"primed pairs (\d+)\s+host pairs (\d+)", out)
        lm = re.search(r"kernel launches: (\{.*\})", out)
        if not (m and lm):
            raise AssertionError(f"multihost {h}: no device summary")
        primed, host_pairs = int(m.group(1)), int(m.group(2))
        if not (n_pairs == primed == want and host_pairs == 0):
            raise AssertionError(f"multihost {h}: {n_pairs} pairs, {primed} "
                                 f"primed, {host_pairs} host-routed; want "
                                 f"{want} all primed")
        lines = list(_WTRACE.finditer(out))
        sites = [mt.group(1) for mt in lines]
        wm = re.search(r"device waves: (\d+)", out)
        # every wave the engine counts has its line (a reg2aln wave two)
        if not (lines and len(lines) == out.count("[wtrace]") and wm
                and sites.count("r2a.d") == sites.count("r2a.f")
                and len(lines) - sites.count("r2a.f") == int(wm.group(1))):
            raise AssertionError(f"multihost {h}: {len(lines)} [wtrace] "
                                 f"lines by site {sorted(set(sites))} for "
                                 f"{wm.group(1) if wm else '?'} waves")
        for mt in lines:
            site = sums.setdefault(mt.group(1), [0, 0, 0, 0, 0.0, 0.0, 0])
            ms = [int(mt.group(2 + k)) for k in range(3)]
            site[0] += 1
            for k in range(3):
                site[1 + k] += ms[k]
            site[4] += float(mt.group(5))
            site[5] += float(mt.group(6))
            site[6] = max(site[6], sum(ms))
        launches = json.loads(lm.group(1))
        print(f"  multihost process {h}: {n_pairs} pairs, {rate} pairs/s, "
              f"all primed; local stats {res['local_stats']}, global "
              f"{res['global_stats']}; launches "
              f"{json.dumps({k: v for k, v in launches.items() if v})}")
        results.append((res, rate, launches))
    glob_stats = [r[0]["global_stats"] for r in results]
    want = [sum(c) for c in zip(*(r[0]["local_stats"] for r in results))]
    pairs = sum(k for _, k in shards)
    if any(g != want for g in glob_stats) or want[0] != 2 * pairs:
        raise AssertionError(f"multihost global stats {glob_stats}, locals "
                             f"sum to {want}; want {2 * pairs} reads")
    for site, (k, b, d, dl, up, dn, top) in sorted(sums.items()):
        print(f"  [wtrace] {site}: {k} lines over the 4 processes, build "
              f"{b} ms, dispatch {d} ms, download {dl} ms, up {up:.2f} MB, "
              f"down {dn:.2f} MB; the longest line {top} ms (each line "
              f"rounds to whole ms)")
    n_pos, n_bc = _merge_matches([r[0]["output_dir"] for r in results],
                                 os.path.join(SMOKE, "out_host"),
                                 os.path.join(base, "merged.bam"), env)
    print(f"  multihost: {n_pos} position-bucketed and {n_bc} "
          f"barcode-sorted records equal host-native's; global stats "
          f"{want} in all 4 processes")
    return {"rates": [r[1] for r in results], "wtrace": sums,
            "launches": [r[2] for r in results]}


def _tile_launches(launches) -> int:
    """K1's launches through its tile entry: those of none of its other
    entries."""
    ent = launches["entries"]
    return launches["sw_extend"] - ent["lariat_sw_extend_desc"] - ent[
        "lariat_sw_extend_step"]


def phase_new_path(fasta, reads, out, flag, env, logs, rate_host):
    """A port CLI run on phase 16's reads with ``flag`` set and the
    all-primed knobs: every pair primed, records and whole files equal to
    host-native's on those reads, K1 only through its tile entry, K2 and
    K2b launched. Returns its launches by kernel and K1's tile entry's."""
    want = REPLAY_BARCODES * PAIRS_PER_BC
    n, rate, primed, host_pairs, launches = _port_run(
        fasta, reads, out, os.path.join(logs, f"{out}.log"),
        {**env, **_all_primed(want), **flag})
    if not (n == primed == want and host_pairs == 0):
        raise AssertionError(f"{out}: {n} pairs, {primed} primed, "
                             f"{host_pairs} host-routed; want {want} all "
                             f"primed")
    _same_records(out, "out_host_replay")
    phase_whole_bam([out], "out_host_replay")
    tile = _tile_launches(launches)
    desc = launches["entries"]["lariat_sw_extend_desc"]
    if not (tile > 0 and desc == 0 and launches["sw_global"] > 0
            and launches["traceback"] > 0):
        raise AssertionError(f"{out}: K1 tile entry {tile}, descriptor "
                             f"entry {desc}, K2 {launches['sw_global']}, "
                             f"K2b {launches['traceback']}")
    print(f"  {out} ({json.dumps(flag)}): {rate} pairs/s beside host-native "
          f"{rate_host} on the same reads ({rate / rate_host:.3f}x); K1 "
          f"{tile} launches, all through its tile entry; K2 "
          f"{launches['sw_global']}, K2b {launches['traceback']}, K3 "
          f"{launches['sw_local']}")
    return {k: launches.get(k, 0) for k in CLI_KERNELS} | {"tile": tile}


def phase_auto_upload(fasta, reads):
    """Auto seeding's background upload on the card, in this process: an
    engine with DEVICE_SEED_AUTO_MIN_LPAC at 0 primes batches of
    AUTO_BATCH reads one after another until one seeds on the device (K4a
    launched in it), each batch's regions equal to a host-seeded engine's.
    The batches before it are host-seeded by construction: the call that
    starts the upload returns None. Each batch's seconds are printed, and
    how many batches finished before the index was published. Returns the
    phase's launches of K4a, K4c and K5."""
    from lariat_tpu_torch.align.batch_engine import TorchBatchAlignmentEngine
    from lariat_tpu_torch.cli import load_reference
    from lariat_tpu_torch.io.fastq import FastQReader
    from lariat_tpu_torch.ops import _build
    flag = os.environ.pop("LARIAT_DEVICE_SEED", None)
    try:
        fm = load_reference(fasta)
        reader = FastQReader(reads)
        seqs = []
        while True:
            recs, _ = reader.read_barcode_set(0)
            if recs is None:
                break
            seqs.extend(s for rec in recs for s in (rec.read1, rec.read2))
        batches = [seqs[i:i + AUTO_BATCH]
                   for i in range(0, len(seqs), AUTO_BATCH)]
        host = TorchBatchAlignmentEngine(fm, device="cuda")
        eng = TorchBatchAlignmentEngine(fm, device="cuda")
        eng.DEVICE_SEED_AUTO_MIN_LPAC = 0
        if host.device_seeding() or not eng.device_seeding():
            raise AssertionError("auto seeding: the policy did not pick "
                                 "host for one engine and device for the "
                                 "other")
        _build.reset_launches()
        seeded, secs, in_flight, t0 = [], [], 0, time.time()
        while not any(seeded):
            if time.time() - t0 > AUTO_WAIT_S:
                raise AssertionError(f"auto seeding: {len(seeded)} batches "
                                     f"in {AUTO_WAIT_S} s, none on the "
                                     f"device")
            batch = batches[len(seeded) % len(batches)]
            k4a = _build.launches()["smem_twoptr"]
            tb = time.time()
            got = eng.align_batch(batch)
            secs.append(time.time() - tb)
            in_flight += eng._seed_state is None
            seeded.append(_build.launches()["smem_twoptr"] > k4a)
            if got != host.align_batch(batch):
                raise AssertionError(f"auto seeding: batch {len(seeded)} "
                                     f"regions differ from host seeding")
        n = _build.launches()
        if eng.seed_upload_s is None:
            raise AssertionError("auto seeding: a device-seeded batch "
                                 "without a finished upload")
        print(f"  auto seeding: the index upload (its thread, its stream) "
              f"took {eng.seed_upload_s:.3f} s; {len(seeded) - 1} batches "
              f"of {AUTO_BATCH} reads host-seeded ({in_flight} of them "
              f"finished before the index was published), then batch "
              f"{len(seeded)} device-seeded; each batch's s: "
              f"{[round(x, 4) for x in secs]}; regions equal to host "
              f"seeding in all; K4a {n['smem_twoptr']}, K4c "
              f"{n['smem_strategy1']}, K5 {n['sa_walk']} launches")
        return {k: n[k] for k in SEED_KERNELS} | {
            "upload_s": eng.seed_upload_s, "host_batches": len(seeded) - 1,
            "in_flight_batches": in_flight, "batch_s": secs}
    finally:
        if flag is not None:
            os.environ["LARIAT_DEVICE_SEED"] = flag


def phase_hg38(db, env, logs, chr20=None):
    """Phase 18, hg38 scale, on ``db``'s hg38sim.fa, its .lariat.d,
    sim10k.fastq.gz and centromeres (``python -m lariat_tpu_torch.tools.
    gen_data_big`` builds them; this script never does). Without them it
    prints why and returns None. Else: the index loaded as the CLI loads it
    (its seconds); the seeding index built and uploaded (int64, asserted);
    collect_seeds_rbegs_device on SEED_READS reads equal to the native C++
    seeder's, and on FALLBACK_READS of them with the low-complexity reads
    (``_fallback_collect``: K4b on the real index, exact against its twin);
    K4a (round 1), K4c and K5 (the lookup's 65,536 rows) against
    their twins and timed beside phase 5's ``chr20`` figures, K5's longest
    walk; K1's descriptor entry on an int64 wave; host-native (-use_device
    off, -centromeres), then the port with every pair primed, once with
    auto seeding (LARIAT_DEVICE_SEED unset) and once with
    LARIAT_DEVICE_SEED=1. In each: all pairs primed, none host-routed,
    records and whole files equal to host-native's, K1 (every launch
    through its descriptor entry), K2 and K2b launched, K3 wherever a mate
    was rescued, K4a, K4c and K5 launched exactly when a batch seeded on
    the device (every batch when forced; auto mode host-seeds every batch
    that starts before the upload lands), one K5 launch a lookup. Returns
    the phase's figures."""
    missing = [n for n in HG38_INPUTS
               if not os.path.exists(os.path.join(db, n))]
    if missing:
        print(f"  hg38 phase not run: {', '.join(missing)} absent from "
              f"{db} (python -m lariat_tpu_torch.tools.gen_data_big builds "
              f"them, for about an hour; this script never does)")
        return None
    import numpy as np
    import torch
    from lariat_tpu_torch.cli import load_reference
    from lariat_tpu_torch.config import AlignerConfig
    from lariat_tpu_torch.index import fmindex, native_ops
    from lariat_tpu_torch.ops import _build, fm_batch, smem_device as sd
    from lariat_tpu_torch.parallel import align_step
    from lariat_tpu_torch.tools.kernel_turns import lookup_rows, seed_batch
    fa, reads, cen = (os.path.join(db, n) for n in (
        "hg38sim.fa", "sim10k.fastq.gz", "hg38sim.centromeres.tsv"))
    dev = torch.device("cuda")
    opt = AlignerConfig()
    t0 = time.time()
    fm = load_reference(fa)
    if fm.l_pac > fmindex.FMIndex.CODES_CACHE_MAX:
        fm.ensure_codes_cache()
    fm.ensure_native_hot()
    load_s = time.time() - t0
    if getattr(fm, "_dir", None) is None:
        raise AssertionError("the hg38 index was not loaded from .lariat.d")
    fused_cached = os.path.exists(os.path.join(fm._dir, "fused.npy"))
    t0 = time.time()
    fmd = fm_batch.DeviceFMIndex.from_host(fm, dev)
    g = align_step.DeviceGenome.from_host(fm, fmd)
    torch.cuda.synchronize()
    index_s = time.time() - t0
    if fmd.idx_dtype != torch.int64:
        raise AssertionError(f"index dtype {fmd.idx_dtype}, want int64")
    print(f"  {fa}: l_pac {fm.l_pac:,}, seq_len {fm.seq_len:,} (2^31 = "
          f"{1 << 31:,}); index load {load_s:.2f} s in this process; fused "
          f"table {tuple(fmd.fused.shape)} "
          f"({fmd.fused.numel() * 4 / 1e9:.2f} GB, "
          f"{'read from' if fused_cached else 'built into'} fused.npy) and "
          f"pac on the card in {index_s:.2f} s; {fmd.idx_dtype}")
    # seeding on the real index, held to the native C++ seeder
    rmat, lens, qs = seed_batch(reads, SEED_READS)
    want = native_ops.collect_seeds_rbegs_batch(fm, qs, opt)
    if want is None:
        raise RuntimeError("native seeding unavailable")
    _build.reset_launches()
    got = sd.collect_seeds_rbegs_device(fmd, g, fm, qs, opt)
    n = _build.launches()
    if g.sa_samples is not None:
        raise AssertionError("the seeding path uploaded the SA samples")
    _same_seeds(got, want, len(qs), "hg38 collect")
    idle = [k for k in SEED_KERNELS if n[k] <= 0]
    if idle:
        raise AssertionError(f"hg38 collect launched no {idle}")
    print(f"  collect_seeds_rbegs_device on {len(qs)} reads: "
          f"{sum(len(m) for m in got[0])} seeds, "
          f"{sum(len(r) for r in got[1])} rbegs, equal to native; K4a "
          f"{n['smem_twoptr']}, K4c {n['smem_strategy1']}, K5 "
          f"{n['sa_walk']} launches")
    # K4b on the real index: phase 5's low-complexity reads blow K4a's
    # step cap here too
    k4b_launches = _fallback_collect(fm, fmd, g, qs[:FALLBACK_READS], opt)
    if k4b_launches <= 0:
        raise AssertionError("hg38 fallback collect launched no K4b")
    # K4a (round 1), K4c and K5 at the collect's shapes against their twins
    R, L = rmat.shape

    def put(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    rd, lens_d = put(rmat), put(lens)
    r1 = (rd, put(np.zeros(R), np.int32), lens_d, put(np.ones(R), np.int64))
    mid = put(np.full(R, L + 2), np.int32)

    def k4a():
        return sd.min_starts_twoptr(fmd, *r1, L, max_steps=3 * L,
                                    min_seed=opt.min_seed_len, cap=sd.CAP1,
                                    mid=mid)

    def p4a():
        meta, big, aux = sd.min_starts_twoptr_plain(
            fmd, r1[0], r1[1], r1[2], r1[3], mid, L, sd._budget(3 * L),
            False, opt.min_seed_len, sd.CAP1)
        sd._twoptr_flags(meta, aux, sd.CAP1)
        return meta, big, aux

    s1 = (fmd, rd, lens_d, int(opt.max_mem_intv), L, opt.min_seed_len,
          max(2, L // opt.min_seed_len + 2))
    rows = lookup_rows(fm.seq_len)
    k5 = (g, torch.from_numpy(rows).to(dev), torch.zeros(
        len(rows), dtype=torch.int64, device=dev), torch.zeros(
        len(rows), dtype=torch.bool, device=dev), align_step.LOOKUP_STEPS)
    out5 = align_step.sa_walk_chunk(*k5)
    for name, a, b in (
            ("K4a", k4a(), p4a()),
            ("K4c", sd.strategy1(*s1), sd.pack_r3(*sd.strategy1_plain(*s1))),
            ("K5", [out5], [align_step.sa_walk_chunk_plain(*k5)])):
        e = max(_max_abs_err(x, y) for x, y in zip(a, b))
        if e:
            raise AssertionError(f"hg38: {name} differs from its plain "
                                 f"version (max abs err {e})")
    if not bool(out5[2].bool().all()):
        raise AssertionError("K5: a walk outlived the lookup's budget")
    ms = {"smem_twoptr": _median_ms(k4a),
          "smem_strategy1": _median_ms(lambda: sd.strategy1(*s1)),
          "sa_walk": _median_ms(lambda: align_step.sa_walk_chunk(*k5))}
    longest = int(out5[1].max())
    beside = ({k: round(chr20[k], 4) for k in ms} if chr20
              else "not measured in this run")
    print(f"  hg38 ms (CUDA events, median of 7), exact against the twins: "
          f"{json.dumps({k: round(v, 4) for k, v in ms.items()})}; phase "
          f"5's chr20 figures: {json.dumps(beside)}; K5's longest walk "
          f"{longest} steps ({len(rows)} rows, {align_step.LOOKUP_STEPS} "
          f"allowed)")
    k1 = _k1_desc_wave(fm, _peaks(), dtypes=(np.int64,))
    ms["sw_extend"] = k1["desc_ms"]
    del fmd, g, rd, lens_d, r1, mid, k5, out5
    torch.cuda.empty_cache()
    # host-native, then the port with every pair primed: auto seeding, and
    # device seeding forced
    cen_arg = ("-centromeres", cen)
    host_out, host_s = _cli("lariat_tpu_torch.cli", "off", fa, reads,
                            os.path.join(SMOKE, "out_hg38_host"), THREADS,
                            os.path.join(logs, "hg38_host.log"), env,
                            cen_arg)
    n_host, rate_host = _summary(host_out)
    env = {k: v for k, v in env.items() if k != "LARIAT_DEVICE_SEED"}
    knobs = _all_primed(HG38_PAIRS)
    runs = {}
    for out, flag in (("out_hg38_port", {}),
                      ("out_hg38_port_seed", {"LARIAT_DEVICE_SEED": "1"})):
        info = {}
        runs[out] = (*_port_run(fa, reads, out,
                                os.path.join(logs, f"{out[4:]}.log"),
                                {**env, **knobs, **flag}, cen_arg, info),
                     info)
    res = {"l_pac": fm.l_pac, "load_s": load_s,
           "host_native": {"pairs_s": rate_host,
                           "load_s": _index_load_s(host_out)},
           "ms": ms, "k5_longest_walk": longest, "k1_desc_wave": k1,
           "k4b_collect_launches": k4b_launches}
    for out, (n_port, rate, primed, host_pairs, launches, info) in \
            runs.items():
        res[out] = {"pairs_s": rate, "primed": primed,
                    "host_routed": host_pairs, "busy": info["busy"],
                    "load_s": info["load_s"], **info["path"],
                    "cli_k5_longest": max((w["longest"]
                                           for w in launches["walks"]),
                                          default=0),
                    "launches": {k: launches.get(k, 0) for k in
                                 SEED_KERNELS + CLI_KERNELS}}
    print(f"  hg38 figures: {json.dumps(res)}")
    for out, (n_port, rate, primed, host_pairs, launches, info) in \
            runs.items():
        _same_records(out, "out_hg38_host")
        phase_whole_bam([out], "out_hg38_host")
        if not (n_host == n_port == primed == HG38_PAIRS
                and host_pairs == 0):
            raise AssertionError(f"{out} pairs: host {n_host}, port "
                                 f"{n_port}, primed {primed}, host-routed "
                                 f"{host_pairs}; want {HG38_PAIRS} all "
                                 f"primed")
        path = info["path"]
        # the seeding kernels ran where, and only where, a batch seeded on
        # the device; forced, every batch does
        seeded = path["seed_device_batches"] > 0
        if (any((launches[k] > 0) != seeded for k in SEED_KERNELS)
                or (out.endswith("_seed") and path["seed_host_batches"])):
            raise AssertionError(f"{out}: seeding kernels "
                                 f"{[launches[k] for k in SEED_KERNELS]} "
                                 f"against {json.dumps(path)}")
        idle = [k for k in CLI_KERNELS[:3] if launches.get(k, 0) <= 0]
        if path["rescue_tasks"] and launches["sw_local"] <= 0:
            idle.append("sw_local")
        desc = launches["entries"]["lariat_sw_extend_desc"]
        if idle or desc != launches["sw_extend"]:
            raise AssertionError(f"{out}: no launch of {idle}; {desc} of "
                                 f"{launches['sw_extend']} K1 launches "
                                 f"through the descriptor entry")
        _cli_walks(launches["walks"], launches["sa_walk"])
    auto = res["out_hg38_port"]
    if auto["host_batches_before_device"] is None:
        print(f"  auto seeding: no batch seeded on the device; all "
              f"{auto['seed_host_batches']} batches started seeding before "
              f"the index upload landed (seed_upload_s "
              f"{auto['seed_upload_s']})")
    else:
        print(f"  auto seeding: {auto['host_batches_before_device']} "
              f"host-seeded batches before the first device-seeded one "
              f"(seed_upload_s {auto['seed_upload_s']})")
    return res


def _all_primed(pairs: int) -> dict:
    """The router's knobs that leave it no reason to host-route a run of
    ``pairs`` pairs: a thread for every batch it can make (batches are 512
    pairs or more but the last), a tail grace past the run, no dormancy."""
    return {"LARIAT_PRIME_THREADS": str(-(-pairs // 512)),
            "LARIAT_PRIME_TAIL_GRACE": "600", "LARIAT_PRIME_MIN_FRAC": "0"}


def _ran(launches, path, what):
    """{kernel: [launches, largest launch]} of every kernel a run launched
    (``path_log``'s largest launch in the kernel's unit); fails when one
    of them has no largest launch."""
    largest = path["largest_launches"]
    ran = {k: [launches[k], largest.get(k, 0)] for k in KERNEL_INFO
           if launches.get(k, 0) > 0}
    bad = [k for k, (_, m) in ran.items() if m <= 0]
    if bad:
        raise AssertionError(f"{what}: {bad} launched without a largest "
                             f"launch")
    return ran


def phase_messy(fasta, env, logs):
    """The soak test's messy pairs (indels, N runs, chimeras,
    homopolymers, junk, mates of 1-24 bases; tools/messy_reads.py) on phase
    4's genome, MESSY_BARCODES x MESSY_PAIRS: host-native, then the port
    all primed with host seeding and with LARIAT_DEVICE_SEED=1. Every pair
    primed, records and whole files equal to host-native's, K1, K2 and K2b
    launched (K3 when a mate was rescued; K4a, K4c and K5 when seeding on
    the device), each kernel that ran printed with its launches and its
    largest launch. Returns the phase's figures."""
    from lariat_tpu_torch.tools import messy_reads
    want = MESSY_BARCODES * MESSY_PAIRS
    os.makedirs(SMOKE, exist_ok=True)
    reads = os.path.join(SMOKE, "messy.fastq.gz")
    messy_reads.write_fastq(messy_reads.load_genome(fasta), reads,
                            MESSY_BARCODES, MESSY_PAIRS)
    host_out, _ = _cli("lariat_tpu_torch.cli", "off", fasta, reads,
                       os.path.join(SMOKE, "out_messy_host"), THREADS,
                       os.path.join(logs, "messy_host.log"), env)
    n_host, rate_host = _summary(host_out)
    res = {"host_native_pairs_s": rate_host}
    for out, flag in (("out_messy_port", {}),
                      ("out_messy_port_seed", {"LARIAT_DEVICE_SEED": "1"})):
        info = {}
        n, rate, primed, host_pairs, launches = _port_run(
            fasta, reads, out, os.path.join(logs, f"{out[4:]}.log"),
            {**env, **_all_primed(want), **flag}, info=info)
        if not (n_host == n == primed == want and host_pairs == 0):
            raise AssertionError(f"{out}: host {n_host}, port {n}, primed "
                                 f"{primed}, host-routed {host_pairs}; want "
                                 f"{want} all primed")
        _same_records(out, "out_messy_host")
        phase_whole_bam([out], "out_messy_host")
        need = list(CLI_KERNELS[:3]) + (list(SEED_KERNELS) if flag else [])
        if info["path"]["rescue_tasks"]:
            need.append("sw_local")
        idle = [k for k in need if launches.get(k, 0) <= 0]
        if idle:
            raise AssertionError(f"{out}: no launch of {idle}")
        ran = _ran(launches, info["path"], out)
        print(f"  {out}: {rate} pairs/s (host-native {rate_host}); "
              f"{info['path']['rescue_tasks']} rescue tasks; kernels that "
              f"ran, [launches, largest launch]: {json.dumps(ran)}")
        res[out] = {"pairs_s": rate, "kernels": ran}
    return res


_DORMANT = re.compile(r"device priming dormant \(measured (\d+) pairs/s\) "
                      r"after ([\d.]+)s, (\d+) pairs primed")
_SIMULATED = re.compile(r"^simulated: .*$", re.M)


def _run_figures(n, rate, primed, host_pairs, launches, info, what):
    """One long CLI run's printed figures (phases 20 and 21; and a dict of
    them); a server run's add the server's peak RSS and set-up."""
    path = info["path"]
    dm = _DORMANT.search(info["stdout"])
    sim = _SIMULATED.search(info["stdout"])
    peak = path["cuda_peak_bytes"]
    srv = {k: info[k] for k in ("server_rss_gib", "server_setup")
           if k in info}
    fig = {"pairs": n, "pairs_s": rate, "primed": primed,
           "host_routed": host_pairs,
           "dormant": dm and {"after_s": float(dm.group(2)),
                              "primed_then": int(dm.group(3)),
                              "measured_pairs_s": int(dm.group(1))},
           "largest_batch_pairs": path["largest_batch_pairs"],
           "kernels": _ran(launches, path, what),
           "cuda_peak_gib": None if peak is None else round(peak / 2**30, 3),
           "cli_peak_rss_gib": round(info["rss_gib"], 3),
           "wall_s": round(info["wall"], 1), "busy": info["busy"],
           "rescue_tasks": path["rescue_tasks"],
           "seed_batches": [path["seed_host_batches"],
                            path["seed_device_batches"]],
           "host_batches_before_device": path["host_batches_before_device"],
           "seed_upload_s": path["seed_upload_s"],
           "simulated": sim and sim.group(0), **srv}
    print(f"  {what}: {n} pairs, {rate} pairs/s, {info['wall']:.1f} s wall; "
          f"primed {primed}, host-routed {host_pairs}; dormant: "
          f"{json.dumps(fig['dormant'])}; largest primed batch "
          f"{fig['largest_batch_pairs']} pairs; batches seeded [host, "
          f"device] {fig['seed_batches']}, host-seeded before the first "
          f"device-seeded {fig['host_batches_before_device']}, upload "
          f"{fig['seed_upload_s']} s; kernels [launches, largest launch]: "
          f"{json.dumps(fig['kernels'])}; card peak {fig['cuda_peak_gib']} "
          f"GiB allocated in the priming process; CLI peak RSS "
          f"{fig['cli_peak_rss_gib']} GiB; "
          + (f"server peak RSS {srv['server_rss_gib']:.3f} GiB, set-up "
             f"{json.dumps(srv['server_setup'])}; " if srv else "")
          + f"{fig['simulated'] or 'no simulated line'}")
    return fig


def phase_chr20(db, env, logs):
    """The reference's chr20_1m run on ``db``'s chr20sim.fa, its .lariat.d
    and sim1m_chr20.fastq.gz (``python -m lariat_tpu_torch.tools.
    gen_data_big DIR --chr20`` builds them; this script never does):
    without them it prints why and returns None. Else five CLI runs of
    1,000,000 pairs, 8 workers, -simulated, one after another: a.
    host-native; b. the port at the router's defaults; c. the router
    without dormancy (LARIAT_PRIME_MIN_FRAC=0, two priming threads, host
    seeding), whose batches grow toward the 16,384-pair cap; d. c with
    LARIAT_DEVICE_SEED=1; e. through the resident server. Each prints
    pairs/s, primed and host-routed pairs, whether and when the router
    went dormant, the largest primed batch, each kernel's launches and
    largest launch, the card's peak allocated memory in the priming
    process, the CLI's peak RSS, the wall and the -simulated line. Checks
    (every run is made before a failure is raised): 1,000,000 pairs a run,
    records and whole files equal to host-native's, runs c and d primed
    pairs, run c primed a batch of CHR20_MIN_BATCH pairs or more, run d
    launched K4a, K4c and K5, every kernel that ran has a largest launch.
    Returns the phase's figures."""
    missing = [n for n in CHR20_INPUTS
               if not os.path.exists(os.path.join(db, n))]
    if missing:
        print(f"  chr20 x 1M phase not run: {', '.join(missing)} absent "
              f"from {db} (python -m lariat_tpu_torch.tools.gen_data_big "
              f"DIR --chr20 builds them, in about 6 min; this script never "
              f"does)")
        return None
    os.makedirs(SMOKE, exist_ok=True)
    fa, reads = (os.path.join(db, n) for n in CHR20_INPUTS[::2])
    sim = ("-simulated",)
    peak = {}
    host_out, host_s = _cli("lariat_tpu_torch.cli", "off", fa, reads,
                            os.path.join(SMOKE, "out_c20_host"), THREADS,
                            os.path.join(logs, "c20_host.log"), env, sim,
                            CHR20_TIMEOUT, peak)
    n_host, rate_host = _summary(host_out)
    host_sim = _SIMULATED.search(host_out)
    res = {"host_native": {"pairs": n_host, "pairs_s": rate_host,
                           "wall_s": round(host_s, 1),
                           "cli_peak_rss_gib": round(peak["rss_gib"], 3),
                           "simulated": host_sim and host_sim.group(0)}}
    print(f"  a. host-native: {n_host} pairs, {rate_host} pairs/s, "
          f"{host_s:.1f} s wall; CLI peak RSS {peak['rss_gib']:.3f} GiB; "
          f"{res['host_native']['simulated']}")
    fails = [] if n_host == CHR20_PAIRS else [f"host-native: {n_host} pairs"]
    no_dorm = {"LARIAT_PRIME_MIN_FRAC": "0"}
    for what, out, flag in (
            ("b. router defaults", "out_c20_default", {}),
            ("c. no dormancy", "out_c20_nodorm", no_dorm),
            ("d. no dormancy, device seeding", "out_c20_nodorm_seed",
             {**no_dorm, "LARIAT_DEVICE_SEED": "1"}),
            ("e. resident server", "out_c20_server", None)):
        info = {}
        try:
            if flag is None:
                run = _server_run(fa, reads, env, logs, out, sim, info,
                                  CHR20_TIMEOUT)
            else:
                run = _port_run(fa, reads, out,
                                os.path.join(logs, f"{out[4:]}.log"),
                                {**env, **flag}, sim, info, CHR20_TIMEOUT)
            res[out] = fig = _run_figures(*run, info, what)
            if not (fig["pairs"] == CHR20_PAIRS
                    and fig["primed"] + fig["host_routed"] == CHR20_PAIRS):
                fails.append(f"{out}: {fig['pairs']} pairs, "
                             f"{fig['primed']} primed, "
                             f"{fig['host_routed']} host-routed")
            _same_records(out, "out_c20_host")
            phase_whole_bam([out], "out_c20_host")
        except Exception as e:  # noqa: BLE001 -- raised after every run
            print(f"  {what} FAILED: {e}")
            fails.append(f"{out}: {e}")
        shutil.rmtree(os.path.join(SMOKE, out), ignore_errors=True)
    shutil.rmtree(os.path.join(SMOKE, "out_c20_host"), ignore_errors=True)
    print(f"  chr20 x 1M figures: {json.dumps(res)}")
    for out in ("out_c20_nodorm", "out_c20_nodorm_seed"):
        if out in res and res[out]["primed"] <= 0:
            fails.append(f"{out}: no pair primed")
    c = res.get("out_c20_nodorm")
    if c and c["largest_batch_pairs"] < CHR20_MIN_BATCH:
        fails.append(f"out_c20_nodorm: largest primed batch "
                     f"{c['largest_batch_pairs']} < {CHR20_MIN_BATCH}")
    d = res.get("out_c20_nodorm_seed")
    if d:
        idle = [k for k in SEED_KERNELS if k not in d["kernels"]]
        if idle:
            fails.append(f"out_c20_nodorm_seed: no launch of {idle}")
    if fails:
        raise AssertionError("chr20 x 1M: " + "; ".join(fails))
    return res


def phase_hg38_200k(db, env, logs):
    """Phase 21, the CLI's device modes at hg38 x 200k, on ``db``'s
    hg38sim.fa, its .lariat.d, centromeres and sim200k.fastq.gz (``python
    -m lariat_tpu_torch.tools.gen_data_big DIR --hg38`` builds them; this
    script never does): without them it prints why and returns None. Else
    five CLI runs of 200,000 pairs, 8 workers, -centromeres, -simulated,
    LARIAT_DEVICE_SEED unset (auto seeding): a. host-native; b. the router's
    defaults (-use_device auto, the CLI's own engine); c. b without
    dormancy (LARIAT_PRIME_MIN_FRAC=0); d. through the resident server on
    the same genome (the reference bench's hg38_device_8w); e. d without
    dormancy. Each prints _run_figures' line (d and e with the server's
    set-up split and peak RSS) and its K4b launches. Checks (every run is
    made before a failure is raised): 200,000 pairs a run, primed plus
    host-routed all of them, records and whole files equal to
    host-native's; c seeds a batch or more on the device, with K4a, K4c and
    K5 launched; no batch host-seeded in the server (d, e); e primes pairs,
    and its server launches K1 (every launch through its descriptor
    entry), K2, K2b, K4a, K4c and K5, and K3 wherever a mate was rescued.
    Returns the phase's figures."""
    missing = [n for n in HG38_200K_INPUTS
               if not os.path.exists(os.path.join(db, n))]
    if missing:
        print(f"  hg38 x 200k phase not run: {', '.join(missing)} absent "
              f"from {db} (python -m lariat_tpu_torch.tools.gen_data_big "
              f"DIR --hg38 builds them, in about 40 min; this script "
              f"never does)")
        return None
    os.makedirs(SMOKE, exist_ok=True)
    fa, _, cen, reads = (os.path.join(db, n) for n in HG38_200K_INPUTS)
    extra = ("-centromeres", cen, "-simulated")
    env = {k: v for k, v in env.items() if k != "LARIAT_DEVICE_SEED"}
    peak = {}
    host_out, host_s = _cli("lariat_tpu_torch.cli", "off", fa, reads,
                            os.path.join(SMOKE, "out_h200_host"), THREADS,
                            os.path.join(logs, "h200_host.log"), env, extra,
                            HG38_200K_TIMEOUT, peak)
    n_host, rate_host = _summary(host_out)
    host_sim = _SIMULATED.search(host_out)
    res = {"host_native": {"pairs": n_host, "pairs_s": rate_host,
                           "wall_s": round(host_s, 1),
                           "load_s": _index_load_s(host_out),
                           "cli_peak_rss_gib": round(peak["rss_gib"], 3),
                           "simulated": host_sim and host_sim.group(0)}}
    print(f"  a. host-native: {n_host} pairs, {rate_host} pairs/s, "
          f"{host_s:.1f} s wall (index load {res['host_native']['load_s']} "
          f"s); CLI peak RSS {peak['rss_gib']:.3f} GiB; "
          f"{res['host_native']['simulated']}")
    fails = ([] if n_host == HG38_200K_PAIRS
             else [f"host-native: {n_host} pairs"])
    no_dorm = {"LARIAT_PRIME_MIN_FRAC": "0"}
    for what, out, server, flag in (
            ("b. router defaults", "out_h200_default", False, {}),
            ("c. no dormancy", "out_h200_nodorm", False, no_dorm),
            ("d. server, defaults", "out_h200_server", True, {}),
            ("e. server, no dormancy", "out_h200_server_nodorm", True,
             no_dorm)):
        info = {}
        try:
            if server:
                run = _server_run(fa, reads, {**env, **flag}, logs, out,
                                  extra, info, HG38_200K_TIMEOUT, "auto",
                                  HG38_READY_S)
            else:
                run = _port_run(fa, reads, out,
                                os.path.join(logs, f"{out[4:]}.log"),
                                {**env, **flag}, extra, info,
                                HG38_200K_TIMEOUT, "auto")
            res[out] = fig = _run_figures(*run, info, what)
            print(f"  {what}: K4b launches "
                  f"{run[4].get('smem_exhaustive', 0)}")
            if not (fig["pairs"] == HG38_200K_PAIRS and fig["primed"]
                    + fig["host_routed"] == HG38_200K_PAIRS):
                fails.append(f"{out}: {fig['pairs']} pairs, "
                             f"{fig['primed']} primed, "
                             f"{fig['host_routed']} host-routed")
            if server and fig["seed_batches"][0]:
                fails.append(f"{out}: {fig['seed_batches'][0]} batches "
                             f"host-seeded in the server")
            if server:
                desc = run[4]["entries"]["lariat_sw_extend_desc"]
                if desc != run[4]["sw_extend"]:
                    fails.append(f"{out}: {desc} of {run[4]['sw_extend']} "
                                 f"K1 launches through the descriptor entry")
            _same_records(out, "out_h200_host")
            phase_whole_bam([out], "out_h200_host")
        except Exception as e:  # noqa: BLE001 -- raised after every run
            print(f"  {what} FAILED: {e}")
            fails.append(f"{out}: {e}")
        shutil.rmtree(os.path.join(SMOKE, out), ignore_errors=True)
    shutil.rmtree(os.path.join(SMOKE, "out_h200_host"), ignore_errors=True)
    print(f"  hg38 x 200k figures: {json.dumps(res)}")
    c = res.get("out_h200_nodorm")
    if c:
        idle = [k for k in SEED_KERNELS if k not in c["kernels"]]
        if c["seed_batches"][1] <= 0 or idle:
            fails.append(f"out_h200_nodorm: {c['seed_batches'][1]} batches "
                         f"seeded on the device; no launch of {idle}")
    e = res.get("out_h200_server_nodorm")
    if e:
        need = ["sw_extend", "sw_global", "traceback", *SEED_KERNELS]
        if e["rescue_tasks"]:
            need.append("sw_local")
        idle = [k for k in need if k not in e["kernels"]]
        if e["primed"] <= 0 or idle:
            fails.append(f"out_h200_server_nodorm: {e['primed']} primed; "
                         f"no launch of {idle} in the server")
    if fails:
        raise AssertionError("hg38 x 200k: " + "; ".join(fails))
    return res


def _card_env(env, h, sock=None):
    """Process h's environment in phase 22: ``env`` without any LARIAT_*
    knob it carries, process h's card (``LARIAT_TORCH_DEVICE=cuda:h``)
    and, when it primes through a server, that server's socket
    (``LARIAT_DEVICE_SOCKET``)."""
    out = {k: v for k, v in env.items() if not k.startswith("LARIAT_")}
    out["LARIAT_TORCH_DEVICE"] = CARD.format(h)
    if sock:
        out["LARIAT_DEVICE_SOCKET"] = sock
    return out


def _bus(bus_id: str) -> str:
    """A PCI bus id without its domain, in lower case (nvidia-smi writes
    the domain with 4 or 8 digits)."""
    return ":".join(bus_id.strip().lower().split(":")[-2:])


class _Apps:
    """nvidia-smi's compute apps, sampled every SMI_EVERY_S s on a thread
    while a mode runs. ``seen`` maps (owner, card index) to the largest
    MiB used, the owner being the label of the run's process whose tree
    holds the app's pid (``roots``: a started process's pid -> its label,
    filled as they start), else "pid N"."""

    def __init__(self, roots):
        self.roots = roots
        q = subprocess.run(["nvidia-smi", "--query-gpu=index,pci.bus_id",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, check=True, timeout=60).stdout
        # a host may read "[N/A]" for every bus id: those map to no card
        self.index = {_bus(b): int(i) for i, b in
                      (line.split(",") for line in q.splitlines()
                       if line.strip()) if ":" in b}
        self.seen: dict = {}
        self.samples = 0
        self.errors: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(60)
        return False

    def _loop(self):
        while True:
            self.sample()
            if self._stop.wait(SMI_EVERY_S):
                return

    def sample(self):
        try:
            out = subprocess.run(
                ["nvidia-smi",
                 "--query-compute-apps=pid,gpu_bus_id,used_memory",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, timeout=30).stdout
        except (OSError, subprocess.SubprocessError) as e:
            self.errors.append(repr(e))
            return
        self.samples += 1
        for line in out.splitlines():
            parts = [x.strip() for x in line.split(",")]
            if len(parts) != 3:
                continue
            pid, bus, mib = parts
            key = (self._owner(int(pid)) if pid.isdigit() else f"pid {pid}",
                   self.index.get(_bus(bus), bus))
            self.seen[key] = max(self.seen.get(key, 0),
                                 int(mib) if mib.isdigit() else 0)

    def _owner(self, pid: int) -> str:
        p = pid
        for _ in range(64):
            if p in self.roots:
                return self.roots[p]
            try:
                with open(f"/proc/{p}/stat") as f:
                    p = int(f.read().rsplit(")", 1)[1].split()[1])
            except (OSError, ValueError, IndexError):
                break
            if p <= 1:
                break
        return f"pid {pid}"

    def binding(self, want):
        """Problems with the binding nvidia-smi showed, and a note: ``want``
        maps each card to the one process of the run that may hold a
        context there, and no other process of the run holds one. No
        problem, and a note saying so, when nvidia-smi listed no app of
        the run at all (the processes' own logs then hold the binding)."""
        run = set(self.roots.values())
        ours = {k for k in self.seen if k[0] in run}
        if not ours:
            return [], (f"nvidia-smi listed no app of this run in "
                        f"{self.samples} samples (all it listed: "
                        f"{sorted(map(str, self.seen))}; errors "
                        f"{self.errors[:2]})")
        problems = []
        for card, label in want.items():
            on = sorted(w for w, c in ours if c == card)
            if on != [label]:
                problems.append(f"card {card} carried {on}, want [{label}]")
        for who in sorted(run):
            cards = sorted(str(c) for w, c in ours if w == who)
            if len(cards) > 1 or (cards and who not in want.values()):
                problems.append(f"{who} held contexts on cards {cards}")
        return problems, None


def _group(procs, timeout, roots):
    """Start every {"label", "cmd", "env", "log"} of ``procs`` at once,
    each under _PEAK_WRAP in a session of its own (``roots`` gets each
    pid and label), and wait for all of them within ``timeout`` s; at the
    first nonzero exit or at the timeout every process group still
    running is killed, so none is left waiting at a rendezvous. Each entry
    gains "rc" (None when killed), "start", "end", "out" (its log) and
    "rss_gib" (None without the wrapper's line)."""
    try:
        for x in procs:
            with open(x["log"], "w") as log:
                x["start"], x["end"] = time.time(), None
                x["proc"] = subprocess.Popen(
                    [sys.executable, "-c", _PEAK_WRAP, *x["cmd"]], cwd=REPO,
                    env=x["env"], stdout=log, stderr=subprocess.STDOUT,
                    start_new_session=True)
            roots[x["proc"].pid] = x["label"]
        deadline = time.time() + timeout
        while not all(x["end"] for x in procs):
            for x in procs:
                if x["end"] is None and x["proc"].poll() is not None:
                    x["end"] = time.time()
            if any(x["proc"].returncode not in (None, 0) for x in procs) \
                    or time.time() > deadline:
                break
            time.sleep(0.2)
    finally:
        for x in procs:
            if "proc" not in x:
                continue
            if x["proc"].poll() is None:
                os.killpg(x["proc"].pid, 9)   # the wrapper and its tree
                x["proc"].wait()
            x["rc"] = x["proc"].returncode if x["end"] else None
            x["end"] = x["end"] or time.time()
            with open(x["log"]) as f:
                x["out"] = f.read()
            rss = re.search(r"peak rss KiB (\d+)\s*$", x["out"])
            x["rss_gib"] = rss and int(rss.group(1)) / 2**20


def _start_servers(fa, env, base, logs, tag, roots):
    """Phase 22 d's resident servers, server h on card h and socket
    ``base/srv_h.sock``, all started at once under _PEAK_WRAP; returns
    them once every ready file exists. One that exits or a wait past
    HG38_READY_S kills them all and raises."""
    servers = []
    try:
        for h in range(FOUR):
            sock = os.path.join(base, f"srv_{h}.sock")
            ready = os.path.join(base, f"srv_{h}.ready")
            log = os.path.join(logs, f"four_{tag}_d_server_{h}.log")
            with open(log, "w") as lf:
                proc = subprocess.Popen(
                    [sys.executable, "-c", _PEAK_WRAP, sys.executable, "-m",
                     "lariat_tpu_torch.parallel.device_server", "-genome",
                     fa, "-socket", sock, "-ready_file", ready,
                     "-idle_timeout", "900"], cwd=REPO,
                    env=_card_env(env, h), stdout=lf,
                    stderr=subprocess.STDOUT, start_new_session=True)
            roots[proc.pid] = f"server {h}"
            servers.append({"proc": proc, "sock": sock, "ready": ready,
                            "log": log, "start": time.time(),
                            "ready_s": None})
        while not all(s["ready_s"] for s in servers):
            for s in servers:
                if s["ready_s"] is None and os.path.exists(s["ready"]):
                    s["ready_s"] = time.time() - s["start"]
                if s["proc"].poll() is not None:
                    raise RuntimeError(f"server {servers.index(s)} exited "
                                       f"{s['proc'].returncode} before it "
                                       f"was ready")
            if time.time() - servers[0]["start"] > HG38_READY_S:
                raise RuntimeError(f"the servers were not ready within "
                                   f"{HG38_READY_S} s")
            time.sleep(0.2)
    except BaseException:
        _stop_servers(servers)
        raise
    return servers


def _stop_servers(servers):
    """Ask each running server to stop and wait for it (120 s), then kill
    what is left; each server gains "rc", "out" (its log) and "rss_gib"
    (its peak RSS, None without the wrapper's line)."""
    from lariat_tpu_torch.parallel.device_server import stop_server
    for s in servers:
        if s["proc"].poll() is None:
            try:
                stop_server(s["sock"])
            except OSError:
                pass
    for s in servers:
        try:
            s["proc"].wait(timeout=120)
        except subprocess.TimeoutExpired:
            pass
        if s["proc"].poll() is None:
            os.killpg(s["proc"].pid, 9)
            s["proc"].wait()
        s["rc"] = s["proc"].returncode
        with open(s["log"]) as f:
            s["out"] = f.read()
        rss = re.search(r"peak rss KiB (\d+)\s*$", s["out"])
        s["rss_gib"] = rss and int(rss.group(1)) / 2**20


def _sim_stats(stdout):
    """The CLI's -simulated counts [total, correct, total at MAPQ >= 10,
    correct at MAPQ >= 10], as multihost sums them."""
    m = re.search(r"simulated: total=(\d+) correct=(\d+) mapq10 "
                  r"total=(\d+) correct=(\d+)", stdout)
    if not m:
        raise AssertionError("no 'simulated:' line")
    return [int(g) for g in m.groups()]


def _four_process(tag, mode, h, x, server, fails):
    """Process h's figures in mode ``mode`` of phase 22, its checks'
    failures appended to ``fails``: exit 0 with its JSON line; in c and d
    its card's binding as the process logs it (the path log's device and
    CUDA contexts: the CLI's in c, the server's in d, where the CLI never
    initialises CUDA), pairs primed, K1, K2 and K2b launched, K3 where a
    mate was rescued, K4a, K4c and K5 in d at hg38, a nonzero peak of
    device memory."""
    what = f"{tag} {mode} process {h}"
    if x["rc"] != 0:
        fails.append(f"{what} exited {x['rc']}: {x['out'][-800:]}")
        return None
    out = x["out"]
    res = _last_json(out, ("host", "rc", "output_dir", "local_stats",
                           "global_stats"), what)
    n, rate = _summary(out)
    sim = _SIMULATED.search(out)
    fig = {"pairs": n, "pairs_s": rate, "wall_s": round(x["end"] - x["start"],
                                                          1),
           "rss_gib": x["rss_gib"] and round(x["rss_gib"], 3),
           "local_stats": res["local_stats"],
           "global_stats": res["global_stats"],
           "output_dir": res["output_dir"],
           "simulated": sim and sim.group(0)}
    if mode == "b":
        return fig
    card = CARD.format(h)
    m = re.search(r"primed pairs (\d+)\s+host pairs (\d+)", out)
    if not m:
        fails.append(f"{what}: no device summary line")
        return fig
    fig.update(primed=int(m.group(1)), host_routed=int(m.group(2)))
    log = server["out"] if server else out
    lm = re.search(r"kernel launches: (\{.*\})", log)
    pm = re.search(r"device path: (\{.*\})", log)
    if not (lm and pm):
        fails.append(f"{what}: no kernel launch or device path line")
        return fig
    launches, path = json.loads(lm.group(1)), json.loads(pm.group(1))
    peak = path["cuda_peak_bytes"]
    fig.update(launches=launches, device=path["device"],
               cuda_contexts=path["cuda_contexts"],
               seed_batches=[path["seed_host_batches"],
                             path["seed_device_batches"]],
               seed_upload_s=path["seed_upload_s"],
               rescue_tasks=path["rescue_tasks"],
               largest_batch_pairs=path["largest_batch_pairs"],
               cuda_peak_gib=peak and round(peak / 2**30, 3))
    if server:
        fig.update(server_rss_gib=server["rss_gib"]
                   and round(server["rss_gib"], 3),
                   server_ready_s=round(server["ready_s"], 2))
        if "cuda initialized in the CLI process: False" not in out or \
                f"device priming via server ({server['sock']}" not in out:
            fails.append(f"{what}: the CLI did not prime through server {h} "
                         f"alone")
    if path["device"] != card or path["cuda_contexts"] != [h]:
        fails.append(f"{what}: the {'server' if server else 'CLI'} primed "
                     f"on {path['device']} with contexts on cards "
                     f"{path['cuda_contexts']}, want {card} and [{h}]")
    need = list(CLI_KERNELS[:3]) + (["sw_local"] if path["rescue_tasks"]
                                    else [])
    if server and tag == "hg38_200k":
        need += SEED_KERNELS
    idle = [k for k in need if launches.get(k, 0) <= 0]
    if idle or fig["primed"] <= 0 or not peak:
        fails.append(f"{what}: {fig['primed']} primed, card peak {peak}, no "
                     f"launch of {idle}")
    return fig


def _four_mode(tag, mode, fa, shards, extra, env, base, logs, W, fails):
    """Mode b, c or d of phase 22: four multihost processes, process h on
    shard h with W workers, meeting through a file; in d each through its
    own server on card h. nvidia-smi is sampled throughout. Returns the
    mode's figures: each process's, the aggregate and the card binding."""
    mem = _meminfo_gib('MemAvailable')
    print(f"  {tag} {mode}: MemAvailable {mem:.1f} GiB before the mode")
    rdv = os.path.join(base, f"{mode}.rendezvous")
    procs = []
    for h, (shard, _) in enumerate(shards):
        penv = _card_env(env, h, os.path.join(base, f"srv_{h}.sock")
                         if mode == "d" else None)
        if mode == "c":
            penv["LARIAT_PRIME_MIN_FRAC"] = "0"
        procs.append({
            "label": f"cli {h}", "env": penv,
            "log": os.path.join(logs, f"four_{tag}_{mode}_{h}.log"),
            "cmd": [sys.executable, "-m",
                    "lariat_tpu_torch.parallel.multihost", "-coordinator",
                    "file://" + rdv, "-num_processes", str(FOUR),
                    "-process_id", str(h), "-reads", shard, "-genome", fa,
                    "-output_base", os.path.join(base, mode), "-threads",
                    str(W), "-use_device", "off" if mode == "b" else "auto",
                    *extra]})
    roots, servers = {}, []
    with _Apps(roots) as apps:
        try:
            if mode == "d":
                servers = _start_servers(fa, env, base, logs, tag, roots)
            _group(procs, FOUR_TIMEOUT, roots)
        finally:
            _stop_servers(servers)
    for h, s in enumerate(servers):
        if s["rc"] != 0:
            fails.append(f"{tag} d server {h} exited {s['rc']}: "
                         f"{s['out'][-800:]}")
    figs = []
    for h, x in enumerate(procs):
        try:
            figs.append(_four_process(tag, mode, h, x,
                                      servers[h] if servers else None, fails))
        except AssertionError as e:
            fails.append(f"{tag} {mode} process {h}: {e}")
            figs.append(None)
    want = {} if mode == "b" else {
        h: f"{'server' if mode == 'd' else 'cli'} {h}" for h in range(FOUR)}
    problems, note = apps.binding(want)
    fails.extend(f"{tag} {mode}: {p}" for p in problems)
    seen = {f"{w} on card {c}": mib for (w, c), mib in sorted(
        apps.seen.items(), key=str)}
    pairs = sum(f["pairs"] for f in figs if f)
    wall = max(x["end"] for x in procs) - min(x["start"] for x in procs)
    for h, f in enumerate(figs):
        if f:
            print(f"  {tag} {mode} process {h}: {json.dumps(f)}")
    print(f"  {tag} {mode} aggregate: {pairs} pairs in {wall:.1f} s from the "
          f"first start to the last exit, {pairs / wall:.1f} pairs/s")
    print(f"  {tag} {mode} nvidia-smi ({apps.samples} samples), largest MiB "
          f"by process and card: {json.dumps(seen)}"
          + (f"; {note}" if note else ""))
    return {"processes": figs, "pairs": pairs, "wall_s": round(wall, 1),
            "pairs_s": round(pairs / wall, 1), "mem_available_gib":
            round(mem, 1), "nvidia_smi": seen, "nvidia_smi_note": note}


def phase_four_cards(c20_db, hg38_db, env, logs):
    """Phase 22: the scale-out path with one multihost process a card, on a
    host with four cards, over the inputs of phase 20 (``c20_db``) and of
    phase 21 (``hg38_db``), each where it exists (None: not this one).
    Without four cards or without either input it prints why and returns
    None. Each input is cut into four barcode-complete shards of whole
    barcodes in input order; with C the host's CPUs and W = min(8, C //
    4): a. one process, host-native, 4W workers, over the whole input;
    b. four multihost processes, W workers each, -use_device off; c. the
    same with process h's engine on cuda:h (LARIAT_TORCH_DEVICE) and the
    router without dormancy; d. each through its own resident server on
    cuda:h (its own socket) at the router's defaults. -simulated, and
    -centromeres at hg38; auto seeding. Checks (every mode is run before
    a failure is raised): each process exits 0 with its JSON line, the
    four global stats equal, equal to the sum of the locals and to a's;
    b's merge (cat_bams --auto) equal to a's records; each process's
    directory in c and d equal to its directory in b, as records and as
    whole files; each card carrying exactly its process (the server in d,
    where no CLI holds a context) in nvidia-smi's samples and in the
    processes' own path logs, kernels launched on every card. Returns the
    figures by input and mode."""
    import torch
    n_cards = torch.cuda.device_count()
    sets = {"chr20_1m": (c20_db, CHR20_INPUTS),
            "hg38_200k": (hg38_db, HG38_200K_INPUTS)}
    missing = {tag: [n for n in names if not (db and os.path.exists(
        os.path.join(db, n)))] for tag, (db, names) in sets.items()}
    why = [] if n_cards >= FOUR else [f"{n_cards} CUDA device(s), {FOUR} "
                                      f"needed"]
    if all(missing.values()):
        why.append("no inputs: " + "; ".join(
            f"{tag}'s {', '.join(m)} absent from {sets[tag][0]}"
            for tag, m in missing.items()))
    if why:
        print(f"  four-card phase not run: {'; '.join(why)}")
        return None
    env = {k: v for k, v in env.items() if not k.startswith("LARIAT_")}
    cpus = os.cpu_count() or 1
    W = max(1, min(8, cpus // FOUR))
    res, fails = {}, []
    for tag, (db, _) in sets.items():
        if missing[tag]:
            print(f"  four-card phase, {tag} not run: "
                  f"{', '.join(missing[tag])} absent from {db}")
            continue
        if tag == "chr20_1m":
            fa, _, reads = (os.path.join(db, n) for n in CHR20_INPUTS)
            extra = ("-simulated",)
        else:
            fa, _, cen, reads = (os.path.join(db, n)
                                 for n in HG38_200K_INPUTS)
            extra = ("-centromeres", cen, "-simulated")
        res[tag] = _four_cards_run(tag, fa, reads, extra, env, logs, cpus,
                                   W, fails)
    print(f"  four-card figures: {json.dumps(res)}")
    if fails:
        raise AssertionError("four cards: " + "; ".join(fails))
    return res


def _four_cards_run(tag, fa, reads, extra, env, logs, cpus, W, fails):
    """Phase 22's four modes on one input (see phase_four_cards), every
    mode run before the checks that span modes; failures appended to
    ``fails``. Returns the figures."""
    base = os.path.join(SMOKE, f"four_{tag}")
    shutil.rmtree(base, ignore_errors=True)
    os.makedirs(base)
    t0 = time.time()
    shards = _fastq_shards(reads, FOUR, base)
    sizes = [k for _, k in shards]
    print(f"  {tag}: shards of {sizes} pairs in {time.time() - t0:.1f} s; "
          f"{cpus} CPUs, {W} workers a process, {FOUR * W} in the single "
          f"one")
    if sizes != [FOUR_SHARD_PAIRS[tag]] * FOUR:
        fails.append(f"{tag}: shards of {sizes} pairs")
    res = {"shard_pairs": sizes, "cpus": cpus, "workers": W}
    a_stats = None
    try:
        mem = _meminfo_gib('MemAvailable')
        peak = {}
        out, wall = _cli("lariat_tpu_torch.cli", "off", fa, reads,
                         os.path.join(base, "a"), FOUR * W,
                         os.path.join(logs, f"four_{tag}_a.log"), env, extra,
                         FOUR_TIMEOUT, peak)
        n, rate = _summary(out)
        a_stats = _sim_stats(out)
        res["a"] = {"pairs": n, "pairs_s": rate, "wall_s": round(wall, 1),
                    "rss_gib": round(peak["rss_gib"], 3),
                    "mem_available_gib": round(mem, 1),
                    "simulated": _SIMULATED.search(out).group(0)}
        print(f"  {tag} a (MemAvailable {mem:.1f} GiB before): "
              f"{json.dumps(res['a'])}")
    except Exception as e:  # noqa: BLE001 -- raised after every mode
        print(f"  {tag} a FAILED: {e}")
        fails.append(f"{tag} a: {e}")
    for mode in "bcd":
        try:
            res[mode] = _four_mode(tag, mode, fa, shards, extra, env, base,
                                   logs, W, fails)
        except Exception as e:  # noqa: BLE001 -- raised after every mode
            print(f"  {tag} {mode} FAILED: {e}")
            fails.append(f"{tag} {mode}: {e}")
    # the stats: equal in the four processes, their locals' sum, a's
    for mode in "bcd":
        figs = res.get(mode, {}).get("processes") or []
        if len(figs) != FOUR or not all(figs):
            continue
        glob_stats = [f["global_stats"] for f in figs]
        local_sum = [sum(c) for c in zip(*(f["local_stats"] for f in figs))]
        if any(g != local_sum for g in glob_stats) or (
                a_stats and local_sum != a_stats):
            fails.append(f"{tag} {mode}: global stats {glob_stats}, locals "
                         f"sum to {local_sum}, a's {a_stats}")
    # the records: b merged against a; c and d against b, process by
    # process, as records and as whole files
    rel = os.path.relpath(base, SMOKE)
    try:
        n_pos, n_bc = _merge_matches(
            [os.path.join(base, "b", f"host{h:03d}") for h in range(FOUR)],
            os.path.join(base, "a"), os.path.join(base, "b_merged.bam"), env)
        print(f"  {tag}: b's merge holds a's {n_pos} position-bucketed "
              f"records; its {n_bc} barcode-sorted ones in order")
    except Exception as e:  # noqa: BLE001 -- every comparison is made
        fails.append(f"{tag} b against a: {e}")
    for mode in "cd":
        for h in range(FOUR):
            run, ref = (f"{rel}/{m}/host{h:03d}" for m in (mode, "b"))
            try:
                _same_records(run, ref)
                phase_whole_bam([run], ref)
            except Exception as e:  # noqa: BLE001 -- every one is made
                fails.append(f"{tag} {mode} process {h} against b: {e}")
    shutil.rmtree(base, ignore_errors=True)
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--logs", default=SMOKE,
                   help="directory for the CLI runs' and the tools' logs")
    p.add_argument("--hg38-data", default=HG38_DIR,
                   help="phases 18 and 21's inputs (default data_big/; "
                        "tools/gen_data_big.py --hg38 builds only them, "
                        "--cut a smaller genome under the same names)")
    p.add_argument("--chr20-data", default=HG38_DIR,
                   help="phase 20's inputs (default data_big/; "
                        "tools/gen_data_big.py --chr20 builds only them)")
    args = p.parse_args(argv)
    os.makedirs(args.logs, exist_ok=True)
    with Phase("environment"):
        phase_environment()
    import torch
    with Phase("build"):
        phase_build()
    pk = _peaks()
    print(f"  peaks (card attributes): {json.dumps(pk)}")
    with Phase("kernels vs plain"):
        kres = phase_kernels(pk)
    with Phase("data"):
        fasta, reads = phase_data(SCALE, BARCODES, PAIRS_PER_BC)
    with Phase("seeding kernels vs plain"):
        sres, exh_launches, planes_launches = phase_seeding(fasta, reads,
                                                            pk)
    kres.update(sres)
    with Phase("align step kernels vs plain"):
        ares, step_entry, step_launches = phase_align_step(fasta, pk,
                                                           args.logs)
    kres.update(ares)
    env = {k: v for k, v in os.environ.items()
           if k not in ("LARIAT_TORCH_DEVICE", "LARIAT_DEVICE_SEED")}
    with Phase("host-native run"):
        host_out, host_s = _cli(
            "lariat_tpu_torch.cli", "off", fasta, reads,
            os.path.join(SMOKE, "out_host"), THREADS,
            os.path.join(args.logs, "host.log"), env)
        n_host, rate_host = _summary(host_out)
        print(f"  host-native: {n_host} pairs, {rate_host} pairs/s "
              f"({host_s:.1f}s wall with index load)")
    # each port run is a subprocess whose CLI resets its launch counts
    # before its main loop and prints them after
    runs = {}
    env = {k: v for k, v in env.items() if not k.startswith("LARIAT_PRIME")
           and k not in ("LARIAT_DEVICE_SOCKET",
                         "LARIAT_DEVICE_SERVER_CPU_OK")}
    # the all-primed runs: the router's own knobs leave it no reason to
    # host-route
    knobs = _all_primed(BARCODES * PAIRS_PER_BC)
    print(f"  router knobs of the all-primed port runs: {json.dumps(knobs)}")
    with Phase("port run"):
        runs["out_port"] = _port_run(fasta, reads, "out_port",
                                     os.path.join(args.logs, "port.log"),
                                     {**env, **knobs})
    with Phase("port run, device seeding"):
        runs["out_port_seed"] = _port_run(
            fasta, reads, "out_port_seed",
            os.path.join(args.logs, "port_seed.log"),
            {**env, **knobs, "LARIAT_DEVICE_SEED": "1"})
    with Phase("port run, router defaults"):
        runs["out_port_default"] = _port_run(
            fasta, reads, "out_port_default",
            os.path.join(args.logs, "port_default.log"), env)
    with Phase("port run through the resident server"):
        runs["out_port_server"] = _server_run(fasta, reads, env, args.logs)
    print(f"  pairs/s: host-seeded port {runs['out_port'][1]}, "
          f"device-seeded port {runs['out_port_seed'][1]}, router defaults "
          f"{runs['out_port_default'][1]}, through the server "
          f"{runs['out_port_server'][1]}, host-native {rate_host}")
    with Phase("tools"):
        launches = {k: runs["out_port"][4].get(k, 0) for k in CLI_KERNELS}
        launches.update({k: runs["out_port_seed"][4].get(k, 0)
                         for k in SEED_KERNELS})
        launches["smem_exhaustive"] = exh_launches
        launches.update({k: step_launches[k] for k in STEP_KERNELS})
        launches.update(planes_launches)
        launches["extend_ablate"] = phase_tools(fasta, reads, env, args.logs)
    with Phase("checks"):
        want_pairs = BARCODES * PAIRS_PER_BC
        for out, (n_port, _, primed, host_pairs, _) in runs.items():
            _same_records(out)
            if out in ("out_port", "out_port_seed"):
                if not (n_host == n_port == primed == want_pairs
                        and host_pairs == 0):
                    raise AssertionError(
                        f"{out} pairs: host {n_host}, port {n_port}, primed "
                        f"{primed}, host-routed {host_pairs}; want "
                        f"{want_pairs} all primed")
            elif not (n_host == n_port == primed + host_pairs == want_pairs
                      and primed > 0):
                raise AssertionError(
                    f"{out} pairs: host {n_host}, port {n_port}, primed "
                    f"{primed}, host-routed {host_pairs}; want {want_pairs}, "
                    f"some primed")
            print(f"  {out}: primed {primed}, host-routed {host_pairs}")
        srv = runs["out_port_server"][4]
        idle = [k for k in CLI_KERNELS if srv.get(k, 0) <= 0]
        if idle:
            raise AssertionError(f"the server launched no {idle}")
        idle = [k for k in KERNEL_INFO
                if k not in OFF_PATH and launches.get(k, 0) <= 0]
        if idle:
            raise AssertionError(f"kernels never launched on their "
                                 f"path: {idle}")
        # every K1 launch of both port runs went through its descriptor
        # entry (the wave's gathers folded into the kernel)
        for out, run in runs.items():
            n_k1 = run[4].get("sw_extend", 0)
            desc = run[4]["entries"].get("lariat_sw_extend_desc", 0)
            if desc != n_k1:
                raise AssertionError(f"{out}: {desc} of {n_k1} K1 launches "
                                     f"through the descriptor entry")
        walks = _cli_walks(runs["out_port_seed"][4]["walks"],
                           launches["sa_walk"])
        if runs["out_port"][4]["walks"]:
            raise AssertionError("the host-seeded run walked the SA on the "
                                 "card")
    with Phase("whole BAM"):
        phase_whole_bam(runs)
    with Phase("bench"):
        phase_bench(env, args.logs)
    with Phase("probe and entry"):
        phase_probe_entry(env, args.logs)
    with Phase("dryrun multichip"):
        dry = phase_dryrun()
    with Phase("multihost"):
        mh = phase_multihost(fasta, reads, env, args.logs)
    with Phase("host-native run, replay reads"):
        _, replay_reads = phase_data(SCALE, REPLAY_BARCODES, PAIRS_PER_BC)
        out, _ = _cli("lariat_tpu_torch.cli", "off", fasta, replay_reads,
                      os.path.join(SMOKE, "out_host_replay"), THREADS,
                      os.path.join(args.logs, "host_replay.log"), env)
        n_replay, rate_replay = _summary(out)
        print(f"  the replay phases' reads: {n_replay} pairs "
              f"({REPLAY_BARCODES} barcodes x {PAIRS_PER_BC}; phase 4's "
              f"{BARCODES * PAIRS_PER_BC} cut to this because the Python "
              f"replay runs in the priming threads); host-native "
              f"{rate_replay} pairs/s")
    new_paths = {}
    with Phase("port run, Python replay"):
        new_paths["python_replay"] = phase_new_path(
            fasta, replay_reads, "out_port_python",
            {"LARIAT_NO_NATIVE_ALIGN1": "1"}, env, args.logs, rate_replay)
    with Phase("auto seeding, background upload"):
        auto = phase_auto_upload(fasta, replay_reads)
    with Phase("hg38 scale"):
        hg = phase_hg38(args.hg38_data, env, args.logs,
                        chr20={k: kres[k][1] for k in SEED_KERNELS})
    with Phase("messy reads"):
        messy = phase_messy(fasta, env, args.logs)
    with Phase("chr20 x 1M pairs"):
        c20 = phase_chr20(args.chr20_data, env, args.logs)
    with Phase("hg38 x 200k, the CLI's device modes"):
        h200 = phase_hg38_200k(args.hg38_data, env, args.logs)
    with Phase("four cards, one multihost process a card"):
        four = phase_four_cards(args.chr20_data, args.hg38_data, env,
                                args.logs)
    desc = runs["out_port"][4]["entries"]["lariat_sw_extend_desc"]
    extra = {"smem_twoptr": {"seed_trace": kres.pop("seed_trace")},
             "sw_extend": {"desc_launches": desc,
                           "desc_wave": kres.pop("sw_extend_desc"),
                           "step_entry": step_entry},
             "sa_walk": {**walks, "lookup_entry": kres.pop("sa_lookup")}}
    # the scale-out paths' launches: the dry run's single and split runs,
    # the multihost processes' sum
    for k in CLI_KERNELS:
        extra.setdefault(k, {}).update(
            dryrun_launches={"single": dry["launches_single"].get(k, 0),
                             "split": dry["launches_split"].get(k, 0)},
            multihost_launches=sum(x.get(k, 0) for x in mh["launches"]))
    # the new paths' launches (phases 16-17), each run counted from 0
    extra["sw_extend"]["tile_launches"] = {
        k: v["tile"] for k, v in new_paths.items()}
    for k in ("sw_global", "traceback", "sw_local"):
        extra[k]["replay_launches"] = {p: v[k] for p, v in new_paths.items()}
    for k in SEED_KERNELS:
        extra.setdefault(k, {})["auto_upload_launches"] = auto[k]
    # phase 18's launches (its two all-primed CLI runs: auto seeding and
    # device seeding forced) and ms, or null; K4b's in its collect
    for k in SEED_KERNELS + ("sw_extend",):
        extra[k]["hg38"] = hg and {
            "launches": {"auto": hg["out_hg38_port"]["launches"][k],
                         "device_seed": hg["out_hg38_port_seed"]["launches"][
                             k]},
            "ms": hg["ms"][k]}
    extra.setdefault("smem_exhaustive", {})["hg38"] = hg and {
        "collect_launches": hg["k4b_collect_launches"]}
    # phase 19's runs and phase 20's ([launches, largest launch] a run, or
    # null)
    for name in KERNEL_INFO:
        extra.setdefault(name, {})["messy"] = {
            out: v["kernels"].get(name) for out, v in messy.items()
            if out.startswith("out_")}
        extra[name]["chr20_1m"] = c20 and {
            out: v["kernels"].get(name) for out, v in c20.items()
            if out.startswith("out_")}
        extra[name]["hg38_200k"] = h200 and {
            out: v["kernels"].get(name) for out, v in h200.items()
            if out.startswith("out_")}
        # phase 22's launches by mode, a list over the cards (null for a
        # process that failed), or null
        extra[name]["four_cards"] = four and {
            tag: {mode: [p and p.get("launches", {}).get(name, 0)
                         for p in r[mode]["processes"]]
                  for mode in "cd" if mode in r}
            for tag, r in four.items()}
    kernels = []
    for name, (src, replaces) in KERNEL_INFO.items():
        err, ms, pms, _, bms, by, *more = kres[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": pms,
                        "bound_ms": bms, "bound_by": by,
                        "library_ms": None, **(more[0] if more else {}),
                        **extra.get(name, {})})
    # what each kernel loses to its bound over its path's launches
    loss = {k["name"]: round(k["launches"] * (k["ms"] - k["bound_ms"]), 4)
            for k in kernels}
    print(f"  kernel loss, launches x (ms - bound_ms), ms: "
          f"{json.dumps(dict(sorted(loss.items(), key=lambda kv: -kv[1])))}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
