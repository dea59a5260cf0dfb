"""Configuration and score constants for the TPU-native linked-read aligner.

Score/threshold parity with the reference (10XGenomics/lariat + BWA-MEM) is what
defines SAM equivalence, so every constant is catalogued here with its origin:

- BWA-MEM alignment engine defaults: reference consumes ``mem_opt_init()``
  (reference ``go/src/gobwa/gobwa.go:149-153``); the values below are the
  published BWA-MEM defaults that routine installs.
- Lariat RFA constants: reference ``go/src/inference/lariat.go`` (cited inline).
- Pair/insert model: reference ``go/src/gobwa/gobwa.go:230-237`` and
  ``go/src/inference/lariat.go:1102-1133``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AlignerConfig:
    """BWA-MEM-compatible alignment engine parameters (mem_opt_init defaults)."""

    # Scoring (bwa mem defaults: match 1, mismatch 4, gap open 6, gap extend 1)
    match_score: int = 1
    mismatch_penalty: int = 4
    gap_open_del: int = 6
    gap_extend_del: int = 1
    gap_open_ins: int = 6
    gap_extend_ins: int = 1
    # Banding / drop-off
    band_width: int = 100          # w
    zdrop: int = 100               # Z-dropoff
    # Clipping penalties
    pen_clip5: int = 5
    pen_clip3: int = 5
    pen_unpaired: int = 17         # used by bwa pairing; lariat uses its own
    # Seeding
    min_seed_len: int = 19
    split_factor: float = 1.5      # re-seed MEMs longer than min_seed_len*1.5
    split_width: int = 10          # re-seed if occurrence count <= this
    max_occ: int = 500             # skip seeds with more occurrences
    max_mem_intv: int = 20         # 3rd-round (LAST-like) seeding threshold
    min_3rd_seed_len: int = 20     # 3rd-round minimum seed length
    # Chaining
    max_chain_gap: int = 10000
    drop_ratio: float = 0.50       # chain drop ratio
    min_chain_weight: int = 0
    max_chain_extend: int = 1 << 30
    # Region filtering / primary marking
    mask_level: float = 0.50
    mask_level_redun: float = 0.95
    min_output_score: int = 30     # opt->T
    # Mate rescue
    max_matesw: int = 50


@dataclasses.dataclass(frozen=True)
class PairModel:
    """Hard-coded insert-size prior used by mate rescue.

    Reference: gobwa.go:230-237 (mem_pestat_t for FR orientation only).
    """

    low: int = -35
    high: int = 500
    avg: float = 200.0
    std: float = 100.0
    failed: bool = False


@dataclasses.dataclass(frozen=True)
class RFAConfig:
    """Lariat RFA inference constants (reference lariat.go)."""

    improper_pair_penalty: float = -4.0   # main.go:10 default
    # GetChains mate-rescue candidate window (lariat.go:475: score_delta=25)
    chain_score_delta: int = 25
    # GetAlignments keep-delta vs per-read best score (lariat.go:476: delta=17)
    alignment_score_delta: int = 17
    # Proper-pair window: -35 <= reverse.pos - forward.pos < 750 (lariat.go:1132)
    pair_min_dist: int = -35
    pair_max_dist: int = 750
    # Molecule segmentation gap (lariat.go:1376)
    molecule_gap: int = 50000
    # isActiveMolecule thresholds (lariat.go:1309-1319)
    active_min_reads: int = 4        # active > 4
    active_min_density: float = 0.1  # active/potential >= 0.1
    # "Unmapped" demotion rule (lariat.go:143-148, bamwriter.go:290-293):
    # not proper AND score - 17 < 19
    unmapped_score_offset: int = 17
    unmapped_score_threshold: int = 19
    # scoreAlignment weights (lariat.go:599-624)
    mismatch_weight: float = -2.0
    indel_weight: float = -3.0
    softclip_side_weight: float = -5.0
    softclip_base_weight: float = -0.5
    # psuedoCountAlignmentScore (lariat.go:590-597)
    pseudo_alignment_length: float = 25.0
    pseudo_max_softclip_penalty: float = -10.0
    # Molecule birth/death terms in fastScore (lariat.go:1271-1298)
    molecule_flip_weight: float = -0.5   # * best_alignment_for_read count
    molecule_empty_fill_term: float = -3.0
    # calculateLogMoleculePenalty (lariat.go:792-825)
    genome_length: float = 3.2e9         # hard-coded human genome length
    singleton_prob: float = 0.05
    dna_length_base: float = 1000.0
    # MAPQ (lariat.go:963-989)
    mapq_cap: float = 60.0
    mapq_top_k: int = 15                  # top-15 scores in normalization
    # Optimizer schedule (lariat.go:513, optimizer.go)
    opt_temperature_steps: int = 2
    opt_sweeps_factor: int = 4            # steps = 4 * n_molecules per ladder step
    # Split reads (split.go)
    split_min_unmapped: int = 15          # needs > len-15 NOT mapped
    split_min_score: int = 36
    # worthRunningRFA (lariat.go:1088-1100)
    min_reads_for_rfa: int = 5
    # FASTQ barcode-set reader (reader.go:205,226-235)
    max_reads_per_batch: int = 30000
    nonwhitelist_flush: int = 200
    # simulated-truth tolerance (lariat.go:533)
    sim_pos_tolerance: float = 600.0


@dataclasses.dataclass(frozen=True)
class BatchConfig:
    """Static padding/bucketing sizes for jit-compiled device batches."""

    read_len: int = 151             # padded read length
    # Bucket sizes for reads-per-device-batch (powers to limit recompiles)
    read_buckets: tuple = (128, 512, 2048, 8192, 32768)
    max_seeds_per_read: int = 64
    max_regions_per_read: int = 48
    sw_band: int = 100


DEFAULT_ALIGNER = AlignerConfig()
DEFAULT_PAIR = PairModel()
DEFAULT_RFA = RFAConfig()
DEFAULT_BATCH = BatchConfig()

