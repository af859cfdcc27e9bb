"""Correction options — mirrors the reference's Correct_Opt defaults.

Reference: src/Common.hpp:16-158 (struct Correct_Opt, defaults at 101-156).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass
class CorrectOpt:
    """All tunables of the two-pass correction pipeline.

    Field names and defaults follow the reference (Common.hpp:101-156) so a
    reference user can map flags 1:1; TPU-specific knobs sit at the bottom.
    """

    # -- k-mer sizes (Common.hpp:101,117: k=63, small_k=31) --
    k: int = 63          # pass-2 k-mer size (large k)
    small_k: int = 31    # pass-1 k-mer size

    # -- input/output --
    filename_seq_in: List[str] = dataclasses.field(default_factory=list)   # short reads
    filename_long_in: List[str] = dataclasses.field(default_factory=list)  # long reads to correct
    filename_helper_long_in: List[str] = dataclasses.field(default_factory=list)  # -a helper LRs
    filenames_long_raw: List[str] = dataclasses.field(default_factory=list)  # pass-2 raw LRs
    filename_phase_short: List[str] = dataclasses.field(default_factory=list)  # -p TSVs
    filename_phase_long: List[str] = dataclasses.field(default_factory=list)   # -P TSVs
    filename_unmapped_in: List[str] = dataclasses.field(default_factory=list)  # -u rescue
    prefix_filename_out: str = "ratatosk"
    filename_graph_in: Optional[str] = None   # -g pre-built graph
    filename_data_in: Optional[str] = None    # -d pre-built graph data

    # -- quality (Common.hpp:113-115; README.md:75,113) --
    max_qual: int = 40     # -Q: 40 for R9.4, 90 for R10
    out_qual: int = 1      # output quality scores
    trim_qual: int = 0     # -t: trim/split on min quality

    # -- coverage / color caps (Common.hpp:118-128) --
    min_cov_vertices: int = 2     # min shared reads for a supported edge
    max_cov_vertices: int = 128   # color-set cap per unitig
    max_km_cov: int = 128
    top_km_cov_ratio: float = 0.001

    # -- correction loop (Common.hpp:129-156) --
    nb_correction_rounds: int = 1      # -r
    max_len_weak_region1: int = 1000   # pass-1 weak region cap (bp)
    max_len_weak_region2: int = 5000   # pass-2 weak region cap (bp)
    min_len_2nd_pass: int = 3000       # min corrected-read length colored in pass 2
    insert_sz: int = 500               # paired-end insert size
    weak_region_len_factor: float = 0.25
    sampling_rate: float = 1.0
    min_confidence_snp_corr: float = 0.9
    min_confidence_2nd_pass: float = 0.0
    min_nb_km_unmapped: int = 31       # -u missing-read rescue threshold
    # coverage-stratified color subsampling (addCoverage phase 5,
    # Graph.cpp:2312-2871). Off by default: our color storage is capped +
    # disk-spilled so memory doesn't require it, and the recorded experiment
    # (docs/subsampling.md) shows ~5x residual-error cost at 40x coverage.
    auto_subsample: bool = False
    # spill sorted (unitig, read) pair chunks to disk past this many bytes
    # (the reference's 4 GB PairID spill, Common.hpp:136); None = in-memory
    spill_bytes: Optional[int] = None
    # structured JSONL telemetry (ratatosk_tpu_torch/trace.py); None = off
    trace_json: Optional[str] = None
    # distributed per-shard retry budget + checkpointed resume
    # (Ratatosk_nf/nextflow.config:63-82 maxRetries analog)
    shard_retries: int = 1
    no_snp_correction: bool = False    # -F: disable SNP detection/handling
    fix_snps: bool = False             # -f: resolve leftover IUPAC against
                                       # the graph in pass 2 (fixSNPs,
                                       # Alignment.cpp:846-965)

    # -- execution --
    nb_threads: int = 1
    verbose: bool = False
    gzip_out: bool = False         # -G
    force_io_order: bool = False   # -O
    pass1_only: bool = False       # -1
    pass2_only: bool = False       # -2
    index_only: bool = False       # `index` subcommand

    # -- TPU-specific knobs (no reference counterpart) --
    # open (head/tail) regions have no right anchor to certify a path; accept
    # the beam's walk only when it matches the raw target this well (1 - edit
    # rate). A true correction sits near the read's error rate (~0.85-0.9);
    # a wrong repeat walk scores far below 0.5. Defaults calibrated against
    # ground truth (docs/gates.md): raising to 0.6/0.5 cut residual error
    # ~27% with no loss of corrected coverage.
    min_score_open_region: float = 0.6
    # a COMPLETED (anchor-certified) path must still resemble the raw span:
    # a wrong-locus leg through a repeat completes at the right anchor but
    # diverges from the read almost everywhere; true legs sit near the
    # read's error rate (~0.85+ at 10-15% error)
    min_score_closed_region: float = 0.5
    # weak (1-edit) seed waypoints inside long anchor-free spans (the
    # reference's masked inexact re-search + semi-weak path hops,
    # Graph.cpp:100-196, Correction.cpp:3-157)
    use_weak_seeds: bool = True
    weak_seed_min_gap: int = 200    # probe spans at least this long (bp)
    weak_seed_min_space: int = 64   # min spacing between waypoints / edges
    # probe every Nth window position for 1-edit variants (exact windows are
    # always probed at every position). Wrong-placement risk at skipped
    # positions is contained by exact-placement priority and the closed/open
    # region acceptance gates.
    weak_seed_stride: int = 2
    beam_width: int = 16          # beam entries per weak region
    band_width: int = 192         # DP band for long regions (edlib-style);
                                  # regions <= 256 bp always run exact
    batch_regions: int = 512      # weak regions scored per device batch
    # shard the k-mer index across the mesh (range partition + pmax combine)
    # when it holds at least this many keys; below it, replicate per device
    # (the reference replicates its index per node, Ratatosk.nf:280)
    shard_index_min_keys: int = 1 << 27
    # local devices driven by one process: 0 = all visible devices, 1 =
    # single-device. With >1 the region batches shard over a data-axis Mesh
    # (parallel/mesh.py) — the per-node fan-out of the reference's 32-way
    # worker pool (Ratatosk_nf/Ratatosk.nf:139-164)
    n_devices: int = 0
    read_batch_bp: int = 1 << 20  # ~1MB of read data per host batch (Common.hpp:138)
    # run batch planning (anchor lookup + 1-edit seed probe) as async device
    # dispatches (ops/plan_device.py) instead of the native host kernels.
    # Default OFF: the r5 A/B on the bench chip (1 Mbp genome, 5 Mbp reads,
    # identical config) measured host 154.9k b/s vs device 96.1k — with the
    # double-buffer the host planner runs on otherwise-idle cores, while
    # planner kernels serialize against beam launches on the single chip
    # (device-mode finish timers inflate 2-3x from that contention). Turn on
    # when the host, not the chip, is the bottleneck.
    plan_on_device: bool = False
    min_count_kmer: int = 2       # k-mers need >=2 occurrences from reads (Bifrost contract)
    # pass 2 skips regions whose (pass-1) quality is already maximal
    # (Correction.cpp:779,808,941); never set for raw sequencer quality
    skip_max_quality_regions: bool = False

    def validate(self) -> None:
        # graph (-g) and unitig data (-d) must be loaded together
        # (Ratatosk.cpp:415-419). Our .npz index bundles both, so -d is
        # optional alongside -g, but -d alone is the reference's error.
        if self.filename_data_in and not self.filename_graph_in:
            raise ValueError(
                "-d (unitig data) requires -g (graph): the index must be "
                "loaded together (Ratatosk.cpp:415-419); note the .npz index "
                "already bundles both")
        if not (0 < self.small_k <= 32):
            raise ValueError(f"small_k must be in (0,32], got {self.small_k}")
        if not (0 < self.k <= 64):
            raise ValueError(f"k must be in (0,64], got {self.k}")
        if self.small_k >= self.k:
            raise ValueError("small_k must be < k")
        if self.max_qual not in (40, 90):
            # reference accepts only these two scales (README.md:75,113)
            raise ValueError("max_qual must be 40 (R9.4) or 90 (R10)")
