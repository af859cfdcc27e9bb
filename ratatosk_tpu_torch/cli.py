"""Command-line interface: `python -m ratatosk_tpu_torch.cli correct|index`.

Port of ratatosk_tpu/cli.py. The flag surface mirrors the reference CLI
(Ratatosk.cpp:149-185; usage text 23-143): same mandatory -s/-l/-o, same
pass selection -1/-2, same artifacts (`<out>.2.fastq` intermediate,
`<prefix>.index.k<k>` index files). `correct` runs on the CUDA devices
that `--devices` names; several hosts run it through
`python -m ratatosk_tpu_torch.distributed_correct`.

One deliberate difference from the JAX package's CLI: `--batch-regions`
defaults to CorrectOpt's 512, not 64. Padding rows of a launch are inert;
the batch size reaches the output only through the launch-wide step count
(a launch's longest region runs one step fewer than its others), which can
reorder tied entries of a region without a completed path. No such case is
known (tests/test_torch_cli.py).
"""

from __future__ import annotations

import argparse
import sys

from ratatosk_tpu_torch.config import CorrectOpt

VERSION = "0.1.0"
CITE = ("Holley, G. et al. Ratatosk: hybrid error correction of long reads\n"
        "enables accurate variant calling and assembly. Genome Biology 22:28 (2021)")


def _add_common(p: argparse.ArgumentParser, correct_mode: bool) -> None:
    p.add_argument("-s", "--in-short", action="append", default=[],
                   help="input short read file(s) in fasta/fastq(.gz), or list file")
    p.add_argument("-l", "--in-long", action="append", default=[],
                   help="input long read file(s) to correct, or list file")
    p.add_argument("-o", "--out-long", required=True,
                   help="output corrected long read file prefix")
    p.add_argument("-c", "--cores", type=int, default=1,
                   help="host worker threads: >1 overlaps planning of the "
                        "next batch with device execution of the current one")
    p.add_argument("-S", "--subsampling", type=float, default=1.0)
    p.add_argument("-u", "--in-unmapped-short", action="append", default=[])
    p.add_argument("-a", "--in-accurate-long", action="append", default=[])
    p.add_argument("-g", "--in-graph", default=None)
    p.add_argument("-Q", "--max-base-qual", type=int, default=40)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-1", "--1st-pass-only", dest="pass1_only", action="store_true")
    p.add_argument("-2", "--2nd-pass-only", dest="pass2_only", action="store_true")
    p.add_argument("-i", "--insert-sz", type=int, default=500)
    p.add_argument("-k", "--k1", type=int, default=31)
    p.add_argument("-K", "--k2", type=int, default=63)
    p.add_argument("-M", "--min-conf-color2", type=float, default=0.0)
    p.add_argument("-C", "--min-len-color2", type=int, default=3000)
    p.add_argument("-F", "--no-snp-correction", action="store_true")
    p.add_argument("-I", "--no-graph-index", action="store_true")
    if correct_mode:
        p.add_argument("-t", "--trim-split", type=int, default=0)
        # the .npz index given with -g already holds the unitig data: -d is
        # read only by CorrectOpt.validate (-d without -g is an error)
        p.add_argument("-d", "--in-unitig-data", default=None)
        p.add_argument("-G", "--gzip-out", action="store_true")
        p.add_argument("-O", "--force-io-order", action="store_true",
                       help="keep output in input order (always satisfied: "
                            "this implementation writes inherently in order)")
        p.add_argument("-m", "--min-conf-snp-corr", type=float, default=0.9)
        p.add_argument("-f", "--fix-snps", action="store_true",
                       help="resolve leftover ambiguity (IUPAC) against the "
                            "graph in pass 2 (fixSNPs)")
        p.add_argument("-w", "--max-len-weak1", type=int, default=1000)
        p.add_argument("-W", "--max-len-weak2", type=int, default=5000)
        p.add_argument("-r", "--correction-rounds", type=int, default=1)
        p.add_argument("-L", "--in-long-raw", action="append", default=[])
        p.add_argument("-p", "--in-short-phase", action="append", default=[])
        p.add_argument("-P", "--in-long-phase", action="append", default=[])
    # device knobs
    p.add_argument("--beam-width", type=int, default=16)
    p.add_argument("--batch-regions", type=int,
                   default=CorrectOpt.batch_regions,
                   help="weak regions per device launch")
    p.add_argument("--devices", type=int, default=0,
                   help="local GPUs to drive (0 = all visible): region "
                        "batches split over a mesh across them")
    p.add_argument("--auto-subsample", action="store_true",
                   help="coverage-stratified color subsampling when estimated "
                        "coverage >= 10 (addCoverage phase 5); off by default "
                        "— see docs/subsampling.md for the recorded trade")
    p.add_argument("--spill-bytes", type=int, default=None,
                   help="spill sorted color pairs to disk past this many "
                        "bytes (the reference's 4 GB PairID spill)")
    p.add_argument("--trace-json", default=None,
                   help="append structured JSONL telemetry events here")
    p.add_argument("--shard-retries", type=int, default=1,
                   help="distributed: per-shard retry budget before aborting")


def _build_opt(args, index_mode: bool) -> CorrectOpt:
    opt = CorrectOpt(
        k=args.k2, small_k=args.k1,
        filename_seq_in=list(args.in_short),
        filename_long_in=list(args.in_long),
        filename_helper_long_in=list(args.in_accurate_long),
        prefix_filename_out=args.out_long,
        filename_graph_in=args.in_graph,
        filename_data_in=getattr(args, "in_unitig_data", None),
        max_qual=args.max_base_qual,
        trim_qual=getattr(args, "trim_split", 0),
        insert_sz=args.insert_sz,
        min_confidence_2nd_pass=args.min_conf_color2,
        min_len_2nd_pass=args.min_len_color2,
        min_confidence_snp_corr=getattr(args, "min_conf_snp_corr", 0.9),
        max_len_weak_region1=getattr(args, "max_len_weak1", 1000),
        max_len_weak_region2=getattr(args, "max_len_weak2", 5000),
        filenames_long_raw=list(getattr(args, "in_long_raw", [])),
        filename_phase_short=list(getattr(args, "in_short_phase", [])),
        filename_phase_long=list(getattr(args, "in_long_phase", [])),
        filename_unmapped_in=list(args.in_unmapped_short),
        sampling_rate=args.subsampling,
        nb_correction_rounds=getattr(args, "correction_rounds", 1),
        nb_threads=args.cores,
        verbose=args.verbose,
        gzip_out=getattr(args, "gzip_out", False),
        no_snp_correction=args.no_snp_correction,
        fix_snps=getattr(args, "fix_snps", False),
        force_io_order=getattr(args, "force_io_order", False),
        pass1_only=args.pass1_only,
        pass2_only=args.pass2_only,
        index_only=index_mode,
        beam_width=args.beam_width,
        batch_regions=args.batch_regions,
        n_devices=args.devices,
        auto_subsample=args.auto_subsample,
        spill_bytes=args.spill_bytes,
        trace_json=args.trace_json,
        shard_retries=args.shard_retries,
    )
    if opt.pass1_only and opt.pass2_only:
        raise SystemExit("-1 and -2 are mutually exclusive (Ratatosk.cpp:402-411)")
    if not opt.filename_seq_in and not opt.filename_graph_in:
        raise SystemExit("missing -s (short reads) or -g (prebuilt graph)")
    if not index_mode and not opt.filename_long_in:
        raise SystemExit("missing -l (long reads)")
    return opt


def main(argv=None, *, device="cuda") -> int:
    """device: where `correct` runs (the command line always names the
    CUDA device; tests pass "cpu"). `index` is host-only."""
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--version"]:
        print(VERSION)
        return 0
    if argv[:1] == ["--cite"]:
        print(CITE)
        return 0
    ap = argparse.ArgumentParser(
        prog="ratatosk-tpu-torch",
        description="GPU hybrid error correction of long reads "
                    "using colored de Bruijn graphs")
    sub = ap.add_subparsers(dest="command", required=True)
    pc = sub.add_parser("correct", help="correct long reads with short reads")
    _add_common(pc, correct_mode=True)
    pi = sub.add_parser("index", help="prepare an index (advanced)")
    _add_common(pi, correct_mode=False)
    args = ap.parse_args(argv)

    from ratatosk_tpu_torch import pipeline
    if args.command == "index":
        if not (args.pass1_only or args.pass2_only):
            raise SystemExit("index requires -1 or -2")
        pipeline.run_index(_build_opt(args, True))
    else:
        pipeline.run_correct(_build_opt(args, False), device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
