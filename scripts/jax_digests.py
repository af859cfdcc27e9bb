#!/usr/bin/env python3
"""Run the JAX package (ratatosk_tpu) on the CPU and record its FASTQ digests
in ratatosk_tpu_torch/data/jax_digests.json, which every run of the port on
the same data and options is held to (ratatosk_tpu_torch/digests.py).

    JAX_PLATFORMS=cpu python3 scripts/jax_digests.py [ENTRY ...]
        [--out PATH] [--list]

With no ENTRY, every entry runs, one after the other. Each entry's data is
made by the port's own generators, byte for byte what a run of the port on
the card reads: bench_torch.py's simulation (bench_*, cli_default,
cli_small: written as scripts/dist_scale_torch.py writes it) and
chip_smoke.py's quarter_data (cli_quarter). The JAX package then runs the
entry's route on it:

  bench_default  bench.py's route (Corrector, correct_file,
                 build_pass2_index; no SNPs or edge rescue) at its full
                 default: 4 Mbp, 5,000 x 4 kbp reads, k 31/63, beam 16,
                 512 regions a launch, 2 threads, 1 MiB read batches;
  bench_smoke    the same at chip_smoke.py [bench]'s size, 1 Mbp and 64
                 reads;
  cli_default    the `correct` command (SNP detection and pass-1 edge
                 rescue on) with scripts/dist_scale_torch.py's flags on its
                 data, at the default size;
  cli_small      the same at `small` (100 kbp, 64 reads);
  cli_quarter    the `correct` command with chip_smoke.py [cli quarter]'s
                 flags (-c 2 --devices 1, and --batch-regions 512, the
                 port's default, which the JAX command defaults to 64) on
                 its quarter of the slice (1 Mbp, 64 reads);
  cut            bench.py's route at tests/test_torch_bench.py's size (20
                 kbp, 6 reads, beam 8, 32 regions a launch, 8 KiB batches),
                 which tests/test_torch_jax_digests.py recomputes.

Each entry records the data rule, the options or flags, the sha256 of its
input files and of pass 1's and the final FASTQ, the repo commit and the
seconds it took; entries not run keep what the file held. The full-size
entries take about 20 minutes each on 8 CPU cores.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import bench_torch  # noqa: E402
import chip_smoke  # noqa: E402
import dist_scale_torch  # noqa: E402
from ratatosk_tpu_torch import digests  # noqa: E402

# tests/test_torch_bench.py's cut (SIZE, BATCH_BP, OPT)
CUT_SIZE = ("20000", "6")
CUT_OPTIONS = dict(beam_width=8, batch_regions=32, read_batch_bp=1 << 13)
# chip_smoke.py's slice size, which [cli quarter] quarters
SLICE = (4_000_000, 256)
QUARTER_FLAGS = chip_smoke.cli_flags()


def bench_entry(size_args, options: dict, workdir: str) -> dict:
    """bench.py's route through the JAX package on bench_torch.py's data."""
    from ratatosk_tpu.config import CorrectOpt
    from ratatosk_tpu.correct.engine import Corrector
    from ratatosk_tpu.graph import build as B
    from ratatosk_tpu.graph.colors import color_graph
    from ratatosk_tpu.io import fastx
    from ratatosk_tpu.pipeline import (_pass_opt, build_pass2_index,
                                       correct_file)
    glen, n_reads, repeat_frac, repeat_len = bench_torch.sizes(
        list(size_args))
    options = bench_torch.bench_options(**options)
    rng, genome, sreads = bench_torch.simulate_short(
        bench_torch.SEED, glen, repeat_frac, repeat_len)
    opt = CorrectOpt(**options)
    o1, o2 = _pass_opt(opt, 1), _pass_opt(opt, 2)
    cdbg = B.build_cdbg(sreads, 31, min_count=2)
    corr1 = Corrector(cdbg, color_graph(cdbg, sreads), o1)
    lr = os.path.join(workdir, "long.fq")
    bench_torch.write_long_reads(rng, genome, n_reads, lr)
    inputs = {"short.fa": digests.short_fasta_sha256(sreads),
              "long.fq": digests.file_sha256(lr)}
    p1, p2 = (os.path.join(workdir, n) for n in ("out.2.fastq", "out.fastq"))
    correct_file(corr1, o1, [lr], p1, 1)
    cdbg2, colors2 = build_pass2_index(
        opt, ((r.codes, r.qual) for r in fastx.read_fastx(p1)), sreads,
        list(range(len(sreads))))
    correct_file(Corrector(cdbg2, colors2, o2), o2, [p1], p2, 2)
    return dict(route="bench",
                data=bench_torch.data_rule(size_args, bench_torch.SEED),
                options=options, inputs_sha256=inputs, out=(p1, p2))


def cli_run(flags: list, short_fa: str, long_fq: str, workdir: str):
    """The JAX `correct` command; returns (pass 1, final) FASTQ paths."""
    from ratatosk_tpu import cli
    out = os.path.join(workdir, "out")
    rc = cli.main(["correct", "-s", short_fa, "-l", long_fq, "-o", out,
                   *flags, "-v"])
    if rc:
        raise RuntimeError(f"the JAX correct command exited {rc}")
    return out + ".2.fastq", out + ".fastq"


def cli_entry(size_args, workdir: str) -> dict:
    """The JAX `correct` command on scripts/dist_scale_torch.py's data and
    flags."""
    data = dist_scale_torch.simulate(size_args, bench_torch.SEED, workdir)
    flags = dist_scale_torch.flags()
    return dict(route="cli",
                data=bench_torch.data_rule(size_args, bench_torch.SEED),
                options=flags,
                inputs_sha256={"short.fa": digests.file_sha256(
                    data["short_fa"]), "long.fq": digests.file_sha256(
                    data["long_fq"])},
                out=cli_run(flags, data["short_fa"], data["long_fq"],
                            workdir))


def quarter_entry(workdir: str) -> dict:
    """The JAX `correct` command on chip_smoke.py's [cli quarter] data."""
    q = chip_smoke.quarter_data(workdir, *SLICE)
    short_fa = os.path.join(workdir, "quarter.short.fa")
    chip_smoke._write_short_fasta(q["sreads"], short_fa)
    return dict(route="cli", data=chip_smoke.quarter_rule(*SLICE),
                options=QUARTER_FLAGS,
                inputs_sha256={"short.fa": digests.file_sha256(short_fa),
                               "long.fq": digests.file_sha256(q["lr_path"])},
                out=cli_run(QUARTER_FLAGS, short_fa, q["lr_path"], workdir))


ENTRIES = {
    "bench_default": lambda w: bench_entry((), {}, w),
    "bench_smoke": lambda w: bench_entry(chip_smoke.BENCH_ARGS[:2], {}, w),
    "cli_default": lambda w: cli_entry((), w),
    "cli_small": lambda w: cli_entry(("small",), w),
    "cli_quarter": quarter_entry,
    "cut": lambda w: bench_entry(CUT_SIZE, CUT_OPTIONS, w),
}


def commit() -> str:
    """HEAD, with "+dirty" when the JAX package differs from it."""
    def git(*args):
        return subprocess.run(["git", *args], cwd=ROOT, capture_output=True,
                              text=True).stdout.strip()
    head = git("rev-parse", "HEAD") or "unknown"
    return head + ("+dirty" if git("status", "--porcelain", "--",
                                   "ratatosk_tpu") else "")


def run_entry(name: str) -> dict:
    import jax
    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix=f"jax_digests_{name}_") as w:
        e = ENTRIES[name](w)
        p1, p2 = e.pop("out")
        e["fastq_sha256"] = {"pass1": digests.file_sha256(p1),
                             "final": digests.file_sha256(p2)}
    return dict(name=name, script=digests.SCRIPT, **e,
                platform=jax.default_backend(), jax=jax.__version__,
                commit=commit(), seconds=round(time.time() - t0, 1))


def write(path: Path, entries: dict) -> None:
    """Merge `entries` into the file at `path` (read just before writing,
    so that runs of other entries in other processes are kept)."""
    old = json.loads(path.read_text())["entries"] if path.exists() else {}
    old.update(entries)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    tmp.write_text(json.dumps(
        {"written_by": digests.SCRIPT,
         "entries": {n: old[n] for n in sorted(old)}}, indent=1) + "\n")
    os.replace(tmp, path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("entries", nargs="*", help=f"of {', '.join(ENTRIES)}")
    ap.add_argument("--out", default=str(digests.PATH))
    ap.add_argument("--list", action="store_true",
                    help="print the entries' names and stop")
    args = ap.parse_args(argv)
    if args.list:
        print("\n".join(ENTRIES))
        return 0
    bad = [n for n in args.entries if n not in ENTRIES]
    if bad:
        ap.error(f"unknown entries {bad}: of {list(ENTRIES)}")
    for name in args.entries or list(ENTRIES):
        print(f"[jax_digests] {name} ...", file=sys.stderr, flush=True)
        e = run_entry(name)
        write(Path(args.out), {name: e})
        print(f"[jax_digests] {name}: {e['fastq_sha256']} inputs "
              f"{e['inputs_sha256']} in {e['seconds']}s", file=sys.stderr,
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
