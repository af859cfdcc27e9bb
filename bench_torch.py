"""Benchmark of the PyTorch + CUDA port: corrected long-read bases/sec/chip
over the full two-pass flow, as bench.py measures the JAX package.

bench.py step for step through ratatosk_tpu_torch on cuda:0: the same
simulated data byte for byte (np.random.default_rng(--seed), genome, then
short reads, then long reads), the same options (k 31/63, beam 16, 512
regions a launch, 2 threads, 1 MiB read batches), the same untimed set-up
(index builds; the kernel library's nvcc build in a thread while the pass-1
index builds; warmup_compile and the first 64 reads of each pass corrected
once) and the same timed window: every input long base counted once, the
clock over pass 1 plus pass 2, each pass ending in torch.cuda.synchronize().

--repeats N runs pass 1 N times on the same warm Corrector, builds the
pass-2 index once from the first run's output, then runs pass 2 N times.
Every run's FASTQ must equal the first run's (sha256). `value` is the
median run's bases/s (the lower median for an even N), and pass1_s and
pass2_s are that run's; every run's figure is listed too. --plan device
plans on the card (plan_on_device=True, bench.py's RTPU_PLAN_DEV=1).

Checks, each of which raises: every read written in input order; pass 2's
error on the first 400 reads below a fifth of the raw error; on the card,
each pass launched the fused beam and finish kernels, and with --plan
device the planner's runs and probe kernels too, and not every batch fell
back to the host. --trace runs pass 1 once more, untimed, under
torch.profiler: the device busy share, the plan / launch / finish shares
and the six kernels with the most device time; its FASTQ must equal the
timed runs'.

Usage:
    python3 bench_torch.py [small | <genome_bp> [n_reads]] [--repeats N]
        [--plan host|device] [--seed 1234] [--trace] [--device cuda]
Progress goes to stderr as "[bench] ..."; the last line of stdout is one
JSON object with bench.py's keys (metric, value, unit, vs_baseline,
phases_s, pass1_s, pass2_s, total_wall_s) and the port's. --device cpu is
for the tests only: there the kernels' wrappers take their plain versions.
"""

from __future__ import annotations

import time

T_START = time.time()   # the "imports" phase opens here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from concurrent.futures import ThreadPoolExecutor  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ratatosk_tpu_torch import digests, dna, testing  # noqa: E402
from ratatosk_tpu_torch.config import CorrectOpt  # noqa: E402
from ratatosk_tpu_torch.correct.engine import Corrector  # noqa: E402
from ratatosk_tpu_torch.graph import build as B  # noqa: E402
from ratatosk_tpu_torch.graph.colors import color_graph  # noqa: E402
from ratatosk_tpu_torch.io import fastx  # noqa: E402
from ratatosk_tpu_torch.ops import (beam_kernel, cuda_lib,  # noqa: E402
                                    finish_kernel, plan_kernel)
from ratatosk_tpu_torch.ops import cigar as CG  # noqa: E402
from ratatosk_tpu_torch.pipeline import (_pass_opt,  # noqa: E402
                                         build_pass2_index, correct_file)

METRIC = "corrected_long_read_bases_per_sec_per_chip_2pass"
BASELINE_BASES_PER_SEC = 100_000.0   # bench.py's fixed reference point
READ_LEN = 4000
RAW_ERR = 0.10
N_TRUTH = 400          # long reads scored against their truth
N_WARM = 64            # long reads of each pass's untimed warm-up
SEED = 1234
# bench.py's options (bench.py:96), as CorrectOpt fields
OPTIONS = dict(small_k=31, k=63, beam_width=16, batch_regions=512,
               nb_threads=2, read_batch_bp=1 << 20)
# the kernels of the main path, by the name of their wrapper; the planner's
# two launch only with --plan device
PATH_KERNELS = {"fused_beam_search": beam_kernel.fused_beam_search,
                "finish_bundle_kernel": finish_kernel.finish_bundle_kernel}
PLAN_KERNELS = {"runs_kernel": plan_kernel.runs_kernel,
                "probe_kernel": plan_kernel.probe_kernel}
KERNELS = {**PATH_KERNELS, **PLAN_KERNELS}


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


class Phases:
    """Full-wall accounting as in bench.py: each phase runs until the next
    opens, so the phases sum to the wall from `t0`."""

    def __init__(self, first: str, t0: float):
        self.seconds, self.cur, self.t0, self.t = {}, first, t0, t0

    def open(self, name: str) -> None:
        now = time.time()
        self.seconds[self.cur] = self.seconds.get(self.cur, 0.0) + now - self.t
        self.cur, self.t = name, now

    def close(self) -> float:
        """Closes the open phase; returns the wall seconds since t0."""
        self.open(None)
        return self.t - self.t0


def sizes(size_args) -> tuple:
    """(genome bp, long reads, repeat fraction, repeat length) from
    bench.py's positional arguments (bench.py:69-80)."""
    if size_args and size_args[0] == "small":
        return 100_000, 64, 0.1, 300
    if size_args:
        glen = int(float(size_args[0]))
        n_reads = (int(size_args[1]) if len(size_args) > 1
                   else max(glen // 800, 8))
        return glen, n_reads, 0.15, 250
    return 4_000_000, 5000, 0.15, 250


def bench_options(**overrides) -> dict:
    """bench.py's options with `overrides` (CorrectOpt fields) over them:
    a run's options, and its key among the JAX package's digests."""
    return {**OPTIONS, **overrides}


def data_rule(size_args, seed: int) -> dict:
    """The data of a run (simulate_short, then write_long_reads): its key
    among the JAX package's digests."""
    glen, n_reads, repeat_frac, repeat_len = sizes(list(size_args))
    return dict(generator="bench_torch.simulate_short+write_long_reads",
                seed=seed, genome_bp=glen, n_long_reads=n_reads,
                repeat_frac=repeat_frac, repeat_len=repeat_len,
                read_len=READ_LEN, raw_err=RAW_ERR)


def simulate_short(seed: int, glen: int, repeat_frac: float,
                   repeat_len: int):
    """(rng, genome, short reads), drawn as bench.py draws them; the rng's
    stream goes on into the long reads (write_long_reads)."""
    rng = np.random.default_rng(seed)
    genome = testing.random_genome(rng, glen, repeat_frac=repeat_frac,
                                   repeat_len=repeat_len)
    return rng, genome, testing.short_reads(rng, genome, coverage=40.0)


def write_long_reads(rng, genome, n_reads: int, path: str):
    """bench.py's long-read FASTQ, byte for byte; returns (truths of the
    first N_TRUTH reads by name, bases written)."""
    truths, total = {}, 0
    with open(path, "w") as f:
        for i in range(n_reads):
            start = int(rng.integers(0, len(genome) - READ_LEN))
            noisy, true = testing.noisy_read(rng, genome, start, READ_LEN,
                                             err=RAW_ERR)
            if i < N_TRUTH:
                truths[f"L{i}"] = true
            total += len(noisy)
            f.write(f"@L{i}\n{dna.decode(noisy)}\n+\n{'!' * len(noisy)}\n")
    return truths, total


def residual_error(path: str, truths: dict) -> float:
    """Edit distance (NW) of the scored reads to their truth over the truth's
    bases, as scripts/scale_run_torch.py scores."""
    d = n = 0
    for rec in fastx.read_fastx(path):
        t = truths.get(rec.name)
        if t is None:
            continue
        d += CG.aln_dist(dna.codes_to_masks(rec.codes),
                         dna.codes_to_masks(t), CG.NW)
        n += len(t)
    return d / max(n, 1)


def card(device):
    """The card's name, nvidia-smi's name and power limit, the visible
    count; "cpu" off the card."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    smi = out.stdout.strip().splitlines()[device.index or 0]
    return {"name": torch.cuda.get_device_name(device), "smi": smi,
            "power_limit": smi.rsplit(",", 1)[-1].strip(),
            "count": torch.cuda.device_count()}


def rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1 << 20)


def sha256(path: str) -> str:
    return digests.file_sha256(path)


def device_busy(prof, wall: float) -> dict:
    """From a torch.profiler run over `wall` seconds: the CUDA ops' count,
    the union of their intervals (busy seconds and its share of the wall)
    and the six kernels that take the most device time (ms). Raises when
    the profiler saw no device op."""
    from torch.autograd import DeviceType
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us())
    if not spans:
        raise AssertionError("the profiler saw no device op")
    busy, hi = 0.0, None
    for a, b in sorted(spans):
        if hi is None or a > hi:
            busy += b - a
            hi = b
        elif b > hi:
            busy += b - hi
            hi = b
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"device_ops": len(spans), "busy_s": busy / 1e6,
            "busy_share": busy / (wall * 1e6),
            "top_kernels_ms": [[n, us / 1e3] for n, us in top]}


def _head(src: str, dst: str, n_reads: int) -> None:
    """The first n_reads records of a four-line FASTQ."""
    with open(dst, "w") as f, open(src) as g:
        for _ in range(n_reads * 4):
            f.write(g.readline())


def timed_pass(corr: Corrector, opt: CorrectOpt, src: str, out: str,
               pass_no: int) -> dict:
    """One timed correct_file pass on a warm Corrector: its timers, the
    kernels' launch counts and the device's peak memory are reset first,
    the pass ends in a synchronize. Returns the run's record."""
    on_card = corr.device.type == "cuda"
    corr.timers = dict.fromkeys(corr.timers, 0.0)
    for fn in KERNELS.values():
        fn.launches = 0
        fn.launches_by_stream.clear()
    fallback0 = corr.devplan.n_fallback if corr.devplan is not None else 0
    batches = []            # one entry per read batch executed
    execute = corr._execute_regions

    def execute_and_count(regions):
        batches.append(None)
        execute(regions)

    corr._execute_regions = execute_and_count
    if on_card:
        torch.cuda.synchronize(corr.device)
        torch.cuda.reset_peak_memory_stats(corr.device)
    try:
        t0 = time.time()
        n_reads, _ = correct_file(corr, opt, [src], out, pass_no)
        if on_card:
            torch.cuda.synchronize(corr.device)
        secs = time.time() - t0
    finally:
        del corr._execute_regions
    rec = {"seconds": secs, "reads": n_reads, "read_batches": len(batches),
           "timers": dict(corr.timers),
           "launches": {n: fn.launches for n, fn in KERNELS.items()},
           "n_fallback": (corr.devplan.n_fallback - fallback0
                          if corr.devplan is not None else None),
           "sha256": sha256(out)}
    if on_card:
        gb = 1 << 30
        rec.update(
            peak_allocated_gb=torch.cuda.max_memory_allocated(corr.device) / gb,
            peak_reserved_gb=torch.cuda.max_memory_reserved(corr.device) / gb,
            allocated_after_gb=torch.cuda.memory_allocated(corr.device) / gb)
    check_launches(rec, pass_no, on_card, corr.devplan is not None,
                   corr.opt.plan_on_device)
    return rec


def check_launches(rec: dict, pass_no: int, on_card: bool, devplan: bool,
                   plan_on_device: bool) -> None:
    """Raises unless the pass ran the kernels of its path (on the card) and,
    with the device planner, planned some batch on the card."""
    need = dict(PATH_KERNELS, **(PLAN_KERNELS if plan_on_device else {}))
    idle = [n for n in need if rec["launches"][n] == 0]
    if on_card and idle:
        raise AssertionError(f"pass {pass_no}: {idle} never launched: "
                             f"{rec['launches']}")
    if plan_on_device and not devplan:
        raise AssertionError(f"pass {pass_no}: the device planner was not "
                             "built (index past its size limit)")
    if plan_on_device and rec["n_fallback"] >= rec["read_batches"]:
        raise AssertionError(f"pass {pass_no}: every one of "
                             f"{rec['read_batches']} batches fell back to "
                             "the host planner")


def check_order(path: str, n_reads: int) -> None:
    """Every read written, in input order."""
    names = [r.name for r in fastx.read_fastx(path)]
    if names != [f"L{i}" for i in range(n_reads)]:
        raise AssertionError(f"{path}: {len(names)} reads of {n_reads} or "
                             "out of input order")


def pass_summary(runs: list, mid: int) -> dict:
    """A pass over its runs: the median run's timers and launches, the
    peaks over the runs, the allocated bytes after each run (growth across
    repeats shows there)."""
    rec = {"runs_s": [r["seconds"] for r in runs],
           "read_batches": runs[mid]["read_batches"],
           "timers": runs[mid]["timers"], "launches": runs[mid]["launches"],
           "n_fallback": [r["n_fallback"] for r in runs]}
    if "peak_allocated_gb" in runs[0]:
        after = [r["allocated_after_gb"] for r in runs]
        rec.update(
            peak_allocated_gb=max(r["peak_allocated_gb"] for r in runs),
            peak_reserved_gb=max(r["peak_reserved_gb"] for r in runs),
            allocated_after_gb=after,
            allocated_growth_gb=after[-1] - after[0])
    return rec


def trace_pass(corr: Corrector, opt: CorrectOpt, src: str, out: str) -> dict:
    """Pass 1 once more under torch.profiler (untimed): device_busy's
    figures and the plan / launch / finish shares of the wall."""
    from torch.profiler import ProfilerActivity, profile
    corr.timers = dict.fromkeys(corr.timers, 0.0)
    torch.cuda.synchronize(corr.device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        correct_file(corr, opt, [src], out, 1)
        torch.cuda.synchronize(corr.device)
        wall = time.time() - t0
    return {"wall_s": wall, **device_busy(prof, wall),
            "shares": {k: corr.timers[k] / wall
                       for k in ("plan", "launch", "finish", "wait")},
            "sha256": sha256(out)}


def run(size_args=(), *, device="cuda", workdir: str, repeats: int = 1,
        plan: str = "host", seed: int = SEED, trace: bool = False,
        t_start: float | None = None, read_batch_bp: int = 1 << 20,
        warm_reads: int = N_WARM, **opt_kw) -> dict:
    """bench.py's run through the port on `device` (cuda:0 unless the
    caller asks for the CPU), its files in `workdir`. size_args: bench.py's
    positional arguments. read_batch_bp, warm_reads (the long reads of each
    pass's warm-up) and opt_kw (CorrectOpt fields over bench.py's options):
    the CPU tests' smaller batches, warm-ups, beam and launches. t_start opens the
    "imports" phase (default: now). Returns the result; raises when a
    check fails."""
    phases = Phases("imports", time.time() if t_start is None else t_start)
    if repeats < 1:
        raise ValueError("--repeats must be at least 1")
    if plan not in ("host", "device"):
        raise ValueError(f"--plan is host or device, not {plan!r}")
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError("bench_torch: torch sees no CUDA device")
        device = torch.device("cuda", device.index or 0)
    elif trace:
        raise ValueError("--trace reads the card's kernels: it needs "
                         "--device cuda")
    dev_info = card(device)
    glen, n_reads, repeat_frac, repeat_len = sizes(list(size_args))

    phases.open("simulate")
    log(f"simulating genome={glen}bp (repeats {repeat_frac:.0%} x "
        f"{repeat_len}bp), {n_reads} long reads x {READ_LEN}bp, 40x short "
        f"reads; seed {seed}; {plan} planner on "
        f"{dev_info['smi'] if on_card else 'cpu'}")
    rng, genome, sreads = simulate_short(seed, glen, repeat_frac, repeat_len)
    options = bench_options(read_batch_bp=read_batch_bp, **opt_kw)
    opt = CorrectOpt(**options, plan_on_device=plan == "device")
    o1, o2 = _pass_opt(opt, 1), _pass_opt(opt, 2)

    # the kernel library's nvcc build runs in a thread while the pass-1
    # index builds (bench.py's prewarm); its exception re-raises at the join
    def build_kernels():
        t0 = time.time()
        if on_card:
            cuda_lib.library()
        return time.time() - t0

    phases.open("p1_graph_build")
    log("building pass-1 colored cDBG k=31 (host, untimed index step; the "
        "kernel library builds in the background)")
    with ThreadPoolExecutor(max_workers=1) as pool:
        build = pool.submit(build_kernels)
        t0 = time.time()
        cdbg = B.build_cdbg(sreads, 31, min_count=2)
        colors = color_graph(cdbg, sreads)
        log(f"pass-1 graph: {cdbg.n_unitigs} unitigs, {cdbg.index.n} "
            f"k-mers ({time.time() - t0:.1f}s)")
        kernel_build_s = build.result()
    log(f"kernel library: {kernel_build_s:.1f}s")
    phases.open("p1_corrector_init")
    corr1 = Corrector(cdbg, colors, o1, device=device)

    phases.open("simulate_long_reads")
    lr_path = os.path.join(workdir, "long.fq")
    truths, total_bases = write_long_reads(rng, genome, n_reads, lr_path)
    del genome

    phases.open("p1_warmup")
    p1_path = os.path.join(workdir, "out.2.fastq")
    p2_path = os.path.join(workdir, "out.fastq")
    warm = {}
    t0 = time.time()
    corr1.warmup_compile()
    warm_path = os.path.join(workdir, "warm.fq")
    _head(lr_path, warm_path, min(n_reads, warm_reads))
    correct_file(corr1, o1, [warm_path], p1_path, 1)
    warm["pass1"] = time.time() - t0
    log(f"pass-1 warmup done ({warm['pass1']:.1f}s)")

    phases.open("p1_timed")
    p1_runs = []
    for r in range(repeats):
        rec = timed_pass(corr1, o1, lr_path, p1_path, 1)
        p1_runs.append(rec)
        log(f"pass-1 run {r + 1}/{repeats}: {total_bases} bases in "
            f"{rec['seconds']:.2f}s; " + ", ".join(
                f"{k}={v:.2f}s" for k, v in rec["timers"].items())
            + f"; launches {rec['launches']}")
    check_order(p1_path, n_reads)

    phases.open("p2_graph_build")
    log("building pass-2 cDBG k=63 colored by pass-1 output (untimed)")
    t0 = time.time()
    cdbg2, colors2 = build_pass2_index(
        opt, ((r.codes, r.qual) for r in fastx.read_fastx(p1_path)),
        sreads, list(range(len(sreads))))
    log(f"pass-2 graph: {cdbg2.n_unitigs} unitigs, {cdbg2.index.n} k-mers "
        f"({time.time() - t0:.1f}s)")
    phases.open("p2_corrector_init")
    corr2 = Corrector(cdbg2, colors2, o2, device=device)

    phases.open("p2_warmup")
    t0 = time.time()
    corr2.warmup_compile()
    warm2_path = os.path.join(workdir, "warm2.fq")
    _head(p1_path, warm2_path, min(n_reads, warm_reads))
    correct_file(corr2, o2, [warm2_path], p2_path, 2)
    warm["pass2"] = time.time() - t0
    log(f"pass-2 warmup done ({warm['pass2']:.1f}s)")

    phases.open("p2_timed")
    p2_runs = []
    for r in range(repeats):
        rec = timed_pass(corr2, o2, p1_path, p2_path, 2)
        p2_runs.append(rec)
        log(f"pass-2 run {r + 1}/{repeats}: {rec['seconds']:.2f}s; "
            + ", ".join(f"{k}={v:.2f}s" for k, v in rec["timers"].items())
            + f"; launches {rec['launches']}")
    check_order(p2_path, n_reads)
    for p, runs in (("pass 1", p1_runs), ("pass 2", p2_runs)):
        shas = [r["sha256"] for r in runs]
        if len(set(shas)) != 1:
            raise AssertionError(f"{p}: the runs' FASTQ differ: {shas}")

    fastq = {"pass1": p1_runs[0]["sha256"], "final": p2_runs[0]["sha256"]}
    # held to the JAX package's digests of this data and these options
    try:
        jax_entry = digests.check(
            "bench", data_rule(size_args, seed), options,
            lambda: {"short.fa": digests.short_fasta_sha256(sreads),
                     "long.fq": sha256(lr_path)}, fastq)
        jax_match = None if jax_entry is None else True
    except digests.Mismatch as e:
        jax_entry, jax_match = e.name, False
        log(str(e))
    log("no JAX package digests for this data and these options"
        if jax_entry is None else
        f"FASTQ {'equal to' if jax_match else 'DIFFERENT FROM'} the JAX "
        f"package's ({digests.PATH.name} entry {jax_entry})")

    phases.open("score")
    err = {"raw": residual_error(lr_path, truths),
           "pass1": residual_error(p1_path, truths),
           "pass2": residual_error(p2_path, truths)}
    log(f"error on {len(truths)} reads: raw {err['raw']:.5f}, pass 1 "
        f"{err['pass1']:.5f}, pass 2 {err['pass2']:.5f}")
    if not err["pass2"] < err["raw"] / 5:
        raise AssertionError(f"pass-2 error {err['pass2']:.5f} is not below "
                             f"a fifth of the raw {err['raw']:.5f}")

    traced = None
    if trace:
        phases.open("trace")
        traced = trace_pass(corr1, o1, lr_path,
                            os.path.join(workdir, "trace.2.fastq"))
        if traced["sha256"] != p1_runs[0]["sha256"]:
            raise AssertionError("the traced pass 1 differs from the timed "
                                 "runs'")
        log(f"traced pass 1: {traced['wall_s']:.2f}s, device busy "
            f"{traced['busy_share']:.2%}, shares {traced['shares']}")

    wall = phases.close()
    bps = [total_bases / (a["seconds"] + b["seconds"])
           for a, b in zip(p1_runs, p2_runs)]
    mid = sorted(range(repeats), key=bps.__getitem__)[(repeats - 1) // 2]
    t1, t2 = p1_runs[mid]["seconds"], p2_runs[mid]["seconds"]
    log("wall breakdown: " + ", ".join(
        f"{k}={v:.1f}s" for k, v in phases.seconds.items())
        + f"; total {wall:.1f}s")
    log(f"corrected {total_bases} bases through 2 passes: runs "
        + ", ".join(f"{b:.1f}" for b in bps) + f" bases/s; median "
        f"{bps[mid]:.1f}")
    return {
        "metric": METRIC, "value": bps[mid], "unit": "bases/s",
        "vs_baseline": bps[mid] / BASELINE_BASES_PER_SEC,
        "phases_s": phases.seconds, "pass1_s": t1, "pass2_s": t2,
        "total_wall_s": wall,
        "device": dev_info, "plan": plan, "seed": seed, "repeats": repeats,
        "genome_bp": glen, "n_long_reads": n_reads,
        "long_read_bp": total_bases,
        "runs_bases_per_s": bps,
        "pass1_runs_s": [r["seconds"] for r in p1_runs],
        "pass2_runs_s": [r["seconds"] for r in p2_runs],
        "warmup_s": warm, "kernel_build_s": kernel_build_s,
        "passes": {"pass1": pass_summary(p1_runs, mid),
                   "pass2": pass_summary(p2_runs, mid)},
        "peak_rss_gb": rss_gb(),
        "fastq_sha256": {"pass1": p1_runs[0]["sha256"],
                         "pass2": p2_runs[0]["sha256"]},
        "error": err,
        "trace": traced,
        "jax_entry": jax_entry,
        "jax_match": jax_match,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("size", nargs="*",
                    help="small, or <genome_bp> [n_reads] (default: 4 Mbp, "
                    "5,000 reads)")
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--plan", choices=("host", "device"), default="host")
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--trace", action="store_true",
                    help="pass 1 once more under torch.profiler (untimed)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (cuda:0, the default) or cpu (tests only)")
    args = ap.parse_args(argv)
    if len(args.size) > 2 or (args.size and args.size[0] == "small"
                              and len(args.size) > 1):
        ap.error("size is `small` or <genome_bp> [n_reads]")
    with tempfile.TemporaryDirectory(prefix="rtpu_bench_torch_") as workdir:
        result = run(args.size, device=args.device, workdir=workdir,
                     repeats=args.repeats, plan=args.plan, seed=args.seed,
                     trace=args.trace, t_start=T_START)
    print(json.dumps(result), flush=True)
    # FASTQ that differ from the JAX package's on the same data and options
    return 1 if result.get("jax_match") is False else 0


if __name__ == "__main__":
    sys.exit(main())
