"""Chromosome-scale run of the PyTorch + CUDA port on one card: the
counterpart of scripts/scale_run.py, on the same simulated data.

Simulates a genome (default 60 Mbp, 10% x 300 bp repeats), 40x short reads
of 100 bp and long reads of 4 kbp at 10% error (seed 20; the same bytes as
scale_run.py's at equal arguments), then drives the two-pass pipeline of
ratatosk_tpu_torch through its entry points on cuda:0 (impl="auto": the
fused beam kernel and the finish kernel). Besides scale_run.py's fields
(phase seconds, pass seconds, residual error on the first 400 reads, peak
RSS) it reports, for each pass: read batches, kernel launches, the
Corrector's plan / launch / finish timers and the seconds the main thread
waited for the next batch's plan, peak allocated and reserved device
memory, and the allocated device memory after the first and the last
batch, which must not grow. It also runs the first 32 long reads through
impl="torch" on the same pass-1 graph, whose FASTQ must equal the kernels'.

--plan-ab runs each pass again with plan_on_device=True on a fresh
Corrector over the same graph: its FASTQ must equal the host planner's; its
seconds, device memory and n_fallback are reported (devplan_built is false
past the device planner's index-size limit, where the host plans).

Usage:
    python3 scripts/scale_run_torch.py [genome_bp] [n_long_reads] [out.json]
        [--device cuda] [--plan-ab]
e.g. python3 scripts/scale_run_torch.py 12e6 7500 --plan-ab
Writes the JSON object to out.json (default chiprun_out/scale_torch.json,
git-ignored) and prints it as the last line of stdout; progress goes to
stderr. The intermediate FASTQ files live in a temporary directory that is
removed at the end. --device cpu is for the tests only.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import resource
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ratatosk_tpu_torch import dna, testing  # noqa: E402
from ratatosk_tpu_torch.config import CorrectOpt  # noqa: E402
from ratatosk_tpu_torch.correct.engine import Corrector  # noqa: E402
from ratatosk_tpu_torch.graph import build as B  # noqa: E402
from ratatosk_tpu_torch.graph.colors import color_graph  # noqa: E402
from ratatosk_tpu_torch.io import fastx  # noqa: E402
from ratatosk_tpu_torch.ops import beam_kernel, finish_kernel  # noqa: E402
from ratatosk_tpu_torch.ops import cigar as CG  # noqa: E402
from ratatosk_tpu_torch.pipeline import (_pass_opt, build_pass2_index,  # noqa: E402
                                         correct_file)

SEED = 20
READ_LEN = 4000
N_TRUTH = 400           # long reads scored against their truth
N_KERNEL_CHECK = 32     # long reads run through impl="torch" as well
RAW_ERR = 0.10
# the kernels of the main path, by the name of their wrapper
KERNELS = {"fused_beam_search": beam_kernel.fused_beam_search,
           "finish_bundle_kernel": finish_kernel.finish_bundle_kernel}
# git-ignored; scale_run.py's default output is a tracked file
DEFAULT_OUT = ROOT / "chiprun_out" / "scale_torch.json"


def log(msg):
    print(f"[scale] {msg}", file=sys.stderr, flush=True)


def rss_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1 << 20)


def fast_short_reads(rng, genome, coverage=40.0, read_len=100,
                     chunk=1 << 19):
    """Vectorized uniform sampler (testing.short_reads is a per-read python
    loop — minutes at 2.4 Gbp). Chunked so the gather index array stays
    ~400 MB instead of size-of-dataset x8."""
    n = int(len(genome) * coverage / read_len)
    out = []
    off = np.arange(read_len)[None, :]
    for a in range(0, n, chunk):
        m = min(chunk, n - a)
        starts = rng.integers(0, len(genome) - read_len + 1, size=m)
        arr = genome[starts[:, None] + off]
        flip = rng.random(m) < 0.5
        arr[flip] = (3 - arr[flip])[:, ::-1]
        out.extend(list(np.ascontiguousarray(arr)))
    return out


def simulate_short(genome_bp: int):
    """(rng, genome, short reads): the seed's stream continues into the
    long reads (write_long_reads), as in scale_run.py."""
    rng = np.random.default_rng(SEED)
    genome = testing.random_genome(rng, genome_bp, repeat_frac=0.10,
                                   repeat_len=300)
    return rng, genome, fast_short_reads(rng, genome, coverage=40.0)


def write_long_reads(rng, genome, n_long_reads: int, path: str):
    """Writes the noisy long reads as FASTQ; returns (truths of the first
    N_TRUTH by name, noisy bases written)."""
    truths = {}
    total = 0
    with open(path, "w") as f:
        for i in range(n_long_reads):
            start = int(rng.integers(0, len(genome) - READ_LEN))
            noisy, true = testing.noisy_read(rng, genome, start, READ_LEN,
                                             err=RAW_ERR)
            if i < N_TRUTH:
                truths[f"L{i}"] = true
            total += len(noisy)
            f.write(f"@L{i}\n{dna.decode(noisy)}\n+\n{'!' * len(noisy)}\n")
    return truths, total


def card_name() -> str:
    """nvidia-smi's name and power limit of the first card."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def residual_error(path: str, truths: dict) -> float:
    d = n = 0
    for rec in fastx.read_fastx(path):
        t = truths.get(rec.name)
        if t is None:
            continue
        d += CG.aln_dist(dna.codes_to_masks(rec.codes),
                         dna.codes_to_masks(t), CG.NW)
        n += len(t)
    return d / max(n, 1)


def run_pass(corr: Corrector, opt: CorrectOpt, src: str, out: str,
             pass_no: int) -> dict:
    """One correct_file pass, and what it did: seconds, read batches, the
    kernels' launches, the Corrector's timers, and on a card the device
    memory (peaks of the pass, allocated after the first and the last
    batch, which must not grow)."""
    on_card = corr.device.type == "cuda"
    after_batch = []
    execute = corr._execute_regions

    def execute_and_note(regions):
        execute(regions)
        after_batch.append(torch.cuda.memory_allocated(corr.device)
                           if on_card else 0)

    corr._execute_regions = execute_and_note
    for fn in KERNELS.values():
        fn.launches = 0
        fn.launches_by_stream.clear()
    mem = None
    if on_card:
        torch.cuda.synchronize(corr.device)
        torch.cuda.reset_peak_memory_stats(corr.device)
        mem = {"allocated_before": torch.cuda.memory_allocated(corr.device)}
    t = time.time()
    try:
        n_reads, n_bases = correct_file(corr, opt, [src], out, pass_no)
        if on_card:
            torch.cuda.synchronize(corr.device)
    finally:
        del corr._execute_regions
    secs = time.time() - t
    if on_card:
        mem.update(
            max_allocated=torch.cuda.max_memory_allocated(corr.device),
            max_reserved=torch.cuda.max_memory_reserved(corr.device),
            allocated_after_first_batch=after_batch[0],
            allocated_after_last_batch=after_batch[-1])
        if mem["allocated_after_last_batch"] > \
                mem["allocated_after_first_batch"]:
            raise AssertionError(f"pass {pass_no}: allocated device memory "
                                 f"grew across batches: {mem}")
    return {"seconds": secs, "reads": n_reads, "bases": n_bases,
            "read_batches": len(after_batch),
            "launches": {k: fn.launches for k, fn in KERNELS.items()},
            "timers_s": dict(corr.timers), "device_memory_bytes": mem}


def plan_on_device_pass(cdbg, colors, opt, device, src, out, pass_no,
                        host_out) -> dict:
    """The same pass with plan_on_device=True on a fresh Corrector over the
    same graph; its FASTQ must equal the host planner's."""
    o = dataclasses.replace(opt, plan_on_device=True)
    corr = Corrector(cdbg, colors, o, device=device)
    corr.warmup_compile()
    rec = run_pass(corr, o, src, out, pass_no)
    rec["devplan_built"] = corr.devplan is not None
    rec["n_fallback"] = (corr.devplan.n_fallback if corr.devplan is not None
                         else None)
    if Path(out).read_bytes() != Path(host_out).read_bytes():
        raise AssertionError(f"pass {pass_no}: plan_on_device FASTQ differs "
                             "from the host planner's")
    return rec


def kernel_check(cdbg, colors, opt, device, lr_path, workdir) -> dict:
    """The first N_KERNEL_CHECK long reads through impl="auto" and "torch"
    on the pass-1 graph: the FASTQ bytes must be equal, and the plain
    route must launch no kernel."""
    src = os.path.join(workdir, "long.head.fq")
    with open(lr_path) as f, open(src, "w") as g:
        for _ in range(4 * N_KERNEL_CHECK):
            g.write(f.readline())
    out, fastq = {}, {}
    for impl in ("auto", "torch"):
        corr = Corrector(cdbg, colors, opt, device=device, impl=impl)
        corr.warmup_compile()
        path = os.path.join(workdir, f"head.{impl}.fastq")
        out[impl] = run_pass(corr, opt, src, path, 1)
        fastq[impl] = Path(path).read_bytes()
        del corr
    if fastq["auto"] != fastq["torch"]:
        raise AssertionError(f"the first {N_KERNEL_CHECK} reads' pass-1 "
                             "FASTQ differs between impl auto and torch")
    if any(out["torch"]["launches"].values()):
        raise AssertionError(f"impl torch launched kernels: {out['torch']}")
    return {"reads": N_KERNEL_CHECK, "identical": True,
            "auto_s": out["auto"]["seconds"],
            "torch_s": out["torch"]["seconds"],
            "auto_launches": out["auto"]["launches"]}


def _release(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(genome_bp: int, n_long_reads: int, *, device, workdir: str,
        plan_ab: bool = False, read_batch_bp: int = 1 << 20,
        **opt_kw) -> dict:
    """Both passes at this size on `device` (cuda:0 unless the caller asks
    for the CPU); intermediate files go to `workdir`. opt_kw: CorrectOpt
    fields over scale_run.py's options (the CPU tests' smaller beam and
    launches). Returns the result object; raises when a check fails."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        if not torch.cuda.is_available():
            raise RuntimeError("scale_run_torch: torch sees no CUDA device")
        device = torch.device("cuda", device.index or 0)
    card = card_name() if on_card else "cpu"
    phases, rss = {}, {"start": rss_gb()}

    def phase(name, t0):
        phases[name] = time.time() - t0
        rss[name] = rss_gb()
        log(f"{name}: {phases[name]:.1f}s (peak RSS {rss[name]:.2f} GB)")

    t0 = time.time()
    log(f"simulating {genome_bp / 1e6:g} Mbp genome + 40x short reads + "
        f"{n_long_reads} x {READ_LEN}bp long reads; {card}")
    rng, genome, sreads = simulate_short(genome_bp)
    phase("simulate_sr", t0)
    t0 = time.time()
    lr_path = os.path.join(workdir, "long.fq")
    truths, total_bases = write_long_reads(rng, genome, n_long_reads,
                                           lr_path)
    del genome
    phase("simulate_lr", t0)

    opt = CorrectOpt(**{**dict(small_k=31, k=63, beam_width=16,
                               batch_regions=512, nb_threads=2,
                               read_batch_bp=read_batch_bp), **opt_kw})
    o1 = _pass_opt(opt, 1)
    passes, ab = {}, {}

    # ---- pass 1 ----
    t0 = time.time()
    cdbg = B.build_cdbg(sreads, 31, min_count=2)
    phase("p1_cdbg_build", t0)
    log(f"pass-1 graph: {cdbg.n_unitigs} unitigs, {cdbg.index.n} k-mers")
    t0 = time.time()
    colors = color_graph(cdbg, sreads)
    phase("p1_coloring", t0)
    t0 = time.time()
    corr1 = Corrector(cdbg, colors, o1, device=device)
    corr1.warmup_compile()
    phase("p1_init_warmup", t0)
    p1_path = os.path.join(workdir, "out.2.fastq")
    t0 = time.time()
    passes["pass1"] = run_pass(corr1, o1, lr_path, p1_path, 1)
    phase("p1_correct", t0)
    log(f"pass 1: {passes['pass1']}")
    del corr1
    _release(device)
    if plan_ab:
        t0 = time.time()
        ab["pass1"] = plan_on_device_pass(
            cdbg, colors, o1, device, lr_path,
            os.path.join(workdir, "out.2.devplan.fastq"), 1, p1_path)
        phase("p1_plan_ab", t0)
        log(f"pass 1, plan_on_device: {ab['pass1']}")
        _release(device)
    t0 = time.time()
    check = kernel_check(cdbg, colors, o1, device, lr_path, workdir)
    phase("p1_kernel_check", t0)
    log(f"kernels against impl torch: {check}")
    del cdbg, colors
    _release(device)

    # ---- pass 2 ----
    t0 = time.time()
    cdbg2, colors2 = build_pass2_index(
        opt, ((r.codes, r.qual) for r in fastx.read_fastx(p1_path)),
        sreads, list(range(len(sreads))))
    phase("p2_index_build", t0)
    log(f"pass-2 graph: {cdbg2.n_unitigs} unitigs, {cdbg2.index.n} k-mers")
    del sreads
    o2 = _pass_opt(opt, 2)
    t0 = time.time()
    corr2 = Corrector(cdbg2, colors2, o2, device=device)
    corr2.warmup_compile()
    phase("p2_init_warmup", t0)
    p2_path = os.path.join(workdir, "out.fastq")
    t0 = time.time()
    passes["pass2"] = run_pass(corr2, o2, p1_path, p2_path, 2)
    phase("p2_correct", t0)
    log(f"pass 2: {passes['pass2']}")
    del corr2
    _release(device)
    if plan_ab:
        t0 = time.time()
        ab["pass2"] = plan_on_device_pass(
            cdbg2, colors2, o2, device, p1_path,
            os.path.join(workdir, "out.devplan.fastq"), 2, p2_path)
        phase("p2_plan_ab", t0)
        log(f"pass 2, plan_on_device: {ab['pass2']}")

    # ---- residual error on the truth sample ----
    t0 = time.time()
    e1 = residual_error(p1_path, truths)
    e2 = residual_error(p2_path, truths)
    phase("scoring", t0)
    if not e2 < RAW_ERR / 5:
        raise AssertionError(f"residual error after pass 2 {e2:.5f} is not "
                             f"below a fifth of the raw {RAW_ERR}")

    t_p1, t_p2 = passes["pass1"]["seconds"], passes["pass2"]["seconds"]
    return {
        "metric": "chr-scale corrected bases/s on one card (2-pass)",
        "card": card,
        "genome_bp": genome_bp, "long_read_bp": total_bases,
        "short_read_bp": int(genome_bp * 40),
        "n_long_reads": n_long_reads, "read_batch_bp": read_batch_bp,
        "value": total_bases / (t_p1 + t_p2), "unit": "bases/s",
        "pass1_s": t_p1, "pass2_s": t_p2,
        "residual_err_pass1": e1, "residual_err_pass2": e2,
        "raw_err": RAW_ERR,
        "peak_rss_gb": rss_gb(),
        "phases_s": phases,
        "peak_rss_gb_after": rss,
        "passes": passes,
        "plan_ab": ab or None,
        "kernel_check": check,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("genome_bp", nargs="?", type=float, default=60_000_000)
    ap.add_argument("n_long_reads", nargs="?", type=int, default=25_000)
    ap.add_argument("out", nargs="?", default=str(DEFAULT_OUT))
    ap.add_argument("--device", default="cuda",
                    help="cuda (cuda:0, the default) or cpu (tests only)")
    ap.add_argument("--plan-ab", action="store_true",
                    help="run each pass again with plan_on_device=True")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="rtpu_scale_torch_") as workdir:
        result = run(int(args.genome_bp), args.n_long_reads,
                     device=args.device, workdir=workdir,
                     plan_ab=args.plan_ab)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
