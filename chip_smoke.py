#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (ratatosk_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                      # full size, as documented below
    python3 chip_smoke.py --genome-bp 200000 --long-reads 16   # a quick run

Phases, one line each (any failure raises, and the script exits non-zero):
  1. environment: torch, CUDA, nvcc, the card's name and power limit, and
     whether the native k-mer library builds (without it the NumPy fallback
     makes the graph build crawl);
  2. build: the kernel library from ratatosk_tpu_torch/csrc, with nvcc;
  3. each kernel against its plain PyTorch version on the card, at the main
     path's shapes (R=512, B=16, smax=8, W in {257, 192, 336}): bit-identical,
     timed with CUDA events after a warm-up;
  4. the slice: the two-pass correction that bench.py drives (4 Mbp genome
     with 15% x 250 bp repeats, 40x 120 bp short reads, 4 kbp long reads at
     10% error, beam 16, 512 regions per launch, host planner, 2 threads),
     through ratatosk_tpu_torch.pipeline on the card. Launch counts are reset
     just before pass 1 and read just after pass 2; every kernel must have
     launched. 16 sampled reads must come out with under a fifth of their raw
     error rate;
  5. pass 1 on the first 16 long reads once more with sprint_impl="torch"
     (the kernel's plain version): the FASTQ must be byte-identical.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or without the
package beside this file, it exits non-zero and prints no result.
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

ROOT = Path(__file__).resolve().parent
SEED = 1234
KERNEL_SHAPES = dict(R=512, B=16, smax=8, widths=(257, 192, 336))


def log(msg: str) -> None:
    print(msg, flush=True)


def _cmd(args) -> str:
    try:
        out = subprocess.run(args, capture_output=True, text=True, timeout=60)
    except FileNotFoundError:
        return "not found"
    return (out.stdout or out.stderr).strip()


def phase_environment(torch):
    from ratatosk_tpu_torch.ops import native_kmers as NK
    from ratatosk_tpu_torch.ops import sprint as SP
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    log(f"[env] nvcc: {_cmd([SP._nvcc(), '--version']).splitlines()[-1]}")
    smi = _cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    log(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    log(f"[env] native k-mer library available: {NK.available()}")
    log(f"[env] device 0: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible")
    return smi.splitlines()[0] if smi else ""


def phase_build():
    import re
    from ratatosk_tpu_torch.ops import sprint as SP
    t0 = time.time()
    path = SP.build_library()
    SP._library()
    dt = time.time() - t0
    report = path.with_suffix(".log").read_text()
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", report)]
    spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill", report))
    log(f"[build] {path.relative_to(ROOT)} in {dt:.2f}s; ptxas: "
        f"{len(regs)} kernels, {min(regs, default=0)}-{max(regs, default=0)} "
        f"registers, {spills} bytes of spills")


def sprint_inputs(rng, R, B, W, smax, nt):
    """Band state at the main path's shapes: DP-like rows, monotone window
    starts (delta in {0,1} per substep), random live entries and sprint
    lengths."""
    import numpy as np
    S1 = smax - 1
    ws0 = rng.integers(0, max(nt + 1 - W, 1), R)
    rwin = (np.abs(np.arange(W)[None, None, :] + ws0[:, None, None]
                   - rng.integers(0, nt, (R, B, 1)))
            + rng.integers(0, 40, (R, B, W))).astype(np.int32)
    btgt = (1 << rng.integers(0, 4, (R, W))).astype(np.int32)
    nb = rng.integers(0, 4, (R, B, S1)).astype(np.int32)
    newcols = (1 << rng.integers(0, 4, (R, S1))).astype(np.int32)
    deltas = rng.integers(0, 2, (R, S1))
    wsall = (ws0[:, None] + np.concatenate(
        [np.zeros((R, 1), int), np.cumsum(deltas, axis=1)], axis=1)
    ).astype(np.int32)
    wsall[::4] -= wsall[::4, :1]                 # some windows at column 0
    mreg = rng.integers(0, smax, R).astype(np.int32)
    live = rng.integers(0, 2, (R, B)).astype(np.int32)
    plen = rng.integers(0, nt, (R, B)).astype(np.int32)
    return rwin, btgt, nb, newcols, wsall, mreg, live, plen


def _time_ms(torch, fn, reps=20, warm=3):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def phase_kernels(torch, dev):
    """Kernel vs plain version at each band width of the main path."""
    import numpy as np
    from ratatosk_tpu_torch.ops import sprint as SP
    R, B, smax = KERNEL_SHAPES["R"], KERNEL_SHAPES["B"], KERNEL_SHAPES["smax"]
    nt_of = {257: 256, 192: 2048, 336: 5376}
    rng = np.random.default_rng(SEED)
    rows = {}
    for W in KERNEL_SHAPES["widths"]:
        arrs = [torch.tensor(a, device=dev)
                for a in sprint_inputs(rng, R, B, W, smax, nt_of[W])]
        kr, kb = SP.sprint_rows(*arrs, smax=smax)
        torch.cuda.synchronize()
        rr, rbt = SP.sprint_rows_ref(*arrs, smax=smax)
        err = max(int((kr - rr).abs().max()), int((kb - rbt).abs().max()))
        if not (torch.equal(kr, rr) and torch.equal(kb, rbt)):
            raise AssertionError(f"sprint_rows kernel differs from its plain "
                                 f"version at W={W}: max abs err {err}")
        ms = _time_ms(torch, lambda: SP.sprint_rows(*arrs, smax=smax))
        plain = _time_ms(torch, lambda: SP.sprint_rows_ref(*arrs, smax=smax))
        rows[W] = dict(max_abs_err=err, ms=ms, plain_ms=plain)
        log(f"[kernel] sprint_rows R={R} B={B} W={W} smax={smax}: "
            f"bit-identical to sprint_rows_ref; kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms")
    return rows


def _write_long_reads(rng, genome, n_reads, read_len, path):
    from ratatosk_tpu_torch import dna, testing
    truth, total = [], 0
    with open(path, "w") as f:
        for i in range(n_reads):
            start = int(rng.integers(0, len(genome) - read_len))
            noisy, true = testing.noisy_read(rng, genome, start, read_len,
                                             err=0.10)
            truth.append((noisy, true))
            total += len(noisy)
            f.write(f"@L{i}\n{dna.decode(noisy)}\n+\n{'!' * len(noisy)}\n")
    return truth, total


def run_slice(device, glen: int, n_reads: int, workdir: str, smi: str = ""):
    """The bench.py main path through the port on `device`. Returns a dict of
    counts and phase times; raises on any failed check."""
    import numpy as np
    import torch
    from ratatosk_tpu_torch import testing
    from ratatosk_tpu_torch.config import CorrectOpt
    from ratatosk_tpu_torch.correct.engine import Corrector
    from ratatosk_tpu_torch.graph import build as B
    from ratatosk_tpu_torch.graph.colors import color_graph
    from ratatosk_tpu_torch.io import fastx
    from ratatosk_tpu_torch.ops import sprint as SP
    from ratatosk_tpu_torch.pipeline import (_pass_opt, build_pass2_index,
                                             correct_file)

    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    times = {}
    t = time.time()
    rng = np.random.default_rng(SEED)
    genome = testing.random_genome(rng, glen, repeat_frac=0.15,
                                   repeat_len=250)
    sreads = testing.short_reads(rng, genome, coverage=40.0)
    lr_path = os.path.join(workdir, "long.fq")
    truth, total_bases = _write_long_reads(rng, genome, n_reads, 4000,
                                           lr_path)
    times["simulate"] = time.time() - t
    log(f"[slice] simulated genome {glen} bp, {len(sreads)} short reads, "
        f"{n_reads} long reads ({total_bases} bp) in {times['simulate']:.1f}s")

    opt = CorrectOpt(small_k=31, k=63, beam_width=16, batch_regions=512,
                     nb_threads=2, read_batch_bp=1 << 20)
    o1, o2 = _pass_opt(opt, 1), _pass_opt(opt, 2)
    t = time.time()
    cdbg = B.build_cdbg(sreads, 31, min_count=2)
    colors = color_graph(cdbg, sreads)
    corr1 = Corrector(cdbg, colors, o1, device=dev)
    corr1.warmup_compile()
    times["p1_index"] = time.time() - t
    log(f"[slice] pass-1 index k=31: {cdbg.n_unitigs} unitigs, "
        f"{cdbg.index.n} k-mers, {times['p1_index']:.1f}s (untimed)")

    p1_path = os.path.join(workdir, "out.2.fastq")
    p2_path = os.path.join(workdir, "out.fastq")
    SP.sprint_rows.launches = 0          # counts cover the main path only
    sync()
    t = time.time()
    n1, _ = correct_file(corr1, o1, [lr_path], p1_path, 1)
    sync()
    times["p1_correct"] = time.time() - t
    log(f"[slice] pass 1: {n1} reads in {times['p1_correct']:.1f}s; "
        + ", ".join(f"{k}={v:.1f}s" for k, v in corr1.timers.items()))

    t = time.time()
    cdbg2, colors2 = build_pass2_index(
        opt, ((r.codes, r.qual) for r in fastx.read_fastx(p1_path)),
        sreads, list(range(len(sreads))))
    corr2 = Corrector(cdbg2, colors2, o2, device=dev)
    times["p2_index"] = time.time() - t
    log(f"[slice] pass-2 index k=63: {cdbg2.n_unitigs} unitigs, "
        f"{times['p2_index']:.1f}s (untimed)")
    t = time.time()
    n2, _ = correct_file(corr2, o2, [p1_path], p2_path, 2)
    sync()
    times["p2_correct"] = time.time() - t
    launches = {"sprint_rows": SP.sprint_rows.launches}
    log(f"[slice] pass 2: {n2} reads in {times['p2_correct']:.1f}s; "
        + ", ".join(f"{k}={v:.1f}s" for k, v in corr2.timers.items()))

    if dev.type == "cuda" and min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the path never launched: {launches}")
    for path, n in ((p1_path, n1), (p2_path, n2)):
        names = [r.name for r in fastx.read_fastx(path)]
        if n != n_reads or names != [f"L{i}" for i in range(n_reads)]:
            raise AssertionError(f"{path}: {n} of {n_reads} reads written")
    out = {r.name: r.codes for r in fastx.read_fastx(p2_path)}
    out1 = {r.name: r.codes for r in fastx.read_fastx(p1_path)}
    sample = sorted(np.random.default_rng(SEED + 1).choice(
        n_reads, size=min(16, n_reads), replace=False).tolist())
    raw = float(np.mean([testing.error_rate(truth[i][0], truth[i][1])
                         for i in sample]))
    mid = float(np.mean([testing.error_rate(out1[f"L{i}"], truth[i][1])
                         for i in sample]))
    cor = float(np.mean([testing.error_rate(out[f"L{i}"], truth[i][1])
                         for i in sample]))
    log(f"[slice] error on {len(sample)} sampled reads: raw {raw:.4f}, "
        f"pass 1 {mid:.4f}, pass 2 {cor:.4f}")
    if not cor < raw / 5:
        raise AssertionError(f"corrected error {cor:.4f} is not below raw/5 "
                             f"({raw:.4f}/5)")
    dt = times["p1_correct"] + times["p2_correct"]
    log(f"[slice] {total_bases} bases through 2 passes in {dt:.1f}s: "
        f"{total_bases / dt:.1f} corrected bases/s on {smi or device}")
    return dict(launches=launches, times=times, bases=total_bases,
                bases_per_s=total_bases / dt, raw_err=raw, p1_err=mid,
                p2_err=cor, corr1=corr1, o1=o1, lr_path=lr_path,
                p1_path=p1_path)


def phase_plain_vs_kernel(device, sl: dict, workdir: str, n: int = 16):
    """Pass 1 on the first n long reads through the kernel and through its
    plain version: the FASTQ bytes must match."""
    from ratatosk_tpu_torch.correct.engine import Corrector
    from ratatosk_tpu_torch.pipeline import correct_file
    head = os.path.join(workdir, "head.fq")
    with open(sl["lr_path"]) as src, open(head, "w") as f:
        for _ in range(4 * n):
            f.write(src.readline())
    corr1, o1 = sl["corr1"], sl["o1"]
    plain = Corrector(corr1.cdbg, corr1.colors, o1, device=device,
                      sprint_impl="torch")
    outs = {}
    for name, corr in (("kernel", corr1), ("torch", plain)):
        t = time.time()
        path = Path(workdir) / f"{name}.fq"
        correct_file(corr, o1, [head], str(path), 1)
        outs[name] = path.read_bytes()
        log(f"[plain] pass 1 on {n} reads, sprint via {name}: "
            f"{time.time() - t:.1f}s")
    if outs["kernel"] != outs["torch"]:
        raise AssertionError("pass-1 FASTQ differs between the sprint kernel "
                             "and its plain version")
    log(f"[plain] FASTQ byte-identical ({len(outs['kernel'])} bytes)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome-bp", type=int, default=4_000_000)
    ap.add_argument("--long-reads", type=int, default=256)
    args = ap.parse_args(argv)
    if not (ROOT / "ratatosk_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: ratatosk_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    t_all = time.time()
    smi = phase_environment(torch)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    krows = phase_kernels(torch, dev)
    with tempfile.TemporaryDirectory(prefix="ratatosk_smoke_") as workdir:
        sl = run_slice(dev, args.genome_bp, args.long_reads, workdir, smi)
        phase_plain_vs_kernel(dev, sl, workdir)
    torch.cuda.synchronize()
    headline = krows[257]
    log(f"[done] {time.time() - t_all:.1f}s on {smi}")
    print(json.dumps({"kernels": [{
        "name": "sprint_rows", "route": "cuda",
        "source": "ratatosk_tpu_torch/csrc/sprint.cu",
        "replaces": "ratatosk_tpu/ops/sprint_pallas.py:58",
        "launches": sl["launches"]["sprint_rows"],
        "max_abs_err": max(r["max_abs_err"] for r in krows.values()),
        "ms": headline["ms"], "plain_ms": headline["plain_ms"],
        "by_width": {str(w): r for w, r in krows.items()},
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
