#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (ratatosk_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                      # full size, as documented below
    python3 chip_smoke.py --genome-bp 300000 --long-reads 16   # a quick run
    python3 chip_smoke.py --mesh-only   # phases 1-4, 9 and 10 only: the
                                        # check on a host with several cards

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
     (the kernel's plain version): the FASTQ must be byte-identical;
  6. [devplan] the device planner on the card, on the slice's k=31 graph
     (first read batch of raw long reads) and k=63 graph (first batch of
     pass-1 reads): its runs and 1-edit seeds must equal the host planner's,
     timed per batch against it; then pass 1 on the 16 reads of phase 5 with
     plan_on_device=True must write the same FASTQ bytes. Fails if every
     batch fell back to the host;
  7. [cli] the user's command on the slice's data (short reads written as
     FASTA): `python -m ratatosk_tpu_torch.cli correct -s -l -o -c 2
     --devices 1 -v` with the defaults (k 31/63, SNP detection and pass-1
     edge rescue on), through cli.main(..., device="cuda"). The kernel must
     launch, every read come out in order, and the sampled error fall below
     a fifth of the raw error;
  8. [index] `index -1` on the first half of the short reads (20x; the
     depth cut that keeps the script well inside its time limit), the
     index's load and save timed on their own, then `correct -g
     <prefix>.index.k31.npz -1` on all the long reads: the files must exist,
     the kernel launch and the sampled error fall below raw/5. How many
     reads differ from the [cli] run's pass 1 is printed, not checked (the
     index holds half the short reads, and a saved index drops the colors'
     full CSR, which SNP detection reads).
  9. [mesh] both passes of the slice on all its long reads with
     Corrector(..., mesh=...) on the slice's graphs (2 threads): slots are
     cuda:0..n-1 with 2 or more cards, else [cuda:0, cuda:0] (two slots on
     one card). Both FASTQ files must equal the slice's byte for byte, and
     every slot must launch the kernel;
 10. [sharded] ShardedKmerIndex over the same slots on the slice's k=31 and
     k=63 indexes: one read batch's canonical k-mers, absent keys with bit
     63 set and the all-ones key must get the host index's answers
     (KeyArray.find), timed per batch; then both passes with
     shard_index_min_keys=0 (anchor lookups through the sharded index),
     byte-identical to the slice;
 11. [dist] the multi-host launcher in two processes on the [cli] phase's
     inputs, both on cuda:0, joined by gloo on a free localhost port:
     `python -m ratatosk_tpu_torch.distributed_correct --coordinator ...
     --num-processes 2 --process-id i -- <the [cli] flags>`. The final
     FASTQ must equal the [cli] run's byte for byte, both index .npz files
     exist, and each process's kernel must launch.
Launch counts are reset just before each path (the slice, the 16-read
planner run, the mesh and sharded runs, the [cli] run, the -g run; each
[dist] process counts its own) and read just after; the kernels' record
sums them.
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


def _sample(n_reads: int):
    import numpy as np
    return sorted(np.random.default_rng(SEED + 1).choice(
        n_reads, size=min(16, n_reads), replace=False).tolist())


def _check_reads(path: str, n_reads: int) -> dict:
    """All n_reads long reads written, in input order; name -> codes."""
    from ratatosk_tpu_torch.io import fastx
    recs = list(fastx.read_fastx(path))
    if [r.name for r in recs] != [f"L{i}" for i in range(n_reads)]:
        raise AssertionError(f"{path}: {len(recs)} of {n_reads} reads "
                             "written, or out of order")
    return {r.name: r.codes for r in recs}


def _sampled_error(truth, out: dict) -> float:
    import numpy as np
    from ratatosk_tpu_torch import testing
    return float(np.mean([testing.error_rate(out[f"L{i}"], truth[i][1])
                          for i in _sample(len(truth))]))


def _raw_error(truth) -> float:
    import numpy as np
    from ratatosk_tpu_torch import testing
    return float(np.mean([testing.error_rate(truth[i][0], truth[i][1])
                          for i in _sample(len(truth))]))


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
    if n1 != n_reads or n2 != n_reads:
        raise AssertionError(f"{n1}/{n2} of {n_reads} reads corrected")
    out1 = _check_reads(p1_path, n_reads)
    out = _check_reads(p2_path, n_reads)
    raw, mid, cor = (_raw_error(truth), _sampled_error(truth, out1),
                     _sampled_error(truth, out))
    log(f"[slice] error on {len(_sample(n_reads))} sampled reads: raw "
        f"{raw:.4f}, pass 1 {mid:.4f}, pass 2 {cor:.4f}")
    if not cor < raw / 5:
        raise AssertionError(f"corrected error {cor:.4f} is not below raw/5 "
                             f"({raw:.4f}/5)")
    dt = times["p1_correct"] + times["p2_correct"]
    log(f"[slice] {total_bases} bases through 2 passes in {dt:.1f}s: "
        f"{total_bases / dt:.1f} corrected bases/s on {smi or device}")
    return dict(launches=launches, times=times, bases=total_bases,
                bases_per_s=total_bases / dt, raw_err=raw, p1_err=mid,
                p2_err=cor, corr1=corr1, corr2=corr2, o1=o1, o2=o2,
                truth=truth, sreads=sreads, lr_path=lr_path, p1_path=p1_path,
                p2_path=p2_path)


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
    return head, outs["kernel"]


def _first_batch(path: str, batch_bp: int):
    """The first read batch correct_file would form from a FASTQ file."""
    from ratatosk_tpu_torch.io import fastx
    reads, bp = [], 0
    for rec in fastx.read_fastx(path):
        reads.append(rec.codes)
        bp += len(rec.codes)
        if bp >= batch_bp:
            break
    return reads


def _probe_spans(cdbg, colors, runs_raw, reads, min_gap: int):
    """The anchor-free spans Corrector._plan_seeds probes for 1-edit seeds
    (pass 1: no span is at maximal quality)."""
    from ratatosk_tpu_torch.correct.seeds import filter_runs_by_color
    k = cdbg.k
    spans = []
    for i, (codes, rr) in enumerate(zip(reads, runs_raw)):
        runs = filter_runs_by_color(rr, colors)
        if not runs:
            continue
        cuts = [(0, runs[0].s)]
        cuts += [(r.e + (r.rspan or k), n.s + k) for r, n in zip(runs, runs[1:])]
        cuts.append((runs[-1].e + (runs[-1].rspan or k), len(codes)))
        spans += [(i, a, b) for a, b in cuts if b - a >= min_gap]
    return spans


def _run_keys(lists):
    return [[(r.s, r.e, r.uid, r.direction, r.o_s, r.weak, r.rspan)
             for r in runs] for runs in lists]


def phase_devplan(device, sl: dict, workdir: str, head: str,
                  host_fastq: bytes):
    """The device planner against the host planner on the card: runs and
    seeds of one read batch per graph, ms per batch, then a pass-1 run with
    plan_on_device=True. Returns the sprint launches of that run."""
    import dataclasses
    import torch
    from ratatosk_tpu_torch.correct.engine import _NEAR_EXACT_SKIP, Corrector
    from ratatosk_tpu_torch.correct.seeds import (find_runs,
                                                  find_weak_seeds_batch)
    from ratatosk_tpu_torch.ops import sprint as SP
    from ratatosk_tpu_torch.ops.plan_device import DevicePlanner
    from ratatosk_tpu_torch.pipeline import correct_file
    o1 = sl["o1"]
    stride, nes = o1.weak_seed_stride, _NEAR_EXACT_SKIP
    batches = fallbacks = 0
    for name, corr, path in (("k31", sl["corr1"], sl["lr_path"]),
                             ("k63", sl["corr2"], sl["p1_path"])):
        cdbg = corr.cdbg
        reads = _first_batch(path, o1.read_batch_bp)
        t = time.time()
        dp = DevicePlanner.build(cdbg, device)
        dp.warmup(o1.read_batch_bp, stride=stride, near_exact_skip=nes)
        t_build = time.time() - t

        def host():
            runs = [find_runs(cdbg, r) for r in reads]
            spans = _probe_spans(cdbg, corr.colors, runs, reads,
                                 o1.weak_seed_min_gap)
            return runs, spans, find_weak_seeds_batch(cdbg, reads, spans,
                                                      stride=stride)

        def dev(spans):
            runs = dp.collect_runs(dp.dispatch_runs(reads))
            return runs, dp.collect_probe(dp.dispatch_probe(
                reads, spans, stride=stride, near_exact_skip=nes))

        runs_h, spans, seeds_h = host()
        runs_d, seeds_d = dev(spans)
        n_fb = dp.n_fallback
        ms = {"host": [], "device": []}
        for who in ("host", "device", "device", "host"):
            t = time.time()
            host() if who == "host" else dev(spans)
            torch.cuda.synchronize()
            ms[who].append(1000 * (time.time() - t))
        batches += 1
        if runs_d is None or seeds_d is None:
            fallbacks += 1
        if runs_d is not None and _run_keys(runs_d) != _run_keys(runs_h):
            raise AssertionError(f"device runs differ from the host "
                                 f"planner's on the {name} graph")
        if seeds_d is not None and _run_keys(seeds_d) != _run_keys(seeds_h):
            raise AssertionError(f"device seeds differ from the host "
                                 f"planner's on the {name} graph")
        log(f"[devplan] {name}: {cdbg.index.n} keys, batch of {len(reads)} "
            f"reads / {sum(map(len, reads))} bp, {len(spans)} probe spans; "
            f"runs {'equal' if runs_d is not None else 'overflowed'}, seeds "
            f"{'equal' if seeds_d is not None else 'fell back'} "
            f"({sum(map(len, seeds_h))} seeds); build+warmup {t_build:.2f}s; "
            f"ms per batch: host planner "
            f"{', '.join(f'{x:.1f}' for x in ms['host'])}, device planner "
            f"{', '.join(f'{x:.1f}' for x in ms['device'])}; "
            f"n_fallback {n_fb}; probe stats {dp.last_stats.tolist()}")

    o1d = dataclasses.replace(o1, plan_on_device=True)
    corr = Corrector(sl["corr1"].cdbg, sl["corr1"].colors, o1d, device=device)
    corr.warmup_compile()
    out = Path(workdir) / "devplan.fq"
    SP.sprint_rows.launches = 0
    torch.cuda.synchronize()
    t = time.time()
    correct_file(corr, o1d, [head], str(out), 1)
    torch.cuda.synchronize()
    launches = SP.sprint_rows.launches
    dt = time.time() - t
    batches += 1
    fallbacks += corr.devplan.n_fallback
    if out.read_bytes() != host_fastq:
        raise AssertionError("pass 1 with plan_on_device=True differs from "
                             "the host planner's FASTQ")
    if fallbacks >= batches:
        raise AssertionError("every planner batch fell back to the host")
    log(f"[devplan] pass 1 on 16 reads with plan_on_device=True: "
        f"byte-identical to the host planner ({len(host_fastq)} bytes) in "
        f"{dt:.1f}s, plan {corr.timers['plan']:.2f}s, n_fallback "
        f"{corr.devplan.n_fallback}, {launches} kernel launches; "
        f"{fallbacks} of {batches} planner batches fell back")
    if launches <= 0:
        raise AssertionError("the sprint kernel never launched")
    return launches


def make_slots(torch):
    """cuda:0..n-1 with two or more cards, else two slots on cuda:0."""
    from ratatosk_tpu_torch.parallel import mesh as M
    n = torch.cuda.device_count()
    devs = ([torch.device("cuda", i) for i in range(n)] if n >= 2
            else [torch.device("cuda", 0)] * 2)
    how = (f"{n} cards, one slot each" if n >= 2
           else "one card, two slots (streams) on cuda:0")
    return M.make_mesh(devices=devs), how


def _reset_launches():
    from ratatosk_tpu_torch.ops import sprint as SP
    SP.sprint_rows.launches = 0
    SP.sprint_rows.launches_by_stream.clear()


def _mesh_passes(tag: str, sl: dict, workdir: str, mesh, **opt_kw):
    """Both passes of the slice on `mesh`; the FASTQ files must equal the
    slice's. Returns (launches, per-slot launches, pass seconds)."""
    import dataclasses
    import torch
    from ratatosk_tpu_torch.correct.engine import Corrector
    from ratatosk_tpu_torch.ops import sprint as SP
    from ratatosk_tpu_torch.pipeline import correct_file
    o1 = dataclasses.replace(sl["o1"], **opt_kw)
    o2 = dataclasses.replace(sl["o2"], **opt_kw)
    c1, c2 = sl["corr1"], sl["corr2"]
    corr1 = Corrector(c1.cdbg, c1.colors, o1, mesh=mesh)
    corr1.warmup_compile()
    corr2 = Corrector(c2.cdbg, c2.colors, o2, mesh=mesh)
    if opt_kw.get("shard_index_min_keys") == 0 and (
            corr1.sharded is None or corr2.sharded is None):
        raise AssertionError(f"[{tag}] the sharded index is not in use")
    secs = {}
    _reset_launches()
    torch.cuda.synchronize()
    for p, corr, o, src, ref in ((1, corr1, o1, sl["lr_path"], sl["p1_path"]),
                                 (2, corr2, o2, sl["p1_path"], sl["p2_path"])):
        out = os.path.join(workdir, f"{tag}.p{p}.fastq")
        t = time.time()
        correct_file(corr, o, [src], out, p)
        torch.cuda.synchronize()
        secs[p] = time.time() - t
        if Path(out).read_bytes() != Path(ref).read_bytes():
            raise AssertionError(f"[{tag}] pass-{p} FASTQ differs from the "
                                 "single-device slice's")
    per_slot = [SP.sprint_rows.launches_by_stream.get(
        mesh.stream(i).cuda_stream, 0) for i in range(mesh.size)]
    launches = SP.sprint_rows.launches
    if min(per_slot) <= 0:
        raise AssertionError(f"[{tag}] a slot never launched the kernel: "
                             f"{per_slot}")
    return launches, per_slot, secs


def phase_mesh(sl: dict, workdir: str, mesh, how: str):
    """Both passes through Corrector(mesh=...), against the slice."""
    launches, per_slot, secs = _mesh_passes("mesh", sl, workdir, mesh)
    t = sl["times"]
    log(f"[mesh] {mesh} ({how}): pass 1 {secs[1]:.1f}s (slice "
        f"{t['p1_correct']:.1f}s), pass 2 {secs[2]:.1f}s (slice "
        f"{t['p2_correct']:.1f}s); both FASTQ files byte-identical to the "
        f"slice's; kernel launches per slot {per_slot} ({launches} in all)")
    return launches


def _batch_queries(reads, k, rng):
    """Canonical k-mers of a read batch, then 1,000 absent keys with bit 63
    set in lo and the all-ones key. Returns (q_lo, q_hi or None)."""
    import numpy as np
    from ratatosk_tpu_torch.graph.keys import KeyArray
    los, his = [], []
    for r in reads:
        ka, valid = KeyArray.from_codes(r, k)
        can, _ = ka.canonical()
        los.append(can.lo[valid])
        if can.hi is not None:
            his.append(can.hi[valid])
    ones = np.array([0xFFFFFFFFFFFFFFFF], np.uint64)
    los += [rng.integers(0, 1 << 62, 1000).astype(np.uint64)
            | np.uint64(1 << 63), ones]
    if not his:
        return np.concatenate(los), None
    his += [rng.integers(0, 1 << 61, 1000).astype(np.uint64), ones]
    return np.concatenate(los), np.concatenate(his)


def phase_sharded(sl: dict, workdir: str, mesh):
    """ShardedKmerIndex lookups against the host index, then both passes
    with every anchor lookup through it."""
    import numpy as np
    import torch
    from ratatosk_tpu_torch.graph.keys import KeyArray
    from ratatosk_tpu_torch.parallel.sharded_index import ShardedKmerIndex
    rng = np.random.default_rng(SEED + 2)
    ms_all = {}
    for name, corr, path in (("k31", sl["corr1"], sl["lr_path"]),
                             ("k63", sl["corr2"], sl["p1_path"])):
        idx = corr.cdbg.index
        t = time.time()
        sh = ShardedKmerIndex(idx, mesh)
        torch.cuda.synchronize()
        t_build = time.time() - t
        reads = _first_batch(path, sl["o1"].read_batch_bp)
        q_lo, q_hi = _batch_queries(reads, idx.k, rng)
        rows = KeyArray(idx.k, idx.keys_lo, idx.keys_hi).find(
            KeyArray(idx.k, q_lo, q_hi))
        hit = rows >= 0
        uid, pos, strand = (t.cpu().numpy() for t in sh.lookup(q_lo, q_hi))
        ok = (np.array_equal(uid >= 0, hit)
              and np.array_equal(uid[hit], idx.unitig_id[rows[hit]])
              and np.array_equal(pos[hit], idx.pos[rows[hit]])
              and np.array_equal(strand[hit],
                                 idx.strand[rows[hit]].astype(np.int32)))
        if not ok:
            raise AssertionError(f"[sharded] {name}: lookups differ from the "
                                 "host index's")
        ms = []
        for _ in range(3):
            t = time.time()
            [x.cpu() for x in sh.lookup(q_lo, q_hi)]
            ms.append(1000 * (time.time() - t))
        ms_all[name] = ms
        log(f"[sharded] {name}: {idx.n} keys over {mesh.size} slots "
            f"({sh.per} per shard, built in {t_build:.2f}s); {len(q_lo)} "
            f"queries ({int(hit.sum())} present, 1,001 absent incl. bit-63 "
            f"and all-ones keys) equal the host index's; ms per batch "
            f"(upload, search, read-back): "
            f"{', '.join(f'{x:.1f}' for x in ms)}")
    launches, per_slot, secs = _mesh_passes("sharded", sl, workdir, mesh,
                                            shard_index_min_keys=0)
    t = sl["times"]
    log(f"[sharded] both passes with shard_index_min_keys=0: pass 1 "
        f"{secs[1]:.1f}s (slice {t['p1_correct']:.1f}s), pass 2 "
        f"{secs[2]:.1f}s (slice {t['p2_correct']:.1f}s); byte-identical to "
        f"the slice; kernel launches per slot {per_slot} ({launches} in all)")
    return launches


_DIST_RUNNER = r"""
import sys
from ratatosk_tpu_torch import distributed_correct
from ratatosk_tpu_torch.ops import sprint
pid, port = sys.argv[1], sys.argv[2]
argv = ["--coordinator", f"localhost:{port}", "--num-processes", "2",
        "--process-id", pid, "--"] + sys.argv[3:]
assert distributed_correct.main(argv, device="cuda") == 0
print("sprint_launches", sprint.sprint_rows.launches, flush=True)
"""


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_dist(sl: dict, workdir: str, short_fa: str, cli_out: str):
    """Two processes through the multi-host launcher on the [cli] inputs."""
    from ratatosk_tpu_torch.graph import io as GIO
    out = os.path.join(workdir, "dist")
    argv = ["-s", short_fa, "-l", sl["lr_path"], "-o", out, "-c", "2",
            "--devices", "1", "-v"]
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs, errs = [], []
    t = time.time()
    try:
        for pid in range(2):
            trace = os.path.join(workdir, f"dist.trace{pid}.jsonl")
            errs.append(open(os.path.join(workdir, f"dist.err{pid}"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _DIST_RUNNER, str(pid), str(port),
                 *argv, "--trace-json", trace],
                cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=errs[-1],
                text=True))
        outs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    wall = time.time() - t
    for pid, (p, e) in enumerate(zip(procs, errs)):
        e.seek(0)
        err = e.read()
        e.close()
        if p.returncode != 0:
            raise AssertionError(f"[dist] process {pid} exited "
                                 f"{p.returncode}:\n{err[-4000:]}")
    launches = [int(o.strip().splitlines()[-1].split()[1]) for o in outs]
    if min(launches) <= 0:
        raise AssertionError(f"[dist] a process never launched the kernel: "
                             f"{launches}")
    if Path(out + ".fastq").read_bytes() != Path(cli_out + ".fastq") \
            .read_bytes():
        raise AssertionError("[dist] final FASTQ differs from the [cli] run's")
    for k in (31, 63):
        if not os.path.getsize(GIO.index_path(out, k)):
            raise AssertionError(f"[dist] {GIO.index_path(out, k)} is empty")
    steps = []
    for pid in range(2):
        evs = _trace(os.path.join(workdir, f"dist.trace{pid}.jsonl"))
        passes = {e["pass_no"]: e["secs"] for e in evs
                  if e["ev"] == "pass_done"}
        snp = [e["secs"] for e in evs if e["ev"] == "snp"]
        steps.append(f"process {pid}: pass 1 {passes[1]:.1f}s, pass 2 "
                     f"{passes[2]:.1f}s, SNP detection "
                     f"{' / '.join(f'{x:.1f}' for x in snp)}s")
    log(f"[dist] 2 processes on cuda:0 (gloo, localhost:{port}): "
        f"{wall:.1f}s wall; {'; '.join(steps)}; final FASTQ byte-identical "
        f"to the [cli] run's; index .npz k31/k63 written; kernel launches "
        f"{launches}")
    return sum(launches)


def _write_short_fasta(sreads, path: str, half_path: str) -> None:
    """Every short read to `path`, the first half also to `half_path`."""
    from ratatosk_tpu_torch import dna
    with open(path, "w") as f, open(half_path, "w") as h:
        for i, r in enumerate(sreads):
            rec = f">S{i}\n{dna.decode(r)}\n"
            f.write(rec)
            if 2 * i < len(sreads):
                h.write(rec)


def _trace(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def phase_cli(sl: dict, workdir: str, short_fa: str, smi: str):
    """The user's `correct` command at the slice's data shape."""
    import torch
    from ratatosk_tpu_torch import cli
    from ratatosk_tpu_torch.ops import sprint as SP
    truth, n_reads = sl["truth"], len(sl["truth"])
    out = os.path.join(workdir, "cli")
    trace = os.path.join(workdir, "cli.trace.jsonl")
    SP.sprint_rows.launches = 0
    t = time.time()
    cli.main(["correct", "-s", short_fa, "-l", sl["lr_path"], "-o", out,
              "-c", "2", "--devices", "1", "-v", "--trace-json", trace],
             device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = SP.sprint_rows.launches
    if launches <= 0:
        raise AssertionError("the sprint kernel never launched in the CLI run")
    evs = _trace(trace)
    snp = [e for e in evs if e["ev"] == "snp"]
    rescue = [e for e in evs if e["ev"] == "rescue"]
    passes = {e["pass_no"]: e for e in evs if e["ev"] == "pass_done"}
    mid = _sampled_error(truth, _check_reads(out + ".2.fastq", n_reads))
    cor = _sampled_error(truth, _check_reads(out + ".fastq", n_reads))
    raw = _raw_error(truth)
    dt = passes[1]["secs"] + passes[2]["secs"]
    steps = (sum(e["secs"] for e in snp + rescue) + dt)
    log(f"[cli] correct -c 2 --devices 1 (k 31/63, SNPs and edge rescue on): "
        f"{wall:.1f}s wall; edge rescue {rescue[0]['edges']} edges in "
        f"{rescue[0]['secs']:.1f}s; SNP detection "
        + ", ".join(f"pass {i + 1} {e['sites']} sites in {e['secs']:.1f}s"
                    for i, e in enumerate(snp))
        + f"; pass 1 {passes[1]['secs']:.1f}s, pass 2 {passes[2]['secs']:.1f}s"
        f"; index builds and I/O {wall - steps:.1f}s; {launches} kernel "
        f"launches")
    log(f"[cli] {sl['bases']} bases through 2 passes in {dt:.1f}s: "
        f"{sl['bases'] / dt:.1f} corrected bases/s on {smi}; error on "
        f"{len(_sample(n_reads))} sampled reads: raw {raw:.4f}, pass 1 "
        f"{mid:.4f}, pass 2 {cor:.4f}")
    if not cor < raw / 5:
        raise AssertionError(f"CLI error {cor:.4f} is not below raw/5")
    return dict(launches=launches, out=out)


def phase_index(sl: dict, workdir: str, half_fa: str, cli_out: str):
    """`index -1` on half the short reads, the index's load and save, then
    `correct -g ... -1`."""
    import numpy as np
    import torch
    from ratatosk_tpu_torch import cli
    from ratatosk_tpu_torch.graph import interop as IT
    from ratatosk_tpu_torch.graph import io as GIO
    from ratatosk_tpu_torch.ops import sprint as SP
    truth, n_reads = sl["truth"], len(sl["truth"])
    pref = os.path.join(workdir, "idx")
    t = time.time()
    cli.main(["index", "-s", half_fa, "-l", sl["lr_path"], "-o", pref, "-1",
              "-v"])
    t_index = time.time() - t
    npz, fasta = GIO.index_path(pref, 31), IT.fasta_index_path(pref, 31)
    for f in (npz, fasta):
        if not os.path.getsize(f):
            raise AssertionError(f"{f} is empty")
    t = time.time()
    cdbg, colors = GIO.load_index(npz)
    t_load = time.time() - t
    t = time.time()
    GIO.save_index(os.path.join(workdir, "resave.npz"), cdbg, colors)
    t_save = time.time() - t
    out = os.path.join(workdir, "g")
    trace = os.path.join(workdir, "g.trace.jsonl")
    SP.sprint_rows.launches = 0
    t = time.time()
    cli.main(["correct", "-g", npz, "-l", sl["lr_path"], "-o", out, "-1",
              "-c", "2", "--devices", "1", "-v", "--trace-json", trace],
             device="cuda")
    torch.cuda.synchronize()
    t_g = time.time() - t
    launches = SP.sprint_rows.launches
    if launches <= 0:
        raise AssertionError("the sprint kernel never launched in the -g run")
    p1 = [e for e in _trace(trace) if e["ev"] == "pass_done"][0]
    got = _check_reads(out + ".fastq", n_reads)
    ref = _check_reads(cli_out + ".2.fastq", n_reads)
    n_diff = sum(not np.array_equal(got[n], ref[n]) for n in got)
    raw, cor = _raw_error(truth), _sampled_error(truth, got)
    log(f"[index] index -1 on half the short reads in {t_index:.1f}s: "
        f"{os.path.getsize(npz)} byte "
        f"npz, {os.path.getsize(fasta)} byte unitig FASTA; load "
        f"{t_load:.2f}s, save {t_save:.2f}s")
    log(f"[index] correct -g <npz> -1 in {t_g:.1f}s (pass 1 "
        f"{p1['secs']:.1f}s), {launches} kernel launches; error raw "
        f"{raw:.4f}, corrected {cor:.4f}; {n_diff} of {n_reads} reads "
        "differ from the [cli] run's pass 1")
    if not cor < raw / 5:
        raise AssertionError(f"-g run error {cor:.4f} is not below raw/5")
    return dict(launches=launches)


def phase_rest(sl: dict, workdir: str, smi: str, launches: dict) -> None:
    """[cli], [index] and [dist] on the slice's data; adds their launches."""
    short_fa = os.path.join(workdir, "short.fa")
    half_fa = os.path.join(workdir, "short.half.fa")
    t = time.time()
    _write_short_fasta(sl.pop("sreads"), short_fa, half_fa)
    log(f"[cli] wrote {os.path.getsize(short_fa)} bytes of short-read "
        f"FASTA (and its first half) in {time.time() - t:.1f}s")
    sl.pop("corr1"), sl.pop("corr2")
    cl = phase_cli(sl, workdir, short_fa, smi)
    launches["cli"] = cl["launches"]
    launches["index_g"] = phase_index(sl, workdir, half_fa,
                                      cl["out"])["launches"]
    launches["dist"] = phase_dist(sl, workdir, short_fa, cl["out"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome-bp", type=int, default=4_000_000)
    ap.add_argument("--long-reads", type=int, default=256)
    ap.add_argument("--mesh-only", action="store_true",
                    help="run the kernels, the slice, [mesh] and [sharded] "
                    "only (on several cards: one slot per card)")
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
    launches = {}
    with tempfile.TemporaryDirectory(prefix="ratatosk_smoke_") as workdir:
        sl = run_slice(dev, args.genome_bp, args.long_reads, workdir, smi)
        launches["slice"] = sl["launches"]["sprint_rows"]
        if not args.mesh_only:
            head, host_fastq = phase_plain_vs_kernel(dev, sl, workdir)
            launches["devplan"] = phase_devplan(dev, sl, workdir, head,
                                                host_fastq)
        mesh, how = make_slots(torch)
        launches["mesh"] = phase_mesh(sl, workdir, mesh, how)
        launches["sharded"] = phase_sharded(sl, workdir, mesh)
        if not args.mesh_only:
            phase_rest(sl, workdir, smi, launches)
    torch.cuda.synchronize()
    headline = krows[257]
    log(f"[done] {time.time() - t_all:.1f}s on {smi}")
    print(json.dumps({"kernels": [{
        "name": "sprint_rows", "route": "cuda",
        "source": "ratatosk_tpu_torch/csrc/sprint.cu",
        "replaces": "ratatosk_tpu/ops/sprint_pallas.py:58",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
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
