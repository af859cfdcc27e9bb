#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (ratatosk_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                      # full size, as documented below
    python3 chip_smoke.py --genome-bp 300000 --long-reads 16   # a quick run
    python3 chip_smoke.py --mesh-only   # phases 1-4b, 9, 10, [cli quarter],
                                        # [cli default] and 11 only: the
                                        # check on a host with several cards

Phases, one line each (any failure raises, and the script exits non-zero):
  1. environment: torch, CUDA, nvcc, the card's name and power limit, and
     whether the native k-mer and align libraries build (without them the
     NumPy fallbacks crawl; the align library would otherwise build inside
     the timed pass 1);
  2. build: the kernel library from ratatosk_tpu_torch/csrc, with nvcc;
  3. the sprint kernel against its plain PyTorch version on the card, at
     the main path's shapes (B=16, smax=8, W in {257, 192, 336} and the
     widest band, 1,024; R=512 and 128, the engine's largest and smallest
     padding) on random band state: bit-identical, the kernel's call and
     the plain version's timed with CUDA events behind a device sleep (the
     host's enqueue left out), each with its bound (bytes over 3.35 TB/s,
     int32 operations over 132 x 64 x 1.98 GHz, for the entries and
     substeps the launch advances);
  3a. [align] ops/align.edit_distance (the JAX package's ops/align.py; on a
     CUDA tensor the align kernel, csrc/align.cu) in NW, SHW and HW at the
     engine's three bucket shapes (B/M/N 512/256/256, 256/2048/2048,
     128/5376/5376; ~10% substitutions, some IUPAC R and N) and on edge
     rows (N = 1, 700 and 2,100; a_len 0 and past M, b_len 0, past N and
     negative, arbitrary padding bytes), counts reset just before and read
     just after: every result equal to the plain version (impl="torch"),
     tensor for tensor, both timed as in phase 3, with the bound (the mask
     bytes the batch needs read and every output written once, MYERS_OPS +
     ALIGN_EQ_OPS int32 operations per 32-column word of the columns each
     pair needs, up to its b_len, in each row it needs, 1..a_len);
  4. the slice: the two-pass correction that bench.py drives (4 Mbp genome
     with 15% x 250 bp repeats, 40x 120 bp short reads, 4 kbp long reads at
     10% error, beam 16, 512 regions per launch, host planner, 2 threads),
     through ratatosk_tpu_torch.pipeline on the card (impl="auto": each
     launch is the fused beam kernel's two launches and the finish kernel's
     one, with no host sync per branch step). Launch counts are reset just
     before pass 1 and read just after pass 2; both kernels must have
     launched. 16 sampled reads must come out with under a fifth of their
     raw error rate;
  3b. [kernel] the fused beam kernel and the finish kernel against their
     plain versions on one launch per bucket (NT 256 / 2048 / 5376, beam W
     257 / 192 / 336, finish W 389 / 192 / 336), planned from the slice's
     own reads and padded as the engine pads them (a toy batch from
     ratatosk_tpu_torch.testing for a bucket the slice lacks):
     bit-identical, the kernels' calls timed with CUDA events behind a
     device sleep (the host's enqueue left out), the plain versions once,
     each with its bound for the work this launch's planned regions
     need (beam_work, finish_work: each region's own steps, candidates and
     columns, at most one step past its own end, counted from a plain run);
     the beam kernel's two launches also timed apart, its ms per step (the
     call's time over the launch's step count T) and f_max (the longest
     region's own steps); the finish kernel's rows of the longest region
     (max(tgt_len, best_end) + 1) and us per row;
  3c. [wide] bands past 512 columns on the same planned regions: the 2048
     bucket's launch at band_width=600 (both kernels at W=600) and the 256
     bucket's regions packed with weak_region_len_factor=0.6 (the finish
     kernel's path row of 569 columns), each kernel bit-identical to its
     plain version;
  4b. [warm] both passes of the slice once more on the card, untraced,
     through fresh Correctors on the slice's graphs: byte-identical to the
     slice, the warm pass seconds and corrected bases/s of one card (the
     slice's own passes are the process's first and carry first-use
     costs); [mesh] and [sharded] are compared with these. For each pass,
     with the card's name and power limit: peak allocated and reserved
     device memory (peaks reset before the pass) and the host's peak RSS;
  5. [plain] pass 1 on the first 16 long reads through impl="auto", "steps"
     (per-step torch with the sprint kernel) and "torch" (plain): the three
     FASTQ files must be byte-identical, and each route launch only its own
     kernels; then the sprint kernel as in phase 3 on the "steps" run's
     first launch at W=257, as the engine formed it. [wide] impl="steps" at
     band_width=600 on the same reads must equal impl="torch" byte for
     byte, with sprint launches past 512 columns;
  5b. [trace] pass 1 of the slice once more under torch.profiler: device
     busy share, pass seconds, plan / launch / finish shares, the kernels
     that take the device time; the FASTQ must equal the slice's;
  6. [devplan] the device planner on the card, on the slice's k=31 graph
     (first read batch of raw long reads) and k=63 graph (first batch of
     pass-1 reads): its runs and 1-edit seeds must equal the host planner's,
     timed per batch against it; on the same batch, and on its first 16
     reads alone (both padded to the planner's tier), the runs and probe
     kernels (csrc/plan.cu) must equal their plain versions tensor for
     tensor (`of` and stats included), each timed with CUDA events beside
     its plain version and its bound (the random 32-byte sectors that the
     batch needs, counted from its inputs and checked against the plain
     version's stats, over 3.35 TB/s), with the CUDA kernels a call
     enqueues; then pass 1 on the 16
     reads of phase 5 with plan_on_device=True must write the same FASTQ
     bytes and launch both planner kernels. Fails if every batch fell back
     to the host;
  7. [cli] the user's command on the slice's data (short reads written as
     FASTA): `python -m ratatosk_tpu_torch.cli correct -s -l -o -c 2
     --devices 1 -v` with the defaults (k 31/63, SNP detection and pass-1
     edge rescue on), through cli.main(..., device="cuda"). The kernel must
     launch, every read come out in order, and the sampled error fall below
     a fifth of the raw error. [cli quarter]: the same command on a
     quarter of the slice's genome and long reads (1 Mbp and 64 reads by
     default, simulated alike), the run that [cli default], [index] and
     [dist] are held to (their host steps, index builds above all, scale
     with the genome). [cli default]: the same command on the quarter
     without --devices, so on the CLI's default mesh over every visible
     card (one card: --devices 1's path); both FASTQ files must equal [cli
     quarter]'s byte for byte, and on a mesh every card must launch both
     kernels and every slot of every launch read its launch's T (as in
     [mesh]). At the default size both runs' pass-1 and final FASTQ must
     equal the JAX package's (ratatosk_tpu_torch/data/jax_digests.json,
     cli_quarter; the inputs' sha256 checked first);
  8. [index] on that quarter: `index -1` on the first half of its short
     reads (20x), the index's load and save timed on their own, then
     `correct -g <prefix>.index.k31.npz -1` on all its long reads: the files
     must exist, the kernel launch and the sampled error fall below raw/5.
     How many reads differ from the [cli quarter] run's pass 1 is printed,
     not checked (the index holds half the short reads, and a saved index
     drops the colors' full CSR, which SNP detection reads).
  9. [mesh] both passes of the slice on all its long reads with
     Corrector(..., mesh=...) on the slice's graphs (2 threads): slots are
     cuda:0..n-1 with 2 or more cards, else [cuda:0, cuda:0] (two slots on
     one card). Both FASTQ files must equal the slice's byte for byte, and
     every slot must launch both kernels. The slots of a launch agree on
     its step count T (parallel.mesh.StepCount): the T of each launch is
     printed, and every slot's launch 2 must have read its launch's T.
     Then both passes once more on the same mesh with plan_on_device=True
     (the device planner on slot 0's card): byte-identical to the slice,
     both planner kernels launched, each launch's T checked alike;
 10. [sharded] ShardedKmerIndex over the same slots on the slice's k=31 and
     k=63 indexes: one read batch's canonical k-mers, absent keys with bit
     63 set and the all-ones key must get the host index's answers
     (KeyArray.find), timed per batch; [lookup] the same queries through
     ops/kmer_index.lookup on the index's copy on cuda:0 (one word at k=31,
     two at k=63) must give the same call's rows on the CPU, the host
     index's rows and the sharded index's answers; then both passes with
     shard_index_min_keys=0 (anchor lookups through the sharded index),
     byte-identical to the slice, each launch's T checked as in [mesh];
 11. [dist] the multi-host launcher on the [cli quarter] inputs, joined
     by gloo on a free localhost port: `python -m
     ratatosk_tpu_torch.distributed_correct --coordinator ...
     --num-processes N --process-id i -- <the [cli] flags>`, one process
     per card with two or more cards (process i with
     CUDA_VISIBLE_DEVICES=i), else two processes on cuda:0. The final
     FASTQ must equal the [cli quarter] run's byte for byte, both index .npz
     files exist, and each process must launch both kernels.
 12. [bench] bench_torch.py (the port's bench.py) at 1 Mbp and 64 long
     reads with --repeats 2, once with --plan host and once with --plan
     device, each in its own process on cuda:0: each must exit 0 with a
     JSON last line whose passes launched the kernels of their path (the
     planner's two with --plan device), and the two runs' FASTQ sha256 must
     be equal and the JAX package's (jax_digests.json bench_smoke: each
     run's "jax_match" must be true); both runs' bases/s are printed with
     the card's name.
Launch counts are reset just before each path ([align], the slice, [warm],
each [plain] route, [wide]'s "steps" run, the 16-read planner run, the mesh,
mesh devplan and sharded runs, the three CLI runs, the -g run; each [dist]
process counts its own, each [bench]
process its timed passes) and read just after; the kernels' record sums
them by path.
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
# the sprint kernel's random launches: the engine's largest and smallest
# padded row counts, the three buckets' bands and the widest band taken,
# each width in the bucket that gives it
KERNEL_SHAPES = dict(regions=(512, 128), B=16, smax=8,
                     widths=(257, 192, 336, 1024),
                     nt={257: 256, 192: 2048, 336: 5376, 1024: 2048})


def log(msg: str) -> None:
    print(msg, flush=True)


def _cmd(args) -> str:
    try:
        out = subprocess.run(args, capture_output=True, text=True, timeout=60)
    except FileNotFoundError:
        return "not found"
    return (out.stdout or out.stderr).strip()


# the kernels' wrappers, by the name of the JSON record; the main path of
# every phase runs the first two (impl="auto"), the sprint kernel runs on
# the "steps" route ([plain]), the device planner's two on [devplan]'s
# plan_on_device path too
KERNELS = ("fused_beam_search", "finish_bundle_kernel", "sprint_rows",
           "runs_kernel", "probe_kernel", "edit_distance_kernel")
PATH_KERNELS = KERNELS[:2]
PLAN_KERNELS = KERNELS[3:5]
# H100 SXM rates for the bounds (HBM3 peak bandwidth; int32: 132 SMs
# x 64 INT32 lanes x 1.98 GHz: one int op per lane per clock)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def _wrappers():
    from ratatosk_tpu_torch.ops import (align_kernel, beam_kernel,
                                        finish_kernel, plan_kernel, sprint)
    return {"fused_beam_search": beam_kernel.fused_beam_search,
            "finish_bundle_kernel": finish_kernel.finish_bundle_kernel,
            "sprint_rows": sprint.sprint_rows,
            "runs_kernel": plan_kernel.runs_kernel,
            "probe_kernel": plan_kernel.probe_kernel,
            "edit_distance_kernel": align_kernel.edit_distance_kernel}


def _reset_launches():
    for fn in _wrappers().values():
        fn.launches = 0
        fn.launches_by_stream.clear()


def _launches(names=PATH_KERNELS) -> dict:
    w = _wrappers()
    return {n: w[n].launches for n in names}


def _require_launches(tag: str, counts: dict) -> None:
    """Every kernel of the path launched in this run."""
    if min(counts.values()) <= 0:
        raise AssertionError(f"[{tag}] a kernel of the path never launched: "
                             f"{counts}")


def _bound_ms(nbytes: float, ops: float):
    """(bound ms, what bounds it): the larger of bytes over the memory rate
    and int32 operations over the int32 operation rate."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def phase_environment(torch):
    from ratatosk_tpu_torch.ops import cuda_lib
    from ratatosk_tpu_torch.ops import native_kmers as NK
    from ratatosk_tpu_torch.ops import native_align as NA
    log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    log(f"[env] nvcc: {_cmd([cuda_lib.nvcc(), '--version']).splitlines()[-1]}")
    smi = _cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    log(smi.splitlines()[0] if smi else "nvidia-smi: no output")
    log(f"[env] native k-mer library available: {NK.available()}")
    # the align library builds at first use: here, not in the timed pass 1
    t = time.time()
    log(f"[env] native align library available: {NA.available()} "
        f"({time.time() - t:.1f}s)")
    log(f"[env] device 0: {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} visible")
    return smi.splitlines()[0] if smi else ""


def phase_build():
    import re
    from ratatosk_tpu_torch.ops import cuda_lib
    t0 = time.time()
    path = cuda_lib.build_library()
    cuda_lib.library()
    dt = time.time() - t0
    report = path.with_suffix(".log").read_text()
    regs = [int(n) for n in re.findall(r"Used (\d+) registers", report)]
    spills = sum(int(n) for n in re.findall(r"(\d+) bytes spill", report))
    log(f"[build] {path.relative_to(ROOT)} in {dt:.2f}s; ptxas: "
        f"{len(regs)} kernels, {min(regs, default=0)}-{max(regs, default=0)} "
        f"registers, {spills} bytes of spills")
    # the sprint kernel at its widest, 32 columns a lane
    for block in report.split("Compiling entry function")[1:]:
        if "sprint_rows_kernelILi32E" in block.split("\n")[0]:
            reg = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores", block)
            log(f"[build] sprint_rows_kernel<32> (W up to 1,024): "
                f"{reg.group(1) if reg else '?'} registers, "
                f"{spill.group(1) if spill else '?'} bytes of spill stores")


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


def _call_ms(torch, fn, reps=5):
    """Device ms of one call of fn (its kernel launches), the mean of
    `reps` after a warm-up call: CUDA events around each call, behind a
    device sleep that keeps the host's enqueue out of the time."""
    fn()
    tot = 0.0
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        tot += a.elapsed_time(b) / reps
    return tot


def sprint_cases(dev):
    """The sprint kernel's random launches: (key, tensors), at B=16 and
    smax=8, each width at R=512 (keyed by W) and then at R=128 (keyed
    "W/R128"), drawn in that order from one generator."""
    import numpy as np
    import torch
    B, smax = KERNEL_SHAPES["B"], KERNEL_SHAPES["smax"]
    rng = np.random.default_rng(SEED)
    for R in KERNEL_SHAPES["regions"]:
        for W in KERNEL_SHAPES["widths"]:
            arrs = sprint_inputs(rng, R, B, W, smax, KERNEL_SHAPES["nt"][W])
            yield (W if R == 512 else f"{W}/R{R}",
                   [torch.tensor(a, device=dev) for a in arrs])


def sprint_work(arrs, smax: int):
    """(bytes, int32 ops) that one sprint launch needs: every input read
    once and both outputs written once; ~10 int32 ops per cell of each live
    entry's substep (row update and scan), min(m_reg, smax-1) substeps."""
    R, B, W = arrs[0].shape
    nbytes = sum(a.numel() * 4 for a in arrs) + (R * B * W + R * W) * 4
    m_reg = arrs[5].long().clamp(0, smax - 1)
    live = (arrs[6] != 0).long()
    return nbytes, 10 * W * int((m_reg * live.sum(dim=1)).sum())


def sprint_row(torch, arrs, smax: int, tag: str) -> dict:
    """The sprint kernel against its plain version on one launch, tensor
    for tensor; both timed with _call_ms; the bound from the launch's own
    live entries and substeps. Raises if they differ."""
    from ratatosk_tpu_torch.ops import sprint as SP
    R, B, W = arrs[0].shape
    kr, kb = SP.sprint_rows(*arrs, smax=smax)
    torch.cuda.synchronize()
    rr, rbt = SP.sprint_rows_ref(*arrs, smax=smax)
    err = max(int((kr - rr).abs().max()), int((kb - rbt).abs().max()))
    if not (torch.equal(kr, rr) and torch.equal(kb, rbt)):
        raise AssertionError(f"sprint_rows kernel differs from its plain "
                             f"version on {tag}: max abs err {err}")
    ms = _call_ms(torch, lambda: SP.sprint_rows(*arrs, smax=smax), reps=10)
    plain = _call_ms(torch, lambda: SP.sprint_rows_ref(*arrs, smax=smax),
                     reps=3)
    nbytes, ops = sprint_work(arrs, smax)
    bound, by = _bound_ms(nbytes, ops)
    moving = int(((arrs[6] != 0) & (arrs[5][:, None] > 0)).sum())
    log(f"[kernel] sprint_rows {tag} R={R} B={B} W={W} smax={smax} "
        f"({moving} of {R * B} entries advance): equal to sprint_rows_ref; "
        f"kernel {ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.4f} ms "
        f"({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bound,
                bound_by=by, R=R, W=W, moving=moving)


def phase_kernels(torch, dev):
    """The sprint kernel against its plain version on sprint_cases."""
    return {key: sprint_row(torch, arrs, KERNEL_SHAPES["smax"], "random")
            for key, arrs in sprint_cases(dev)}


# the align kernel's launches: the engine's three bucket shapes (B pairs, M
# query and N target columns), then the edge rows
ALIGN_SHAPES = ((512, 256, 256), (256, 2048, 2048), (128, 5376, 5376))
ALIGN_EDGES = ((64, 300, 1), (64, 300, 700), (64, 40, 2100))
# int32 operations per 32-column word of a row beyond MYERS_OPS: the match
# word, an OR of the target's four bit-planes each ANDed with one bit of the
# query's mask
ALIGN_EQ_OPS = 7


def align_inputs(rng, B: int, M: int, N: int, edge: bool = False):
    """Pairs as the engine aligns them: ACGT masks (with some IUPAC R and
    N), the target a copy of the query at ~10% substitutions, lengths
    between half and all of the width, zero padding. `edge`: a_len 0 and
    past M, b_len 0, past N and negative, arbitrary padding bytes."""
    import numpy as np
    a = (1 << rng.integers(0, 4, (B, M))).astype(np.uint8)
    b = (1 << rng.integers(0, 4, (B, N))).astype(np.uint8)
    L = min(M, N)
    b[:, :L] = np.where(rng.random((B, L)) < 0.1, b[:, :L], a[:, :L])
    for x in (a, b):
        x[rng.random(x.shape) < 0.02] = 1 | 4
        x[rng.random(x.shape) < 0.01] = 15
    a_len = rng.integers(M // 2, M + 1, B).astype(np.int32)
    b_len = rng.integers(N // 2, N + 1, B).astype(np.int32)
    if edge:
        a_len[:3] = [0, M + 2, M]
        b_len[-5:] = [0, N + 3, -1, -(N + 4), N]
    for x, n in ((a, a_len), (b, b_len)):
        pad = np.arange(x.shape[1])[None, :] >= n[:, None]
        x[pad] = rng.integers(0, 256, int(pad.sum())) if edge else 0
    return a, a_len, b, b_len


def align_work(a_len, b_len, M: int, N: int, mode: int) -> tuple:
    """(bytes, int32 ops) of one edit_distance call, counted for this
    batch's lengths. A pair needs the rows 1..a_len when a_len lies in
    [0, M] (none of another) and the target's columns up to b_len clipped
    to [0, N] (NW also up to the column its distance reads): every column
    past them is BIG in the row, and column j needs only columns <= j. So
    (MYERS_OPS + ALIGN_EQ_OPS) ops per 32-column word of those columns per
    row; bytes: the query's a_len and the target's needed mask bytes of a
    pair with a row to run, both lengths, and every output written
    once."""
    import numpy as np
    a_len = np.asarray(a_len, np.int64)
    b_len = np.asarray(b_len, np.int64)
    rows = np.where((a_len >= 0) & (a_len <= M), a_len, 0)
    cols = np.clip(b_len, 0, N)
    if mode == 0:  # NW: the column read as the reference's take_along_axis
        at = np.where(b_len < 0, b_len + N + 1, b_len)
        cols = np.maximum(cols, np.where((at >= 0) & (at <= N), at, 0))
    words = -(-cols // 32)
    nbytes = int((rows + np.where(rows > 0, cols, 0)).sum()) \
        + len(a_len) * (8 + 12 + 4 * (N + 1))
    return nbytes, (MYERS_OPS + ALIGN_EQ_OPS) * int((rows * words).sum())


def phase_align(torch, dev) -> tuple:
    """[align]: ops/align.edit_distance (impl="auto") at the engine's three
    bucket shapes and on the edge rows, all three modes, with the launch
    counts reset just before and read just after; then each result held to
    the plain version (impl="torch") on the same inputs, tensor for tensor,
    and the kernel and the plain version timed. Returns (launches, rows by
    shape)."""
    import numpy as np
    from ratatosk_tpu_torch.ops import align as A
    from ratatosk_tpu_torch.ops import align_kernel as AK
    rng = np.random.default_rng(SEED + 5)
    cases = [("x".join(map(str, s)), align_inputs(rng, *s))
             for s in ALIGN_SHAPES]
    cases += [("edge " + "x".join(map(str, s)), align_inputs(rng, *s, True))
              for s in ALIGN_EDGES]
    cases = [(tag, [torch.tensor(x, device=dev) for x in arrs])
             for tag, arrs in cases]
    modes = (("NW", A.NW), ("SHW", A.SHW), ("HW", A.HW))
    _reset_launches()
    got = {(tag, m): A.edit_distance(*arrs, mode)
           for tag, arrs in cases for m, mode in modes}
    torch.cuda.synchronize()
    launches = {"edit_distance_kernel": AK.edit_distance_kernel.launches}
    _require_launches("align", launches)
    rows = {}
    for tag, arrs in cases:
        B, M = arrs[0].shape
        N = arrs[2].shape[1]
        for m, mode in modes:
            want = A.edit_distance(*arrs, mode, impl="torch")
            err = max(int((g.long() - w.long()).abs().max()) if g.numel()
                      else 0 for g, w in zip(got[tag, m], want))
            if not all(torch.equal(g, w) for g, w in zip(got[tag, m], want)):
                raise AssertionError(f"[align] {tag} {m}: the kernel differs "
                                     f"from its plain version (max abs err "
                                     f"{err})")
            ms = _call_ms(torch, lambda: A.edit_distance(*arrs, mode),
                          reps=10)
            plain = _call_ms(torch, lambda: A.edit_distance(
                *arrs, mode, impl="torch"), reps=2)
            nbytes, ops = align_work(arrs[1].cpu().numpy(),
                                     arrs[3].cpu().numpy(), M, N, mode)
            bound, by = _bound_ms(nbytes, ops)
            rows[f"{tag} {m}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                      bound_ms=bound, bound_by=by, B=B, M=M,
                                      N=N, ops=ops, bytes=nbytes)
            log(f"[align] {tag} {m}: equal to the plain version; kernel "
                f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bound:.6f} ms "
                f"({by}; {ops} int32 ops, {nbytes} bytes)")
    log(f"[align] {launches['edit_distance_kernel']} kernel launches on the "
        f"path ({len(cases)} batches x 3 modes)")
    return launches, rows


def _engine_pad(n: int, batch_regions: int) -> int:
    """The engine's padded row count of a launch (engine._launch_bucket)."""
    import numpy as np
    rp = 1 << int(np.ceil(np.log2(max(n, 1))))
    return max(min(rp, batch_regions), min(128, batch_regions))


def bucket_batches(sl: dict, dev):
    """One launch per bucket as the engine forms it: the bucket's regions
    planned from the slice's own reads (pass 1 on the raw reads with the
    k=31 graph, pass 2 on the pass-1 reads with the k=63 graph; the pass
    with more regions in the bucket), sorted by target length, the first
    chunk of at most batch_regions, padded to the engine's tier. A bucket
    the slice lacks gets a toy batch from ratatosk_tpu_torch.testing."""
    import numpy as np
    from ratatosk_tpu_torch import testing
    from ratatosk_tpu_torch.config import CorrectOpt
    from ratatosk_tpu_torch.correct import beam as BM
    from ratatosk_tpu_torch.correct.engine import (BUCKETS, bucket_band,
                                                   region_arrays)
    from ratatosk_tpu_torch.io import fastx
    pools = []
    for tag, corr, o, path in (("pass 1", sl["corr1"], sl["o1"],
                                sl["lr_path"]),
                               ("pass 2", sl["corr2"], sl["o2"],
                                sl["p1_path"])):
        recs = list(fastx.read_fastx(path))
        _, _, regions = corr.plan_batch([r.codes for r in recs],
                                        [r.qual for r in recs])
        pools.append((tag, corr, o, regions))
    toy = None
    out, lo = {}, 0
    for nt in BUCKETS:
        cands = [(sorted((s for s in regions if lo < len(s.tgt) <= nt),
                         key=lambda s: len(s.tgt)), tag, corr, o)
                 for tag, corr, o, regions in pools]
        specs, tag, corr, o = max(cands, key=lambda c: len(c[0]))
        if not specs:
            if toy is None:
                opt = CorrectOpt(small_k=21, k=63, beam_width=16,
                                 batch_regions=512)
                genome, tc = testing.build_toy_corrector(
                    seed=SEED, glen=20000, k=21, opt=opt, device=dev)
                toy = (tc, opt, testing.toy_region_specs(
                    tc, genome, np.random.default_rng(SEED), 64))
            corr, o, specs = toy
            specs = sorted((s for s in specs if len(s.tgt) <= nt),
                           key=lambda s: len(s.tgt))
            tag = "toy batch (ratatosk_tpu_torch.testing)"
        lo = nt
        specs = specs[:o.batch_regions]
        rp = _engine_pad(len(specs), o.batch_regions)
        arrays, lmax = region_arrays(specs, nt, corr.colors.cap, r_pad=rp,
                                     len_factor=o.weak_region_len_factor)
        band = bucket_band(nt, o)
        out[nt] = dict(g=corr.g, rb=BM.RegionBatch.from_numpy(arrays, dev),
                       lmax=lmax, band=band, W=BM.band_width(nt, band),
                       n_real=len(specs), tag=tag, k=corr.cdbg.k,
                       specs=specs, cap=corr.colors.cap,
                       qv_max=corr.qv_max, beam=o.beam_width,
                       min_cov=o.min_cov_vertices,
                       mso=o.min_score_open_region)
    return out


# int32 operations per band cell: the edit recurrence (substitution test,
# two adds, a min), the band stats a candidate's score reads (a compare and
# a min), the prefix-min scan of a row that is kept (subtract, min, add)
DP_OPS, STATS_OPS, SCAN_OPS = 5, 2, 3


def beam_work(torch, g, rb, *, beam: int, lmax: int, band: int,
              min_cov: int, n_real: int, smax: int = 8) -> dict:
    """The work the beam search needs on this batch, counted from a plain
    run step by step (untimed). Only the n_real planned rows count: padding
    rows are inert. A band row of region r costs its min(W, tgt_len+1)
    columns: no result reads a column past tgt_len. While region r has a
    live unfrozen entry (its steps before f_r) it needs each live entry's
    sprint substep rows (recurrence and scan), the DP row and band stats of
    each valid candidate, the scan of each winner that emitted, the score of
    each valid candidate and a top-B selection of its 4B candidates (C log2
    C compares), and the two color dot products and the popcount of each
    winner that took a branch; from the graph, each active entry's successor
    record and bases and each branching winner's color signature. Past f_r
    it needs at most one step, a re-rank of its kept entries (B log2 B
    compares), and only where T > f_r: the reference's later steps change
    nothing the result reads (correct.beam.beam_search_by_region). Then one
    walk of min(T, f_r+1) steps back through the history. Returns the
    counts, T, and bytes and operations for the bound."""
    import math
    from ratatosk_tpu_torch.correct import beam as BM
    from ratatosk_tpu_torch.ops import sprint as SP
    R, NT = rb.tgt_masks.shape
    W, B, H = BM.band_width(NT, band), beam, g.color_sig.shape[1]
    dev = rb.tgt_masks.device
    real = torch.arange(R, device=dev) < n_real
    st, pt = BM._init_state(rb, B, lmax, W)
    f = torch.zeros(R, dtype=torch.int64, device=dev)
    # per region: sprint rows, valid candidates (one DP row each), emitting
    # winners, no-successor keeps, branching winners, graph bytes
    n = torch.zeros((6, R), dtype=torch.int64, device=dev)
    t = 0
    while t < lmax and bool((st.live & ~st.frozen).any()):
        act = st.live & ~st.frozen & real[:, None]
        act_r = act.any(dim=1)
        uid = (st.tip >> 1).clamp(0, g.utbl.shape[0] - 1).long()
        rec = g.utbl[uid, (st.tip & 1).long()]
        s1, sbits, scnt = BM._sprint_advance(g, rb, pt, st, rec, smax,
                                             SP.sprint_rows_ref)
        at_bound = act & (s1.off >= rec[..., 4])
        nsucc = (rec[..., :4] >= 0).sum(dim=-1)
        ncand = torch.where(at_bound, nsucc, act.long())
        s2 = BM._beam_step(g, rb, pt, s1, t, min_cov, rec, sbits, scnt)
        h = s2.hist[t]
        par = ((h >> 3) & 127).long()
        # a branching winner's signature decides whether it stays live; an
        # emitting winner's row matters only if it does
        branch_w = act_r[:, None] & (s2.nvis > s1.nvis.gather(1, par))
        emit_w = act_r[:, None] & s2.live & (((h >> 2) & 1) == 1)
        sprint_n = torch.where(act, scnt, 0).sum(dim=1)
        n += torch.stack([
            sprint_n, ncand.sum(dim=1), emit_w.sum(dim=1),
            (at_bound & (nsucc == 0)).sum(dim=1), branch_w.sum(dim=1),
            24 * act.sum(dim=1) + sprint_n + (act & ~at_bound).sum(dim=1)
            + H * branch_w.sum(dim=1)])
        f += act_r
        st, t = s2, t + 1
    T = t
    cols = (rb.tgt_len.long() + 1).clamp(max=W)
    sprint_rows, cand_rows, emit_rows, _ = n[:4].sum(dim=1).tolist()
    sprint_cells, cand_cells, emit_cells, keep_cells = (
        (n[:4] * cols).sum(dim=1).tolist())
    n_branch, graph_bytes = (int(x) for x in n[4:].sum(dim=1).tolist())
    f_real = f[:n_real]
    active_steps = int(f_real.sum())
    keep_steps = int((f_real < T).sum())
    walk_steps = int((f_real + 1).clamp(max=T).sum())
    C = 4 * B
    ops = (sprint_cells * (DP_OPS + SCAN_OPS)
           + cand_cells * (DP_OPS + STATS_OPS)
           + emit_cells * SCAN_OPS + keep_cells * STATS_OPS
           + 8 * cand_rows + active_steps * C * math.ceil(math.log2(C))
           + 5 * H * n_branch
           + keep_steps * B * max(1, math.ceil(math.log2(B)))
           + walk_steps * smax)
    in_bytes = sum(getattr(rb, fl)[:n_real].numel()
                   * getattr(rb, fl).element_size()
                   for fl in ("tgt_masks", "tgt_len", "start_tip",
                              "start_off", "end_tip", "end_off",
                              "colors_sig", "colors_wsig", "max_plen",
                              "end_cyclic"))
    nbytes = in_bytes + graph_bytes + n_real * (lmax + 6 * 4 + 1)
    return dict(T=T, f_max=int(f_real.max()) if n_real else 0,
                f_mean=active_steps / max(n_real, 1), ops=ops, bytes=nbytes,
                sprint_rows=sprint_rows, cand_rows=cand_rows,
                emit_rows=emit_rows, branch_winners=n_branch)


# int32 operations per 32-column word of a bit-parallel DP row (Myers /
# Hyyro): the update (Xv, Xh with its add, Ph, Mh, their shifts, Pv, Mv),
# the row's match word (a shift of the mask's precomputed word), and the
# word's share of the row minimum (four byte lookups, each with an add and
# a min)
MYERS_OPS, EQ_OPS, ROWMIN_OPS = 17, 1, 12


def finish_work(torch, rb, res, *, band: int, n_real: int) -> dict:
    """The work the finish bundle needs: for each planned row, the DP rows
    0..max(tgt_len, best_end) at min(W, best_len + 1) columns each (the
    decisions read no column past best_len), bit-parallel: each row's
    ceil(columns / 32) words at MYERS_OPS + EQ_OPS + ROWMIN_OPS int32
    operations each (about one a cell); bytes: the target masks and
    qualities those rows read, the path, the scalars in and out, the packed
    path out."""
    L = res.best_seq.shape[1]
    NT = rb.tgt_masks.shape[1]
    Wf = L + 1 if band <= 0 or band >= L + 1 else band
    n = rb.tgt_len[:n_real].long()
    last = torch.maximum(n, res.best_end[:n_real].long().clamp(0, NT))
    blen = res.best_len[:n_real].long()
    cols = (blen + 1).clamp_max(Wf)
    cells = int(((last + 1) * cols).sum())
    words = int(((last + 1) * ((cols + 31) // 32)).sum())
    nbytes = (int(last.sum()) + 4 * int(n.sum()) + int(blen.sum())
              + n_real * (21 + 11 * 4 + 4 * -(-L // 16)))
    return dict(W=Wf, rows=int((last + 1).sum()),
                max_rows=int(last.max()) + 1 if n_real else 1, cells=cells,
                words=words, ops=(MYERS_OPS + EQ_OPS + ROWMIN_OPS) * words,
                bytes=nbytes)


def beam_phase_ms(torch, g, rb, *, beam, lmax, min_cov, band, reps=5):
    """(launch 1 ms, launch 2 ms) of the fused beam kernel, each the mean
    of `reps` calls after a warm-up: CUDA events before the first launch
    and after each (through the wrapper's enqueue, uncounted). A 1 ms
    device sleep before the first event keeps the host's enqueue out of
    launch 1's time."""
    from ratatosk_tpu_torch.correct import beam as BM
    from ratatosk_tpu_torch.ops import beam_kernel, cuda_lib
    dev = rb.tgt_masks.device
    stream = torch.cuda.current_stream(dev)
    W = BM.band_width(rb.tgt_masks.shape[1], band)
    tot = [0.0, 0.0]
    for rep in range(reps + 1):
        torch.cuda._sleep(2_000_000)
        marks = [torch.cuda.Event(enable_timing=True)]
        marks[0].record(stream)

        def mark():
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record(stream)
        beam_kernel.enqueue(cuda_lib.library(), g, rb, beam=beam, W=W,
                            lmax=lmax, min_cov=min_cov, sprint=8,
                            index=cuda_lib.device_index(dev),
                            stream=stream.cuda_stream, counted=mark)
        torch.cuda.synchronize()
        if rep:
            tot[0] += marks[0].elapsed_time(marks[1]) / reps
            tot[1] += marks[1].elapsed_time(marks[2]) / reps
    return tot[0], tot[1]


def phase_fused_kernels(torch, sl: dict, dev):
    """The fused beam kernel and the finish kernel against their plain
    versions on one launch of each bucket: bit-identical, the kernels timed
    with CUDA events, the plain versions once."""
    from ratatosk_tpu_torch.correct import beam as BM
    from ratatosk_tpu_torch.correct import finish as FN
    from ratatosk_tpu_torch.ops.beam_kernel import fused_beam_search
    from ratatosk_tpu_torch.ops.finish_kernel import finish_bundle_kernel
    t0 = time.time()
    batches = bucket_batches(sl, dev)
    log(f"[kernel] planned one launch per bucket in {time.time() - t0:.1f}s")
    rows = {"fused_beam_search": {}, "finish_bundle_kernel": {}}
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    for nt, b in batches.items():
        g, rb, lmax, band, W, B = (b["g"], b["rb"], b["lmax"], b["band"],
                                   b["W"], b["beam"])
        R = rb.tgt_masks.shape[0]
        kw = dict(beam=B, lmax=lmax, min_cov=b["min_cov"], band=band)
        got = fused_beam_search(g, rb, **kw)
        torch.cuda.synchronize()
        # the plain version, once
        a, z = ev(), ev()
        a.record()
        want = BM.beam_search(g, rb, impl="torch", **kw)
        z.record()
        torch.cuda.synchronize()
        plain = a.elapsed_time(z)
        err = 0
        for f in BM.FIELDS:
            x, y = getattr(got, f), getattr(want, f)
            err = max(err, int((x.long() - y.long()).abs().max()))
            if not torch.equal(x, y):
                raise AssertionError(f"fused beam kernel differs from the "
                                     f"plain version at NT={nt}, field {f}: "
                                     f"max abs err {err}")
        ms = _call_ms(torch, lambda: fused_beam_search(g, rb, **kw))
        p1, p2 = beam_phase_ms(torch, g, rb, **kw)
        wk = beam_work(torch, g, rb, n_real=b["n_real"], **kw)
        T = wk["T"]
        bound, by = _bound_ms(wk["bytes"], wk["ops"])
        rows["fused_beam_search"][nt] = dict(
            R=R, n_real=b["n_real"], B=B, W=W, T=T, f_max=wk["f_max"],
            f_mean=wk["f_mean"], max_abs_err=err, ms=ms, phase1_ms=p1,
            phase2_ms=p2, ms_per_step=ms / max(T, 1), plain_ms=plain,
            bound_ms=bound, bound_by=by, source=b["tag"])
        log(f"[kernel] fused_beam_search NT={nt} ({b['tag']}): R={R} "
            f"({b['n_real']} real) B={B} W={W} lmax={lmax} T={T} (real "
            f"regions' own steps: mean {wk['f_mean']:.1f}, f_max "
            f"{wk['f_max']}): bit-identical to the plain version; kernel "
            f"{ms:.4f} ms (2 launches; launch 1 {p1:.4f} ms, launch 2 "
            f"{p2:.4f} ms; {1e3 * ms / max(T, 1):.2f} us per step), plain "
            f"{plain:.1f} ms; bound "
            f"{bound:.4f} ms ({by}: {wk['ops']} int32 ops for "
            f"{wk['sprint_rows']} sprint rows, {wk['cand_rows']} candidate "
            f"rows, {wk['emit_rows']} rebuilt rows, {wk['branch_winners']} "
            f"color checks; {wk['bytes']} bytes)")

        fkw = dict(w=band, min_score_open=b["mso"])
        fargs = (rb.tgt_masks, rb.tgt_len, rb.tgt_qual, b["qv_max"], b["k"],
                 want)
        fo = finish_bundle_kernel(*fargs, **fkw)
        torch.cuda.synchronize()
        a, z = ev(), ev()
        a.record()
        fw = FN.finish_bundle(*fargs, **fkw)
        z.record()
        torch.cuda.synchronize()
        fplain = a.elapsed_time(z)
        ferr = max(int((fo.scalars - fw.scalars).abs().max()),
                   int((fo.seq_packed.long() - fw.seq_packed.long())
                       .abs().max()))
        if not (torch.equal(fo.scalars, fw.scalars)
                and torch.equal(fo.seq_packed, fw.seq_packed)):
            raise AssertionError(f"finish kernel differs from finish_bundle "
                                 f"at NT={nt}: max abs err {ferr}")
        fms = _call_ms(torch, lambda: finish_bundle_kernel(*fargs, **fkw),
                       reps=10)
        fw = finish_work(torch, rb, want, band=band, n_real=b["n_real"])
        fbound, fby = _bound_ms(fw["bytes"], fw["ops"])
        us_row = 1e3 * fms / fw["max_rows"]
        rows["finish_bundle_kernel"][nt] = dict(
            R=R, W=fw["W"], rows=fw["rows"], longest_rows=fw["max_rows"],
            us_per_row=us_row, cells=fw["cells"], max_abs_err=ferr, ms=fms,
            plain_ms=fplain, bound_ms=fbound, bound_by=fby)
        log(f"[kernel] finish_bundle_kernel NT={nt}: R={R} L={lmax} "
            f"W={fw['W']}, {fw['rows']} DP rows of the real regions (the "
            f"longest region {fw['max_rows']}), {fw['cells']} cells in "
            f"{fw['words']} 32-column words up to best_len: bit-identical to "
            f"finish_bundle; kernel {fms:.4f} ms ({us_row:.3f} us per row of "
            f"the longest region), plain {fplain:.1f} ms, bound "
            f"{fbound:.4f} ms ({fby}: {fw['ops']} int32 ops, {fw['bytes']} "
            f"bytes)")
    return rows, batches


def phase_wide(torch, batches: dict, dev) -> dict:
    """Bands past 512 columns on the slice's planned regions: the 2048
    bucket's launch with band_width=600 (both kernels at W=600, the band
    moving along the regions longer than 600), and the 256 bucket's
    regions packed with weak_region_len_factor=0.6 (the finish kernel's
    full path row of 569 columns). Each kernel against its plain version,
    bit for bit; each kernel's call timed once after a warm-up call."""
    from ratatosk_tpu_torch.correct import beam as BM
    from ratatosk_tpu_torch.correct import finish as FN
    from ratatosk_tpu_torch.correct.engine import region_arrays
    from ratatosk_tpu_torch.ops.beam_kernel import fused_beam_search
    from ratatosk_tpu_torch.ops.finish_kernel import finish_bundle_kernel
    out = {}
    b2, b1 = batches[2048], batches[256]
    arrays, lmax6 = region_arrays(b1["specs"], 256, b1["cap"],
                                  r_pad=b1["rb"].tgt_masks.shape[0],
                                  len_factor=0.6)
    for tag, b, rb, lmax, band in (
            ("band_width=600, NT=2048", b2, b2["rb"], b2["lmax"], 600),
            ("weak_region_len_factor=0.6, NT=256", b1,
             BM.RegionBatch.from_numpy(arrays, dev), lmax6, 0)):
        kw = dict(beam=b["beam"], lmax=lmax, min_cov=b["min_cov"], band=band)
        want = BM.beam_search(b["g"], rb, impl="torch", **kw)
        got = fused_beam_search(b["g"], rb, **kw)
        torch.cuda.synchronize()
        for f in BM.FIELDS:
            if not torch.equal(getattr(got, f), getattr(want, f)):
                raise AssertionError(f"[wide] {tag}: the beam kernel differs "
                                     f"from the plain version in {f}")
        fargs = (rb.tgt_masks, rb.tgt_len, rb.tgt_qual, b["qv_max"], b["k"],
                 want)
        fkw = dict(w=band, min_score_open=b["mso"])
        fo = finish_bundle_kernel(*fargs, **fkw)
        fwant = FN.finish_bundle(*fargs, **fkw)
        if not (torch.equal(fo.scalars, fwant.scalars)
                and torch.equal(fo.seq_packed, fwant.seq_packed)):
            raise AssertionError(f"[wide] {tag}: the finish kernel differs "
                                 "from finish_bundle")
        ms = _call_ms(torch, lambda: fused_beam_search(b["g"], rb, **kw),
                      reps=1)
        fms = _call_ms(torch, lambda: finish_bundle_kernel(*fargs, **fkw),
                       reps=1)
        W = BM.band_width(rb.tgt_masks.shape[1], band)
        Wf = lmax + 1 if band <= 0 or band >= lmax + 1 else band
        moving = (f" ({int((rb.tgt_len > W).sum())} regions longer than "
                  "the band)" if band else "")
        out[tag] = dict(W=W, finish_W=Wf, ms=ms, finish_ms=fms)
        log(f"[wide] {tag}: beam W={W}{moving}, finish W={Wf}, lmax={lmax}: "
            f"both kernels bit-identical "
            f"to their plain versions; beam kernel {ms:.4f} ms, finish "
            f"kernel {fms:.4f} ms")
    return out


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
    _reset_launches()                    # counts cover the main path only
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
    launches = _launches()
    log(f"[slice] pass 2: {n2} reads in {times['p2_correct']:.1f}s; "
        + ", ".join(f"{k}={v:.1f}s" for k, v in corr2.timers.items()))

    if dev.type == "cuda":
        _require_launches("slice", launches)
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


class SprintCapture:
    """Watches the "steps" route's sprint kernel calls (correct/beam.py
    reads its module's `sprint_rows` at each beam_search call): counts
    them by band width and keeps a copy of the inputs of the first call at
    band width W."""

    def __init__(self, W: int = 257):
        self.W, self.args, self.smax, self.widths = W, None, None, {}

    def __enter__(self):
        from ratatosk_tpu_torch.correct import beam as BM
        self._orig = orig = BM.sprint_rows

        def spy(*args, smax):
            w = int(args[0].shape[2])
            self.widths[w] = self.widths.get(w, 0) + 1
            if self.args is None and w == self.W:
                self.args, self.smax = [a.clone() for a in args], smax
            return orig(*args, smax=smax)
        BM.sprint_rows = spy
        return self

    def __exit__(self, *exc):
        from ratatosk_tpu_torch.correct import beam as BM
        BM.sprint_rows = self._orig


def head_reads(sl: dict, workdir: str, n: int) -> str:
    """The slice's first n long reads, as a FASTQ file."""
    head = os.path.join(workdir, f"head{n}.fq")
    with open(sl["lr_path"]) as src, open(head, "w") as f:
        for _ in range(4 * n):
            f.write(src.readline())
    return head


def steps_pass(device, sl: dict, head: str, path: str, **opt_kw):
    """Pass 1 on `head` through impl="steps" (with opt_kw changed in the
    pass-1 options) under a SprintCapture, launch counts reset just before:
    (FASTQ bytes, launch counts, the capture)."""
    import dataclasses

    import torch
    from ratatosk_tpu_torch.correct.engine import Corrector
    from ratatosk_tpu_torch.pipeline import correct_file
    corr1 = sl["corr1"]
    o1 = dataclasses.replace(sl["o1"], **opt_kw)
    corr = Corrector(corr1.cdbg, corr1.colors, o1, device=device,
                     impl="steps")
    with SprintCapture() as cap:
        _reset_launches()
        torch.cuda.synchronize()
        correct_file(corr, o1, [head], path, 1)
        torch.cuda.synchronize()
        counts = _launches(KERNELS)
    return Path(path).read_bytes(), counts, cap


def phase_plain_vs_kernel(device, sl: dict, workdir: str, n: int = 16):
    """Pass 1 on the first n long reads through each impl route: "auto"
    (the fused kernels), "steps" (per-step torch with the sprint kernel)
    and "torch" (plain): the FASTQ bytes must match. Then the sprint
    kernel against its plain version on the "steps" run's first launch at
    the NT=256 band (W=257), as the engine formed it. Returns (reads file,
    FASTQ bytes, the sprint kernel's launches in the "steps" run, that
    launch's row)."""
    import torch
    from ratatosk_tpu_torch.correct.engine import Corrector
    from ratatosk_tpu_torch.pipeline import correct_file
    head = head_reads(sl, workdir, n)
    corr1, o1 = sl["corr1"], sl["o1"]
    outs, counts = {}, {}
    for impl in ("auto", "steps", "torch"):
        t = time.time()
        path = str(Path(workdir) / f"{impl}.fq")
        if impl == "steps":
            outs[impl], counts[impl], cap = steps_pass(device, sl, head,
                                                       path)
        else:
            corr = corr1 if impl == "auto" else Corrector(
                corr1.cdbg, corr1.colors, o1, device=device, impl=impl)
            _reset_launches()
            torch.cuda.synchronize()
            correct_file(corr, o1, [head], path, 1)
            torch.cuda.synchronize()
            counts[impl] = _launches(KERNELS)
            outs[impl] = Path(path).read_bytes()
        log(f"[plain] pass 1 on {n} reads, impl={impl!r}: "
            f"{time.time() - t:.1f}s; launches {counts[impl]}")
    if not outs["auto"] == outs["steps"] == outs["torch"]:
        raise AssertionError("pass-1 FASTQ differs between the impl routes "
                             "auto / steps / torch")
    _require_launches("plain auto", {k: counts["auto"][k]
                                     for k in PATH_KERNELS})
    if counts["steps"]["sprint_rows"] <= 0:
        raise AssertionError("the sprint kernel never launched on the "
                             "steps route")
    if sum(counts["torch"].values()) or counts["auto"]["sprint_rows"] \
            or counts["steps"]["fused_beam_search"]:
        raise AssertionError(f"a route launched another route's kernel: "
                             f"{counts}")
    log(f"[plain] FASTQ byte-identical across auto / steps / torch "
        f"({len(outs['auto'])} bytes); sprint launches by band width "
        f"{dict(sorted(cap.widths.items()))}")
    if cap.args is None:
        raise AssertionError("the steps route made no sprint launch at "
                             "W=257")
    row = sprint_row(torch, cap.args, cap.smax,
                     "engine launch (first at NT=256)")
    return head, outs["auto"], counts["steps"]["sprint_rows"], row


def phase_wide_steps(device, sl: dict, workdir: str, head: str):
    """[wide] impl="steps" at band_width=600: pass 1 on the [plain] reads
    must equal impl="torch" at the same options byte for byte, with sprint
    launches at a band past 512 columns."""
    import dataclasses

    from ratatosk_tpu_torch.correct.engine import Corrector
    from ratatosk_tpu_torch.pipeline import correct_file
    t = time.time()
    got, counts, cap = steps_pass(device, sl, head,
                                  os.path.join(workdir, "steps600.fq"),
                                  band_width=600)
    o1 = dataclasses.replace(sl["o1"], band_width=600)
    corr = Corrector(sl["corr1"].cdbg, sl["corr1"].colors, o1,
                     device=device, impl="torch")
    path = os.path.join(workdir, "torch600.fq")
    correct_file(corr, o1, [head], path, 1)
    if got != Path(path).read_bytes():
        raise AssertionError("[wide] impl='steps' at band_width=600 differs "
                             "from impl='torch'")
    if not any(w > 512 for w in cap.widths):
        raise AssertionError(f"[wide] no sprint launch past 512 columns: "
                             f"{cap.widths}")
    log(f"[wide] impl='steps' at band_width=600: FASTQ byte-identical to "
        f"impl='torch' ({len(got)} bytes, {time.time() - t:.1f}s); sprint "
        f"launches by band width {dict(sorted(cap.widths.items()))}")
    return counts["sprint_rows"]


def phase_trace(sl: dict, workdir: str):
    """Pass 1 of the slice once more under torch.profiler: the device busy
    share (the union of the kernels' intervals over the pass's wall time),
    the pass seconds, the plan / launch / finish shares and the kernels that
    take the device time (bench_torch.device_busy). The FASTQ must equal the
    slice's."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from bench_torch import device_busy
    from ratatosk_tpu_torch.correct.engine import Corrector
    from ratatosk_tpu_torch.pipeline import correct_file
    c1, o1 = sl["corr1"], sl["o1"]
    corr = Corrector(c1.cdbg, c1.colors, o1, device=c1.device)
    out = os.path.join(workdir, "trace.p1.fastq")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        correct_file(corr, o1, [sl["lr_path"]], out, 1)
        torch.cuda.synchronize()
        wall = time.time() - t
    if Path(out).read_bytes() != Path(sl["p1_path"]).read_bytes():
        raise AssertionError("[trace] the traced pass 1 differs from the "
                             "slice's")
    busy = device_busy(prof, wall)
    tm = corr.timers
    log(f"[trace] pass 1 traced (torch.profiler, CPU+CUDA): {wall:.2f}s "
        f"wall; plan {tm['plan']:.2f}s ({tm['plan'] / wall:.1%}), launch "
        f"{tm['launch']:.2f}s ({tm['launch'] / wall:.1%}), finish "
        f"{tm['finish']:.2f}s ({tm['finish'] / wall:.1%}); "
        f"{busy['device_ops']} device ops, device busy {busy['busy_s']:.3f}s "
        f"= {busy['busy_share']:.2%} of the wall; device time by kernel: "
        + "; ".join(f"{n[:60]} {ms:.1f} ms"
                    for n, ms in busy["top_kernels_ms"]))
    return dict(wall=wall, busy_share=busy["busy_share"], timers=dict(tm))


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
    """The anchor-free spans Planner._plan_seeds probes for 1-edit seeds
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


def plan_batches(sl: dict, device):
    """[devplan]'s planner batches: per graph (k31: the raw long reads,
    k63: the pass-1 reads) the first read batch (~1 Mbp) and a
    DevicePlanner warmed at the slice's batch size (so that every batch pads
    to its tier, L = 2^21). Yields (graph, Corrector, planner, reads,
    seconds of the planner's build and warm-up)."""
    from ratatosk_tpu_torch.correct.engine import _NEAR_EXACT_SKIP
    from ratatosk_tpu_torch.ops.plan_device import DevicePlanner
    o1 = sl["o1"]
    for name, corr, path in (("k31", sl["corr1"], sl["lr_path"]),
                             ("k63", sl["corr2"], sl["p1_path"])):
        reads = _first_batch(path, o1.read_batch_bp)
        t = time.time()
        dp = DevicePlanner.build(corr.cdbg, device)
        dp.warmup(o1.read_batch_bp, stride=o1.weak_seed_stride,
                  near_exact_skip=_NEAR_EXACT_SKIP)
        yield name, corr, dp, reads, time.time() - t


def _run_keys(lists):
    return [[(r.s, r.e, r.uid, r.direction, r.o_s, r.weak, r.rspan)
             for r in runs] for runs in lists]


# the planner kernels' bounds count what a batch needs, each random read
# one 32-byte sector: a probed key's directory pair (one sector) and the
# sectors that its bucket's key rows span up to its match or the bucket's
# end, a hit's rowflag entry (and for the runs its upa entry), a
# reverse-direction run's nk entry, a tested h-window's or 1-edit
# variant's bitmap word; packing, hashing and comparing a window or a
# variant is ~64 int32 operations
SECTOR = 32
OPS_PER_KEY = 64


def _key_sectors(torch, hx, lo, hi):
    """(sectors, hit mask) of probing each key (int64-held words lo, hi):
    its directory pair, the sectors that its bucket's key rows span from
    the bucket's start through its match (else to the bucket's end, at most
    dmax rows), and its rowflag entry on a hit."""
    from ratatosk_tpu_torch.ops import hash_index as HX
    hi = hi if hx.two_word else None
    b = HX.hash_key64(lo, hi) >> (32 - hx.bits)
    d0 = hx.dir0[b]
    nb = 1 << hx.bits
    end = torch.where(b + 1 < nb, hx.dir0[torch.clamp(b + 1, max=nb - 1)],
                      2 * hx.n)
    slot = HX.probe_slots_raw(hx, lo, hi)
    hit = slot >= 0
    stop = torch.where(hit, slot + 1, torch.minimum(end, d0 + hx.dmax))
    row = 4 * hx.key_tbl.shape[1]
    spans = torch.where(stop > d0, (stop * row - 1) // SECTOR
                        - d0 * row // SECTOR + 1, 0)
    return lo.numel() + int(spans.sum()) + int(hit.sum()), hit


def runs_need(torch, dp, codes, want, rcap: int):
    """(bytes, int32 operations, counts) that the runs of a batch need:
    each valid k-window probed, a hit's upa entry, a reverse-direction
    run's nk entry (of the runs the outputs hold), the codes read once and
    the outputs written once."""
    from ratatosk_tpu_torch.ops import plan_device as PD
    whi, wlo, valid = PD._pack_windows(codes, dp.k)
    sectors, hit = _key_sectors(torch, dp.hx, wlo[valid], whi[valid])
    n = min(int(want[-1]), rcap)
    sectors += int(hit.sum()) + int((want[3][:n] == 1).sum())
    windows = int(valid.sum())
    nbytes = SECTOR * sectors + len(codes) + 8 * (5 * rcap + 1)
    return nbytes, OPS_PER_KEY * windows, dict(windows=windows,
                                               sectors=sectors)


def probe_need(torch, dp, codes, starts, opts, want):
    """(bytes, int32 operations, counts) that the 1-edit probe of a batch
    needs: each valid k-window probed; the h-window bitmap word of each
    allowed position and of its kinds' suffixes; one prefilter word per
    enumerated variant (the first qcap qualifying positions of each
    (kind, side), SUB's 3 other bases, DEL's 1, INS's 4 per edit position);
    each survivor probed; the codes (and the span starts at a stride) read
    once and the outputs written once. Its allowed positions, most
    qualifying positions and survivors must be the plain version's
    stats[0:3]."""
    from ratatosk_tpu_torch.ops import hash_index as HX
    from ratatosk_tpu_torch.ops import plan_device as PD
    k, L, dev, two = dp.k, len(codes), codes.device, dp.hx.two_word
    sstart = PD.span_sstart(starts, L)
    h = (k - 1) // 2
    pos = torch.arange(L, device=dev)

    def pad(x):
        return torch.cat([x, x.new_zeros(L - len(x))])

    whi, wlo, valid = PD._pack_windows(codes, k)
    sectors, hit = _key_sectors(torch, dp.hx, wlo[valid], whi[valid])
    windows = int(valid.sum())
    ex = pad(valid)
    ex[:len(valid)][valid] = hit
    nes = opts["nes"]
    skip = torch.zeros(L, dtype=torch.bool, device=dev)
    if nes > 0:
        cs = torch.cat([pos.new_zeros(1), torch.cumsum(ex, 0)])
        skip = (cs[torch.clamp(pos + nes + 1, max=L)]
                - cs[torch.clamp(pos - nes, min=0)]) > 0
    allowed = ~skip & ((pos - sstart) % opts["stride"] == 0)
    _, hlo, hvalid = PD._pack_windows(codes, h)
    half = pad(hvalid & HX.prefilter_test(dp.hf_tbl, dp.hf_bits,
                                          HX.hash_key64(hlo)))
    need_h = torch.zeros(L, dtype=torch.bool, device=dev)
    nqs, variants, found = [], 0, []
    kinds = [(PD._SUB, k, 0)] if opts["subs"] else []
    kinds += [(PD._DEL, k + 1, 1), (PD._INS, k - 1, 1)] \
        if opts["indels"] else []
    for kind, m, p0 in kinds:
        wh, wl, wv = PD._pack_windows(codes, m)
        ok = allowed & pad(wv)
        sfx = torch.clamp(pos + m - h, max=L - 1)
        need_h |= ok
        need_h[sfx[ok]] = True
        suf_max = (k - h) if kind == PD._DEL else (k - 1 - h)
        for flag, ps in ((half, range(max(p0, h), k)),
                         (half[sfx], range(p0, suf_max + 1))):
            q = (ok & flag).nonzero()[:, 0]
            nqs.append(len(q))
            q = q[:opts["qcap"]]
            for p in ps:
                for vh, vl, keep in PD._variant_key(kind, k, wh[q], wl[q], p):
                    if keep is not None:
                        vh, vl = vh[keep], vl[keep]
                    variants += len(vl)
                    pf = HX.prefilter_test(dp.pf_tbl, dp.pf_bits,
                                           HX.hash_key64(vl, vh if two
                                                         else None))
                    found.append((vl[pf], vh[pf]))
    slo, shi = (torch.cat(x) for x in zip(*found))
    survivors = len(slo)
    _, tcap = PD.probe_caps(opts["qcap"])
    counted = [int(allowed.sum()), max(nqs), min(survivors, tcap)]
    if counted != want[6][:3].tolist():
        raise AssertionError(f"[devplan] the bound's counts {counted} are "
                             f"not the plain version's stats "
                             f"{want[6].tolist()}")
    h_tests = int((need_h & pad(hvalid)).sum())
    sectors += h_tests + variants + _key_sectors(torch, dp.hx, slo, shi)[0]
    nbytes = (SECTOR * sectors + L
              + (8 * len(starts) if opts["stride"] > 1 else 0)
              + 8 * (4 * opts["hcap"] + 5) + 1)
    return nbytes, OPS_PER_KEY * (windows + h_tests + variants), dict(
        survivors=survivors, allowed=counted[0], variants=variants,
        sectors=sectors, windows=windows, h_tests=h_tests)


def _kernels_per_call(fn) -> int:
    """CUDA kernels that one call of a planner kernel's wrapper enqueues,
    as its launcher counts them (plan_kernels_enqueued: int, no argument,
    ctypes' default signature)."""
    from ratatosk_tpu_torch.ops import cuda_lib
    fn()
    return cuda_lib.library().plan_kernels_enqueued()


def plan_kernel_rows(torch, dp, reads, spans, *, stride: int, nes: int,
                     tag: str, reps: int = 5) -> dict:
    """The runs and probe kernels against their plain versions on one read
    batch, on the card: every output tensor equal (on a batch whose caps
    overflow, `of` and stats[0:3], as the host then plans it), each timed
    with CUDA events behind a device sleep, the plain versions over 3
    calls, with the bound counted from what the batch needs and the CUDA
    kernels a call runs."""
    from ratatosk_tpu_torch.ops import plan_device as PD
    from ratatosk_tpu_torch.ops import plan_kernel as PK
    dev = dp.device
    rcodes, _, rcap = dp.runs_inputs(reads)
    rcodes = torch.from_numpy(rcodes).to(dev)
    codes, starts = dp.probe_inputs(reads, spans)
    codes, starts = (torch.from_numpy(x).to(dev) for x in (codes, starts))
    sstart = PD.span_sstart(starts, len(codes))
    opts = dp.probe_options(len(codes), stride=stride, near_exact_skip=nes)
    calls = {
        "runs_kernel": (
            lambda: PK.runs_kernel(rcodes, dp.hx, dp.nk_dev, k=dp.k,
                                   rcap=rcap),
            lambda: PD._runs_kernel(rcodes, dp.hx, dp.nk_dev, k=dp.k,
                                    rcap=rcap)),
        "probe_kernel": (
            lambda: PK.probe_kernel(codes, starts, dp.hx, dp.pf_tbl,
                                    dp.hf_tbl, **opts),
            lambda: PD._probe_kernel(codes, sstart, dp.hx, dp.pf_tbl,
                                     dp.hf_tbl, **opts))}
    rows = {}
    for name, (kern, plain) in calls.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if name == "probe_kernel" and bool(want[5]):
            pairs = [(got[5], want[5]), (got[6][:3], want[6][:3])]
        else:
            pairs = list(zip(got, want))
        err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
                  for g, w in pairs)
        if not all(g.dtype == w.dtype and torch.equal(g, w)
                   for g, w in pairs):
            raise AssertionError(f"[devplan] {name} differs from its plain "
                                 f"version at k={dp.k}: max abs err {err}")
        ms = _call_ms(torch, kern, reps=reps)
        plain_ms = _call_ms(torch, plain, reps=3)
        n_cuda = _kernels_per_call(kern)
        L = len(rcodes) if name == "runs_kernel" else len(codes)
        if name == "runs_kernel":
            nbytes, ops, extra = runs_need(torch, dp, rcodes, want, rcap)
            extra.update(n=int(want[-1]), rcap=rcap)
        else:
            nbytes, ops, extra = probe_need(torch, dp, codes, starts, opts,
                                            want)
            extra.update(of=bool(want[5]), stats=want[6].tolist())
        bound, by = _bound_ms(nbytes, ops)
        rows[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound, bound_by=by, L=L,
                          cuda_kernels=n_cuda, **extra)
        log(f"[devplan] {name} {tag} ({len(reads)} reads, "
            f"{sum(map(len, reads))} bp) k={dp.k} L={L}: equal to its plain "
            f"version; kernel {ms:.4f} ms ({n_cuda} CUDA kernels a call), "
            f"plain {plain_ms:.1f} ms, bound {bound:.4f} ms ({by}); {extra}")
    return rows


def phase_devplan(device, sl: dict, workdir: str, head: str,
                  host_fastq: bytes):
    """The device planner against the host planner on the card: runs and
    seeds of one read batch per graph, ms per batch, the planner kernels
    against their plain versions on that batch, then a pass-1 run with
    plan_on_device=True. Returns (the kernels' launches in that run, the
    planner kernels' rows by graph)."""
    import dataclasses
    import torch
    from ratatosk_tpu_torch.correct.engine import _NEAR_EXACT_SKIP, Corrector
    from ratatosk_tpu_torch.correct.seeds import (find_runs,
                                                  find_weak_seeds_batch)
    from ratatosk_tpu_torch.pipeline import correct_file
    o1 = sl["o1"]
    stride, nes = o1.weak_seed_stride, _NEAR_EXACT_SKIP
    batches = fallbacks = 0
    rows = {n: {} for n in PLAN_KERNELS}
    for name, corr, dp, reads, t_build in plan_batches(sl, device):
        cdbg = corr.cdbg

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
        # the kernels on the batch and on its first 16 reads alone (both
        # padded to the tier): the time a call takes whatever the batch holds
        for tag, n in ((name, len(reads)), (f"{name}_16", 16)):
            for kname, row in plan_kernel_rows(
                    torch, dp, reads[:n], [s for s in spans if s[0] < n],
                    stride=stride, nes=nes, tag=tag).items():
                rows[kname][tag] = row

    o1d = dataclasses.replace(o1, plan_on_device=True)
    corr = Corrector(sl["corr1"].cdbg, sl["corr1"].colors, o1d, device=device)
    corr.warmup_compile()
    out = Path(workdir) / "devplan.fq"
    _reset_launches()
    torch.cuda.synchronize()
    t = time.time()
    correct_file(corr, o1d, [head], str(out), 1)
    torch.cuda.synchronize()
    launches = _launches(PATH_KERNELS + PLAN_KERNELS)
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
        f"{fallbacks} of {batches} planner batches fell back; planner split "
        f"(s) {({n: round(v, 4) for n, v in corr.devplan.timers.items()})}")
    _require_launches("devplan", launches)
    return launches, rows


def make_slots(torch):
    """cuda:0..n-1 with two or more cards, else two slots on cuda:0."""
    from ratatosk_tpu_torch.parallel import mesh as M
    n = torch.cuda.device_count()
    devs = ([torch.device("cuda", i) for i in range(n)] if n >= 2
            else [torch.device("cuda", 0)] * 2)
    how = (f"{n} cards, one slot each" if n >= 2
           else "one card, two slots (streams) on cuda:0")
    return M.make_mesh(devices=devs), how


def _two_passes(tag: str, sl: dict, workdir: str, place: dict, mem=None,
                names=PATH_KERNELS, **opt_kw):
    """Both passes of the slice through fresh Correctors on the slice's
    graphs, placed by `place` (device=... or mesh=...); the FASTQ files must
    equal the slice's, and every kernel of `names` must launch. Returns
    (launches, pass seconds). A dict `mem` gets each pass's peak allocated
    and reserved memory of the current device (peaks reset before the pass)
    and the process's peak RSS after it."""
    import dataclasses
    import resource
    import torch
    from ratatosk_tpu_torch.correct.engine import Corrector
    from ratatosk_tpu_torch.pipeline import correct_file
    o1 = dataclasses.replace(sl["o1"], **opt_kw)
    o2 = dataclasses.replace(sl["o2"], **opt_kw)
    c1, c2 = sl["corr1"], sl["corr2"]
    corr1 = Corrector(c1.cdbg, c1.colors, o1, **place)
    corr1.warmup_compile()
    corr2 = Corrector(c2.cdbg, c2.colors, o2, **place)
    if opt_kw.get("shard_index_min_keys") == 0 and (
            corr1.sharded is None or corr2.sharded is None):
        raise AssertionError(f"[{tag}] the sharded index is not in use")
    secs = {}
    _reset_launches()
    torch.cuda.synchronize()
    for p, corr, o, src, ref in ((1, corr1, o1, sl["lr_path"], sl["p1_path"]),
                                 (2, corr2, o2, sl["p1_path"], sl["p2_path"])):
        out = os.path.join(workdir, f"{tag}.p{p}.fastq")
        if mem is not None:
            torch.cuda.reset_peak_memory_stats()
        t = time.time()
        correct_file(corr, o, [src], out, p)
        torch.cuda.synchronize()
        secs[p] = time.time() - t
        if mem is not None:
            mem[p] = (torch.cuda.max_memory_allocated(),
                      torch.cuda.max_memory_reserved(),
                      resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
        if Path(out).read_bytes() != Path(ref).read_bytes():
            raise AssertionError(f"[{tag}] pass-{p} FASTQ differs from the "
                                 "single-device slice's")
    launches = _launches(names)
    _require_launches(tag, launches)
    return launches, secs


def phase_warm(sl: dict, workdir: str, dev, smi: str):
    """Both passes of the slice once more on one device, untraced, through
    fresh Correctors on the slice's graphs: the slice's own passes are the
    first in the process and carry its first-use costs, so the rate of one
    card and the mesh's comparison are read here."""
    mem = {}
    launches, secs = _two_passes("warm", sl, workdir, dict(device=dev), mem)
    t = sl["times"]
    dt = secs[1] + secs[2]
    sl["warm"] = secs
    log(f"[warm] both passes again on {dev}, untraced: pass 1 "
        f"{secs[1]:.2f}s (slice {t['p1_correct']:.2f}s), pass 2 "
        f"{secs[2]:.2f}s (slice {t['p2_correct']:.2f}s); byte-identical to "
        f"the slice; {sl['bases']} bases in {dt:.2f}s: "
        f"{sl['bases'] / dt:.1f} corrected bases/s on {smi or dev}; "
        f"{launches} kernel launches")
    for p, (alloc, reserved, rss_kb) in mem.items():
        log(f"[warm] pass {p} memory on {smi or dev}: peak allocated "
            f"{alloc} B, peak reserved {reserved} B; host peak RSS "
            f"{rss_kb} KiB")
    return launches


class LaunchSteps:
    """While open, records each mesh launch's step count: every slot's own
    count and the launch's T (parallel.mesh.StepCount.agree), and the T
    that each slot's beam-kernel launch 2 reads from its t_launch
    (ops.beam_kernel.enqueue_launch2): a copy of it on the slot's stream
    just before launch 2, read on the host only in check(), so the passes
    run with no more host syncs than without it. check() fails unless every
    slot of every launch used its launch's T."""

    def __enter__(self):
        import threading
        from ratatosk_tpu_torch.ops import beam_kernel as BK
        from ratatosk_tpu_torch.parallel import mesh as M
        self.agrees, self.reads = {}, {}
        self._saved = (M.StepCount.agree, BK.enqueue_launch2)
        agree, launch2 = self._saved

        def spy_agree(steps, own):
            T = agree(steps, own)
            self.agrees.setdefault(threading.get_ident(), []).append(
                (id(steps), own, T))
            return T

        def spy_launch2(q):
            # on the current stream, the slot's: after the launch's T is
            # written, before launch 2 reads it
            self.reads.setdefault(threading.get_ident(), []).append(
                q.t_launch.clone())
            return launch2(q)
        M.StepCount.agree, BK.enqueue_launch2 = spy_agree, spy_launch2
        return self

    def __exit__(self, *exc):
        from ratatosk_tpu_torch.ops import beam_kernel as BK
        from ratatosk_tpu_torch.parallel import mesh as M
        M.StepCount.agree, BK.enqueue_launch2 = self._saved

    def check(self, tag: str):
        """(T of each launch, in order; launches in which some slot's own
        count was below T)."""
        launches = {}
        for tid, agrees in self.agrees.items():
            reads = self.reads.get(tid, [])
            if len(reads) != len(agrees):
                raise AssertionError(f"[{tag}] a slot ran {len(agrees)} step "
                                     f"counts and {len(reads)} launch 2s")
            for (key, own, T), got in zip(agrees, reads):
                got = int(got.item())
                if got != T:
                    raise AssertionError(f"[{tag}] a slot's launch 2 read T="
                                         f"{got}, its launch agreed on {T}")
                launches.setdefault(key, []).append((own, T))
        for slots in launches.values():
            if any(T != max(o for o, _ in slots) for _, T in slots):
                raise AssertionError(f"[{tag}] a launch's T is not the max of "
                                     f"its slots' own counts: {slots}")
        if not launches:
            raise AssertionError(f"[{tag}] no mesh launch agreed on a T")
        return ([s[0][1] for s in launches.values()],
                sum(any(o < T for o, T in s) for s in launches.values()))


def _mesh_passes(tag: str, sl: dict, workdir: str, mesh,
                 names=PATH_KERNELS, **opt_kw):
    """Both passes of the slice on `mesh`, against the slice; every slot of
    every launch must run launch 2 with its launch's T. Returns (launches,
    per-slot launches, pass seconds)."""
    with LaunchSteps() as steps:
        launches, secs = _two_passes(tag, sl, workdir, dict(mesh=mesh),
                                     names=names, **opt_kw)
    Ts, below = steps.check(tag)
    log(f"[{tag}] launch-wide step count T of the {len(Ts)} launches: {Ts}; "
        f"every slot's launch 2 read its launch's T; in {below} launches a "
        f"slot's own count was below it")
    w = _wrappers()
    per_slot = {n: [w[n].launches_by_stream.get(mesh.stream(i).cuda_stream, 0)
                    for i in range(mesh.size)] for n in PATH_KERNELS}
    if min(min(v) for v in per_slot.values()) <= 0:
        raise AssertionError(f"[{tag}] a slot never launched a kernel: "
                             f"{per_slot}")
    return launches, per_slot, secs


def phase_mesh(sl: dict, workdir: str, mesh, how: str):
    """Both passes through Corrector(mesh=...), against the slice, with the
    host planner and then with plan_on_device=True (the device planner on
    slot 0's card). Returns the launches of each run, by path."""
    launches, per_slot, secs = _mesh_passes("mesh", sl, workdir, mesh)
    w = sl["warm"]
    log(f"[mesh] {mesh} ({how}): pass 1 {secs[1]:.2f}s (one device, warm "
        f"{w[1]:.2f}s), pass 2 {secs[2]:.2f}s (one device, warm "
        f"{w[2]:.2f}s); both FASTQ files byte-identical to the "
        f"slice's; kernel launches per slot {per_slot} ({launches} in all)")
    dp_launches, per_slot, secs = _mesh_passes(
        "mesh devplan", sl, workdir, mesh, names=PATH_KERNELS + PLAN_KERNELS,
        plan_on_device=True)
    log(f"[mesh] {mesh} with plan_on_device=True (the planner's kernels on "
        f"{mesh.devices[0]}): pass 1 {secs[1]:.2f}s, pass 2 {secs[2]:.2f}s; "
        f"both FASTQ files byte-identical to the slice's; kernel launches "
        f"per slot {per_slot} ({dp_launches} in all)")
    return {"mesh": launches, "mesh_devplan": dp_launches}


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


def phase_lookup(torch, idx, q_lo, q_hi, rows, uid, name: str) -> list:
    """ops/kmer_index.lookup of a batch on the card: its rows must equal
    the same call on the CPU, the host index's rows (`rows`) and the
    sharded index's answers (`uid`: -1 exactly where the row is -1, the
    row's unitig elsewhere). Returns the ms of three timed calls."""
    import numpy as np
    from ratatosk_tpu_torch.ops import kmer_index as KI
    dev_idx = idx.to_device(torch.device("cuda", 0))
    got = KI.lookup(dev_idx, q_lo, q_hi).cpu().numpy()
    cpu = KI.lookup(idx.to_device("cpu"), q_lo, q_hi).numpy()
    hit = got >= 0
    if not (np.array_equal(got, cpu) and np.array_equal(got, rows)
            and np.array_equal(uid >= 0, hit)
            and np.array_equal(uid[hit], idx.unitig_id[got[hit]])):
        raise AssertionError(f"[lookup] {name}: the card's rows differ from "
                             "the CPU's, the host index's or the sharded "
                             "index's")
    ms = []
    for _ in range(3):
        t = time.time()
        KI.lookup(dev_idx, q_lo, q_hi).cpu()
        ms.append(1000 * (time.time() - t))
    return ms


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
        lookup_ms = phase_lookup(torch, idx, q_lo, q_hi, rows, uid, name)
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
        log(f"[lookup] {name}: ops/kmer_index.lookup on cuda:0 "
            f"({'two words' if idx.two_word else 'one word'}, "
            f"{len(q_lo)} queries) equals the CPU's, the host index's rows "
            f"and the sharded index's; ms per batch (upload, search, "
            f"read-back): "
            f"{', '.join(f'{x:.2f}' for x in lookup_ms)}")
        log(f"[sharded] {name}: {idx.n} keys over {mesh.size} slots "
            f"({sh.per} per shard, built in {t_build:.2f}s); {len(q_lo)} "
            f"queries ({int(hit.sum())} present, 1,001 absent incl. bit-63 "
            f"and all-ones keys) equal the host index's; ms per batch "
            f"(upload, search, read-back): "
            f"{', '.join(f'{x:.1f}' for x in ms)}")
    launches, per_slot, secs = _mesh_passes("sharded", sl, workdir, mesh,
                                            shard_index_min_keys=0)
    w = sl["warm"]
    log(f"[sharded] both passes with shard_index_min_keys=0: pass 1 "
        f"{secs[1]:.2f}s (one device, warm {w[1]:.2f}s), pass 2 "
        f"{secs[2]:.2f}s (one device, warm {w[2]:.2f}s); byte-identical to "
        f"the slice; kernel launches per slot {per_slot} ({launches} in all)")
    return launches


_DIST_RUNNER = r"""
import sys
from ratatosk_tpu_torch import distributed_correct
from ratatosk_tpu_torch.ops import beam_kernel, finish_kernel
pid, n, port = sys.argv[1], sys.argv[2], sys.argv[3]
argv = ["--coordinator", f"localhost:{port}", "--num-processes", n,
        "--process-id", pid, "--"] + sys.argv[4:]
assert distributed_correct.main(argv, device="cuda") == 0
print("launches", beam_kernel.fused_beam_search.launches,
      finish_kernel.finish_bundle_kernel.launches, flush=True)
"""


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_dist(sl: dict, workdir: str, short_fa: str, cli_out: str):
    """The multi-host launcher on the inputs of the CLI run that wrote
    `cli_out`, which its FASTQ must equal: one process per card with two or
    more cards (process i sees card i alone: CUDA_VISIBLE_DEVICES=i), else
    two processes on cuda:0."""
    import torch
    from ratatosk_tpu_torch.graph import io as GIO
    out = os.path.join(workdir, "dist")
    argv = ["-s", short_fa, "-l", sl["lr_path"], "-o", out, "-c", "2",
            "--devices", "1", "-v"]
    cards = torch.cuda.device_count()
    n = cards if cards >= 2 else 2
    how = (f"{n} processes, one card each (CUDA_VISIBLE_DEVICES=i)"
           if cards >= 2 else "2 processes on cuda:0")
    port = _free_port()
    procs, errs = [], []
    t = time.time()
    try:
        for pid in range(n):
            env = dict(os.environ, PYTHONPATH=str(ROOT))
            if cards >= 2:
                env["CUDA_VISIBLE_DEVICES"] = str(pid)
            trace = os.path.join(workdir, f"dist.trace{pid}.jsonl")
            errs.append(open(os.path.join(workdir, f"dist.err{pid}"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _DIST_RUNNER, str(pid), str(n),
                 str(port), *argv, "--trace-json", trace],
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
    per_proc = [dict(zip(PATH_KERNELS, map(
        int, o.strip().splitlines()[-1].split()[1:]))) for o in outs]
    for pid, c in enumerate(per_proc):
        _require_launches(f"dist process {pid}", c)
    if Path(out + ".fastq").read_bytes() != Path(cli_out + ".fastq") \
            .read_bytes():
        raise AssertionError("[dist] final FASTQ differs from the "
                             "single-process CLI run's")
    for k in (31, 63):
        if not os.path.getsize(GIO.index_path(out, k)):
            raise AssertionError(f"[dist] {GIO.index_path(out, k)} is empty")
    steps = []
    for pid in range(n):
        evs = _trace(os.path.join(workdir, f"dist.trace{pid}.jsonl"))
        passes = {e["pass_no"]: e["secs"] for e in evs
                  if e["ev"] == "pass_done"}
        snp = [e["secs"] for e in evs if e["ev"] == "snp"]
        steps.append(f"process {pid}: pass 1 {passes[1]:.1f}s, pass 2 "
                     f"{passes[2]:.1f}s, SNP detection "
                     f"{' / '.join(f'{x:.1f}' for x in snp)}s")
    log(f"[dist] {how} (gloo, localhost:{port}): "
        f"{wall:.1f}s wall; {'; '.join(steps)}; final FASTQ byte-identical "
        f"to the single-process CLI run's; index .npz k31/k63 written; kernel launches "
        f"{per_proc}")
    return {n: sum(c[n] for c in per_proc) for n in PATH_KERNELS}


def _write_short_fasta(sreads, path: str, half_path: str = os.devnull) -> None:
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


def cli_flags(devices=("--devices", "1")) -> list:
    """The `correct` command's flags in [cli] and [cli quarter] (with
    `devices`, the --devices flag or none), the port's default
    --batch-regions named, as the JAX CLI (default 64) must be given it;
    with --devices 1, [cli quarter]'s key among the JAX package's
    digests."""
    return ["-c", "2", *devices, "--batch-regions", "512"]


def phase_cli(sl: dict, workdir: str, short_fa: str, smi: str,
              name: str = "cli", devices=("--devices", "1")):
    """The user's `correct` command on the data of `sl` with
    cli_flags(devices); `name` tags its lines and names its files. Returns
    its launches, output prefix and flags."""
    import torch
    from ratatosk_tpu_torch import cli
    truth, n_reads = sl["truth"], len(sl["truth"])
    out = os.path.join(workdir, name.replace(" ", "_"))
    trace = out + ".trace.jsonl"
    flags = cli_flags(devices)
    _reset_launches()
    t = time.time()
    cli.main(["correct", "-s", short_fa, "-l", sl["lr_path"], "-o", out,
              *flags, "-v", "--trace-json", trace], device="cuda")
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = _launches()
    _require_launches(name, launches)
    evs = _trace(trace)
    snp = [e for e in evs if e["ev"] == "snp"]
    rescue = [e for e in evs if e["ev"] == "rescue"]
    passes = {e["pass_no"]: e for e in evs if e["ev"] == "pass_done"}
    mid = _sampled_error(truth, _check_reads(out + ".2.fastq", n_reads))
    cor = _sampled_error(truth, _check_reads(out + ".fastq", n_reads))
    raw = _raw_error(truth)
    dt = passes[1]["secs"] + passes[2]["secs"]
    steps = (sum(e["secs"] for e in snp + rescue) + dt)
    log(f"[{name}] correct {' '.join(flags)} (k 31/63, SNPs and edge "
        f"rescue on): {wall:.1f}s wall; edge rescue {rescue[0]['edges']} edges in "
        f"{rescue[0]['secs']:.1f}s; SNP detection "
        + ", ".join(f"pass {i + 1} {e['sites']} sites in {e['secs']:.1f}s"
                    for i, e in enumerate(snp))
        + f"; pass 1 {passes[1]['secs']:.1f}s, pass 2 {passes[2]['secs']:.1f}s"
        f"; index builds and I/O {wall - steps:.1f}s; {launches} kernel "
        f"launches")
    log(f"[{name}] {sl['bases']} bases through 2 passes in {dt:.1f}s: "
        f"{sl['bases'] / dt:.1f} corrected bases/s on {smi}; error on "
        f"{len(_sample(n_reads))} sampled reads: raw {raw:.4f}, pass 1 "
        f"{mid:.4f}, pass 2 {cor:.4f}")
    if not cor < raw / 5:
        raise AssertionError(f"[{name}] error {cor:.4f} is not below raw/5")
    return dict(launches=launches, out=out, flags=flags)


def phase_cli_default(sl: dict, workdir: str, short_fa: str, smi: str,
                      ref_out: str) -> dict:
    """[cli default]: the `correct` command on the data of `sl` without
    --devices, so on the CLI's default mesh over every visible card (one
    card: --devices 1's path). Both FASTQ files must equal those of the
    run that wrote `ref_out` ([cli quarter], --devices 1) byte for byte;
    on a mesh every card must launch both kernels and every slot of every
    launch run launch 2 with its launch's T."""
    import contextlib
    from ratatosk_tpu_torch.config import CorrectOpt
    from ratatosk_tpu_torch.pipeline import local_mesh
    mesh = local_mesh(CorrectOpt(), "cuda")
    with (LaunchSteps() if mesh is not None
          else contextlib.nullcontext()) as steps:
        res = phase_cli(sl, workdir, short_fa, smi, name="cli default",
                        devices=())
    for ext in (".2.fastq", ".fastq"):
        if Path(res["out"] + ext).read_bytes() != \
                Path(ref_out + ext).read_bytes():
            raise AssertionError(f"[cli default] {ext} differs from the "
                                 "--devices 1 run's")
    how = "no mesh: one card, --devices 1's path"
    if mesh is not None:
        Ts, below = steps.check("cli default")
        w = _wrappers()
        per_card = {n: list(w[n].launches_by_stream.values())
                    for n in PATH_KERNELS}
        if any(len(v) != mesh.size or min(v) <= 0
               for v in per_card.values()):
            raise AssertionError(f"[cli default] not every card of {mesh} "
                                 f"launched both kernels: {per_card}")
        how = (f"kernel launches per card {per_card}; {len(Ts)} launches, "
               f"each one's T read by every slot ({below} with a slot's own "
               "count below it)")
    log(f"[cli default] the CLI's default --devices 0 ran on "
        f"{mesh or 'cuda:0'} ({how}); both FASTQ files byte-identical to "
        "[cli quarter]'s (--devices 1)")
    return res


def phase_index(sl: dict, workdir: str, half_fa: str, cli_out: str):
    """`index -1` on half the short reads, the index's load and save, then
    `correct -g ... -1`."""
    import numpy as np
    import torch
    from ratatosk_tpu_torch import cli
    from ratatosk_tpu_torch.graph import interop as IT
    from ratatosk_tpu_torch.graph import io as GIO
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
    _reset_launches()
    t = time.time()
    cli.main(["correct", "-g", npz, "-l", sl["lr_path"], "-o", out, "-1",
              "-c", "2", "--devices", "1", "-v", "--trace-json", trace],
             device="cuda")
    torch.cuda.synchronize()
    t_g = time.time() - t
    launches = _launches()
    _require_launches("index -g", launches)
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
        "differ from the single-process CLI run's pass 1")
    if not cor < raw / 5:
        raise AssertionError(f"-g run error {cor:.4f} is not below raw/5")
    return dict(launches=launches)


def hold_to_jax(tag: str, rule: dict, flags: list, short_fa: str,
                long_fq: str, out: str) -> None:
    """Both FASTQ files of the `correct` run that wrote `out` must be the
    JAX package's on the same data (`rule`) and flags (the entry of
    ratatosk_tpu_torch/data/jax_digests.json that has them); its inputs are
    checked first. Where no entry has them, says so."""
    from ratatosk_tpu_torch import digests
    fastq = {"pass1": digests.file_sha256(out + ".2.fastq"),
             "final": digests.file_sha256(out + ".fastq")}
    name = digests.check("cli", rule, flags, lambda: {
        "short.fa": digests.file_sha256(short_fa),
        "long.fq": digests.file_sha256(long_fq)}, fastq)
    if name is None:
        log(f"[{tag}] no JAX package digests for this data and these flags "
            f"({rule['genome_bp']} bp, {rule['n_long_reads']} reads; "
            f"{' '.join(flags)})")
        return
    log(f"[{tag}] pass 1 and final FASTQ equal the JAX package's "
        f"(jax_digests.json {name}: {fastq['pass1'][:12]}..., "
        f"{fastq['final'][:12]}...)")


def quarter_rule(glen: int, n_reads: int) -> dict:
    """The data rule of quarter_data(workdir, glen, n_reads): its key among
    the JAX package's digests."""
    return dict(generator="chip_smoke.quarter_data", seed=SEED + 3,
                genome_bp=glen // 4, n_long_reads=max(n_reads // 4, 16),
                repeat_frac=0.15, repeat_len=250, read_len=4000,
                raw_err=0.10)


def quarter_data(workdir: str, glen: int, n_reads: int) -> dict:
    """A dataset of the slice's shape (repeats, 40x short reads, 4 kbp long
    reads at 10% error) on a quarter of its genome and long reads."""
    import numpy as np
    from ratatosk_tpu_torch import testing
    t = time.time()
    rule = quarter_rule(glen, n_reads)
    rng = np.random.default_rng(rule["seed"])
    genome = testing.random_genome(rng, rule["genome_bp"],
                                   repeat_frac=rule["repeat_frac"],
                                   repeat_len=rule["repeat_len"])
    sreads = testing.short_reads(rng, genome, coverage=40.0)
    lr_path = os.path.join(workdir, "quarter.long.fq")
    truth, total = _write_long_reads(rng, genome, rule["n_long_reads"],
                                     rule["read_len"], lr_path)
    log(f"[cli quarter] simulated genome {glen // 4} bp, {len(sreads)} "
        f"short reads, {len(truth)} long reads ({total} bp) in "
        f"{time.time() - t:.1f}s")
    return dict(truth=truth, lr_path=lr_path, sreads=sreads, bases=total)


BENCH_ARGS = ("1e6", "64", "--repeats", "2")


def phase_bench(smi: str) -> dict:
    """bench_torch.py at 1 Mbp and 64 long reads, two runs in one process,
    with each planner, as its own process on cuda:0: each must exit 0 with
    a JSON last line, launch the kernels of its path in both passes, and
    write the same FASTQ bytes as the other. Returns the launches of each
    run's median run, by path (bench_host, bench_device)."""
    out, launches = {}, {}
    for plan in ("host", "device"):
        t = time.time()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "bench_torch.py"), *BENCH_ARGS,
             "--plan", plan], cwd=ROOT, capture_output=True, text=True,
            timeout=600)
        wall = time.time() - t
        if proc.returncode != 0:
            raise AssertionError(f"[bench] --plan {plan} exited "
                                 f"{proc.returncode}:\n{proc.stderr[-4000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        if res["jax_entry"] != "bench_smoke" or res["jax_match"] is not True:
            raise AssertionError(
                f"[bench] --plan {plan}: not held to the JAX package's "
                f"bench_smoke digests: jax_entry {res['jax_entry']}, "
                f"jax_match {res['jax_match']}")
        need = PATH_KERNELS + (PLAN_KERNELS if plan == "device" else ())
        counts = {n: 0 for n in need}
        for p in ("pass1", "pass2"):
            got = res["passes"][p]["launches"]
            _require_launches(f"bench {plan} {p}",
                              {n: got[n] for n in need})
            for n in need:
                counts[n] += got[n]
        launches[f"bench_{plan}"] = counts
        out[plan] = res
        p1, p2 = res["passes"]["pass1"], res["passes"]["pass2"]
        log(f"[bench] bench_torch.py {' '.join(BENCH_ARGS)} --plan {plan}: "
            f"{wall:.1f}s; runs " + ", ".join(
                f"{b:.1f}" for b in res["runs_bases_per_s"])
            + f" bases/s (median {res['value']:.1f}) on {smi}; passes "
            f"{res['pass1_s']:.2f} / {res['pass2_s']:.2f}s, warm-up "
            f"{res['warmup_s']['pass1']:.1f} / {res['warmup_s']['pass2']:.1f}s"
            f"; n_fallback {p1['n_fallback']} / {p2['n_fallback']}; "
            f"error raw {res['error']['raw']:.4f}, pass 2 "
            f"{res['error']['pass2']:.4f}; launches {counts}; FASTQ equal "
            "to the JAX package's (jax_digests.json bench_smoke)")
    if out["host"]["fastq_sha256"] != out["device"]["fastq_sha256"]:
        raise AssertionError("[bench] the two planners' FASTQ differ: "
                             f"{out['host']['fastq_sha256']} / "
                             f"{out['device']['fastq_sha256']}")
    return launches


def phase_quarter(workdir: str, smi: str, launches: dict, glen: int,
                  n_reads: int, index: bool) -> None:
    """On a quarter of the slice's genome and long reads: [cli quarter]
    (--devices 1), which [cli default], [index] (when `index`) and [dist]
    are held to: their host steps, index builds above all, scale with the
    genome, and with [cli], [index] and [dist] on the slice's data the
    script took 981.4 s of its 1,200 (NVIDIA H100 80GB HBM3). Adds their
    launches."""
    q = quarter_data(workdir, glen, n_reads)
    q_fa = os.path.join(workdir, "quarter.short.fa")
    half_fa = os.path.join(workdir, "quarter.short.half.fa")
    _write_short_fasta(q.pop("sreads"), q_fa, half_fa)
    rule = quarter_rule(glen, n_reads)
    qc = phase_cli(q, workdir, q_fa, smi, name="cli quarter")
    hold_to_jax("cli quarter", rule, qc["flags"], q_fa, q["lr_path"],
                qc["out"])
    launches["cli_quarter"] = qc["launches"]
    qd = phase_cli_default(q, workdir, q_fa, smi, qc["out"])
    # the CLI's default mesh must write [cli quarter]'s (--devices 1) bytes
    hold_to_jax("cli default", rule, qc["flags"], q_fa, q["lr_path"],
                qd["out"])
    launches["cli_default"] = qd["launches"]
    if index:
        launches["index_g"] = phase_index(q, workdir, half_fa,
                                          qc["out"])["launches"]
    launches["dist"] = phase_dist(q, workdir, q_fa, qc["out"])


def phase_rest(sl: dict, workdir: str, smi: str, launches: dict,
               glen: int, n_reads: int) -> None:
    """[cli] on the slice's data, phase_quarter, then [bench]. Adds their
    launches."""
    short_fa = os.path.join(workdir, "short.fa")
    t = time.time()
    _write_short_fasta(sl.pop("sreads"), short_fa)
    log(f"[cli] wrote {os.path.getsize(short_fa)} bytes of short-read "
        f"FASTA in {time.time() - t:.1f}s")
    sl.pop("corr1"), sl.pop("corr2")
    launches["cli"] = phase_cli(sl, workdir, short_fa, smi)["launches"]
    phase_quarter(workdir, smi, launches, glen, n_reads, index=True)
    launches.update(phase_bench(smi))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome-bp", type=int, default=4_000_000)
    ap.add_argument("--long-reads", type=int, default=256)
    ap.add_argument("--mesh-only", action="store_true",
                    help="run the kernels, the slice, [warm], [mesh], "
                    "[sharded], [cli quarter], [cli default] and [dist] only "
                    "(on several cards: one slot, one process per card)")
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
    # launches by kernel, then by path
    launches = {n: {} for n in KERNELS}

    def add(path, counts):
        for n, c in counts.items():
            launches[n][path] = c

    align_launches, arows = phase_align(torch, dev)
    add("align", align_launches)

    with tempfile.TemporaryDirectory(prefix="ratatosk_smoke_") as workdir:
        sl = run_slice(dev, args.genome_bp, args.long_reads, workdir, smi)
        add("slice", sl["launches"])
        frows, batches = phase_fused_kernels(torch, sl, dev)
        phase_wide(torch, batches, dev)
        del batches
        add("warm", phase_warm(sl, workdir, dev, smi))
        if not args.mesh_only:
            head, host_fastq, steps, krows["engine NT=256"] = \
                phase_plain_vs_kernel(dev, sl, workdir)
            add("plain_steps", {"sprint_rows": steps})
            add("wide_steps", {"sprint_rows": phase_wide_steps(
                dev, sl, workdir, head)})
            phase_trace(sl, workdir)
            dp_launches, prows = phase_devplan(dev, sl, workdir, head,
                                               host_fastq)
            add("devplan", dp_launches)
        mesh, how = make_slots(torch)
        for path, counts in phase_mesh(sl, workdir, mesh, how).items():
            add(path, counts)
        add("sharded", phase_sharded(sl, workdir, mesh))
        rest = {}
        if args.mesh_only:
            phase_quarter(workdir, smi, rest, args.genome_bp,
                          args.long_reads, index=False)
        else:
            phase_rest(sl, workdir, smi, rest, args.genome_bp,
                       args.long_reads)
        for path, counts in rest.items():
            add(path, counts)
    torch.cuda.synchronize()
    log(f"[done] {time.time() - t_all:.1f}s on {smi}")

    def record(name, source, replaces, rows, headline):
        h = rows[headline]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(launches[name].values()),
                "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
                "ms": h["ms"], "plain_ms": h["plain_ms"],
                "bound_ms": h["bound_ms"], "bound_by": h["bound_by"],
                "library_ms": None, "headline": headline,
                "launches_by_path": launches[name],
                "by_shape": {str(k): r for k, r in rows.items()}}

    # the headline shape of each kernel: the main path's exact bucket
    # (NT=256, beam W=257); the sprint kernel runs only on the "steps"
    # route now ([plain]), its launches counted there
    print(json.dumps({"kernels": [
        record("fused_beam_search", "ratatosk_tpu_torch/csrc/beam.cu",
               "ratatosk_tpu/ops/sprint_pallas.py:58",
               frows["fused_beam_search"], 256),
        record("finish_bundle_kernel", "ratatosk_tpu_torch/csrc/finish.cu",
               "ratatosk_tpu/correct/finish.py:153",
               frows["finish_bundle_kernel"], 256),
        record("sprint_rows", "ratatosk_tpu_torch/csrc/sprint.cu",
               "ratatosk_tpu/ops/sprint_pallas.py:58", krows, 257),
        # the JAX package's plain edit distance (no Pallas kernel);
        # headline: the engine's widest bucket shape
        record("edit_distance_kernel", "ratatosk_tpu_torch/csrc/align.cu",
               "ratatosk_tpu/ops/align.py:68", arows, "128x5376x5376 SHW"),
    ] + ([] if args.mesh_only else [
        # the device planner's dispatches (plain JAX in the reference, no
        # Pallas kernel); headline: the k=31 graph's first read batch
        record(name, "ratatosk_tpu_torch/csrc/plan.cu",
               f"ratatosk_tpu/ops/plan_device.py:{line}", prows[name], "k31")
        for name, line in (("runs_kernel", 91), ("probe_kernel", 197))])}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
