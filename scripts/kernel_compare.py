#!/usr/bin/env python3
"""Time versions of the fused beam kernel, the finish kernel, the device
planner's two kernels or the sprint kernel on one card, on the same
launches.

    python3 scripts/kernel_compare.py
        [--kernel beam|finish|runs|probe|plan|sprint]
        [--split [NAME,...]] [--genome-bp N] [--long-reads N]
        [--order old,new,new,old]
        NAME=DIR [NAME=DIR ...]

Each DIR is a tree that holds the kernel's source and wrapper
(`ratatosk_tpu_torch/csrc/beam.cu` and `ops/beam_kernel.py`, or
`csrc/finish.cu` and `ops/finish_kernel.py`): a checkout of another commit,
or only those two files; the name `this` stands for this checkout. Every
other tree's source is built alone with the package's nvcc flags into
`DIR/ratatosk_tpu_torch/build/`, and its own wrapper module's `enqueue`
drives it.

The launches are chip_smoke.py's `[kernel]` batches: the slice's reads run
through both passes, then one engine-formed launch per bucket (NT 256 /
2048 / 5376, beam 16). Per bucket and tree, in the order given (so that two
versions alternate on one card): the result against the plain version
(bit-identical or it raises), then the mean of timed calls after a warm-up.
The beam kernel: 5 calls, CUDA events around each of its two launches, ms
per step (the call's time over the launch's T). The finish kernel: 10
calls, us per row of the longest region (the call's time over its rows,
max(tgt_len, best_end) + 1). A library that exports `beam_clock_read` or
`finish_clock_read` (an instrumented copy) also gets its SM cycles by part,
per region-step or per row.

The planner's kernels (`--kernel runs`, `probe`, or `plan` for both): each
tree's `csrc/plan.cu` is built alone and driven through its own
`ops/plan_kernel.py` (a tree whose probe takes a start per position,
`sstart`, gets one; a tree that takes the span starts gets those). The
batches are chip_smoke.py's `[devplan]` batches (`plan_batches`): per graph
(k=31, k=63) the first ~1 Mbp read batch and its first 16 reads, padded to
the planner's tier (L = 2^21). Per batch and tree, in the order given: the
result against the plain version (tensor for tensor; `of` and stats[0:3]
on a batch whose caps overflow), then the mean of 10 calls, each behind a
device sleep. With `--split` every tree's launcher (or the named trees'
only: a tree may be given twice, under two names) is built from an
instrumented copy (written beside its library under `build/`) that records
a CUDA event after each of its kernel launches: each call's time is then
also printed per CUDA kernel, with the number of kernels a call runs.

The sprint kernel (`--kernel sprint`): each tree's `csrc/sprint.cu` is
built alone and driven through its own `ops/sprint.py`. The launches are
chip_smoke.py's `[kernel]` sprint launches (`sprint_cases`: random band
state at B=16, smax=8, W 257 / 192 / 336 / 1,024, R=512 and 128; at R=512
each also with no entry advancing, a copy, and with every entry advancing
smax-1 substeps; a width that a tree refuses is skipped for it), then the
first launch at W=257 of a pass 1 through impl="steps" on the slice's
first 16 reads, as the engine formed it. Per launch and tree, in the order given: the result
against sprint_rows_ref (tensor for tensor), then the mean of 10 calls,
each behind a device sleep, beside the launch's bound and the time of a
clone() of its rows (and, once, the floor of such a time: a one-element
add_ timed alike). With `--split` (all trees, or the named ones) a tree's
source is built with SPRINT_CLOCKS defined: a source that reads clock64()
under that flag then also gives its SM cycles by phase (window and btgt,
row load, substeps, row store; summed over its warps) and per entry.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the parts of an instrumented copy's counters, by kernel and their number:
# the block-per-region and the warp-per-region beam kernel's, the finish
# kernels'
PARTS = {("beam", 8): ("bookkeeping", "sprint", "cand_stats",
                       "scoreboard_rank", "color", "row_rebuild",
                       "window_shift", "load_save_pick_walk"),
         ("beam", 10): ("classify_keeps", "record_bases_row", "sprint",
                        "cand_stats", "cand_write", "scoreboard_rank",
                        "color", "new_entries", "row_rebuild",
                        "load_save_pick_walk"),
         ("finish", 7): ("setup", "mask_load", "row_update",
                         "prefix_min_scan", "dmin_reduce",
                         "better_endcol", "gates_packing"),
         ("finish", 6): ("setup", "match_words", "row_update", "row_min",
                         "snapshots", "endcols_gates_packing")}
SOURCES = {"beam": ("beam.cu", "beam_kernel", "beam_search_launch"),
           "finish": ("finish.cu", "finish_kernel", "finish_bundle_launch"),
           "sprint": ("sprint.cu", "sprint", "sprint_rows_launch")}
# the phases of csrc/sprint.cu's clock64 counters (kClkParts), then entries
SPRINT_PHASES = ("window_btgt", "row_load", "substeps", "row_store")
PLAN_KINDS = {"runs": ("runs_kernel",), "probe": ("probe_kernel",),
              "plan": ("runs_kernel", "probe_kernel")}
PLAN_ENTRIES = ("plan_runs_launch", "plan_probe_launch")
# the tile passes' phases whose SM cycles a --split copy counts
# (csrc/plan.cu: kClkPhases, PHASE)
CLOCK_PHASES = 10
CLOCK_NAMES = {"probe_kernel": ("extent", "bases", "exact", "allowed",
                                "half_tests", "qual_lookback", "listing",
                                "variants", "survivors", "seeds_out"),
               "runs_kernel": ("extent", "bases", "records", "runs_out")}
# what --split adds to a copy of csrc/plan.cu: an event recorded at the
# start of each launcher (after its `cudaStream_t st` line) and after each
# kernel launch, with the launched kernel's name
SPLIT_PRELUDE = r"""
static cudaEvent_t split_ev[33];
static const char* split_nm[32];
static int split_n = -1;
static void split_start(cudaStream_t st) {
  static bool made = false;
  if (!made) {
    for (int i = 0; i < 33; ++i) cudaEventCreate(&split_ev[i]);
    made = true;
  }
  split_n = 0;
  cudaEventRecord(split_ev[0], st);
}
static void split_mark(cudaStream_t st, const char* name) {
  if (split_n < 0 || split_n >= 32) return;
  split_nm[split_n] = name;
  cudaEventRecord(split_ev[++split_n], st);
}
// ms of each kernel of the last launcher call (waits for it); their count
extern "C" int plan_split_read(float* ms, int cap) {
  const int n = split_n;
  if (n <= 0) return 0;
  cudaEventSynchronize(split_ev[n]);
  for (int i = 0; i < n && i < cap; ++i)
    cudaEventElapsedTime(&ms[i], split_ev[i], split_ev[i + 1]);
  split_n = -1;
  return n;
}
extern "C" const char* plan_split_name(int i) { return split_nm[i]; }
"""


def load_tree(kind: str, name: str, tree: Path):
    """(library, wrapper module) of one tree's `kind` kernel."""
    from ratatosk_tpu_torch.ops import beam_kernel, cuda_lib, finish_kernel
    if name == "this":
        return cuda_lib.library(), (beam_kernel if kind == "beam"
                                    else finish_kernel)
    cu, module, entry = SOURCES[kind]
    src = tree / "ratatosk_tpu_torch" / "csrc" / cu
    h = hashlib.sha256(src.read_bytes() + " ".join(cuda_lib.NVCC_FLAGS)
                       .encode()).hexdigest()[:16]
    out = tree / "ratatosk_tpu_torch" / "build" / f"lib{kind}_{h}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-o",
                               str(out), str(src)], capture_output=True,
                              text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    res, args = cuda_lib.SIGNATURES[entry]
    fn = getattr(lib, entry)
    fn.restype, fn.argtypes = res, args
    spec = importlib.util.spec_from_file_location(
        f"{module}_{name}", tree / "ratatosk_tpu_torch" / "ops" /
        f"{module}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return lib, mod


def instrument_plan(text: str) -> str:
    """A copy of csrc/plan.cu whose launchers record a CUDA event at their
    start and after each kernel launch (SPLIT_PRELUDE)."""
    eol = text.index("\n", text.rindex("#include")) + 1
    text = "#define PLAN_CLOCKS 1\n" + text[:eol] + SPLIT_PRELUDE + text[eol:]
    text, n_start = re.subn(r"cudaStream_t st = \(cudaStream_t\)stream;",
                            r"\g<0> split_start(st);", text)
    text, n_mark = re.subn(r"(\w+)<<<[^;]*;",
                           lambda m: f'{m.group(0)} split_mark(st, '
                           f'"{m.group(1)}");', text)
    if n_start != len(PLAN_ENTRIES) or n_mark == 0:
        raise RuntimeError(f"plan.cu: found {n_start} launchers and {n_mark} "
                           "launches to instrument")
    return text


def ptxas_report(text: str) -> str:
    """Each kernel's registers and spill stores from nvcc -Xptxas -v."""
    out = []
    for block in text.split("Compiling entry function")[1:]:
        # a name, with the int of a one-int template (sprint_rows_kernel<C>)
        fn = re.search(r"\d+([a-z_]+)(?:ILi(\d+)E)?E", block)
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        out.append(f"{fn.group(1) if fn else '?'}"
                   f"{f'<{fn.group(2)}>' if fn and fn.group(2) else ''} "
                   f"{regs.group(1) if regs else '?'} registers "
                   f"{spill.group(1) if spill else '?'} B spilled")
    return "; ".join(out)


class _LibOf:
    """ops/cuda_lib as a tree's wrapper module sees it, with that tree's
    library in place of this checkout's."""

    def __init__(self, lib):
        self._lib = lib

    def library(self):
        return self._lib

    def __getattr__(self, name):
        from ratatosk_tpu_torch.ops import cuda_lib
        return getattr(cuda_lib, name)


def load_plan_tree(name: str, tree: Path, split: bool):
    """(library, wrapper module) of one tree's planner kernels: its
    csrc/plan.cu built alone (instrumented with --split) and its own
    ops/plan_kernel.py bound to that library."""
    from ratatosk_tpu_torch.ops import cuda_lib
    text = (tree / "ratatosk_tpu_torch" / "csrc" / "plan.cu").read_text()
    if split:
        text = instrument_plan(text)
    h = hashlib.sha256((text + " ".join(cuda_lib.NVCC_FLAGS))
                       .encode()).hexdigest()[:16]
    build = tree / "ratatosk_tpu_torch" / "build"
    out = build / f"libplan_{h}.so"
    if not out.exists():
        build.mkdir(parents=True, exist_ok=True)
        src = build / f"plan_{h}.cu"
        src.write_text(text)
        proc = subprocess.run([cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-o",
                               str(out), str(src)], capture_output=True,
                              text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
        print(f"{name}: ptxas " + ptxas_report(proc.stdout + proc.stderr),
              flush=True)
    lib = ctypes.CDLL(str(out))
    for entry in PLAN_ENTRIES:
        res, args = cuda_lib.SIGNATURES[entry]
        fn = getattr(lib, entry)
        fn.restype, fn.argtypes = res, args
    if split:
        lib.plan_split_read.restype = ctypes.c_int
        lib.plan_split_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.plan_split_name.restype = ctypes.c_char_p
        lib.plan_split_name.argtypes = [ctypes.c_int]
        if hasattr(lib, "plan_clock_read"):
            lib.plan_clock_read.restype = ctypes.c_int
            lib.plan_clock_read.argtypes = [ctypes.c_void_p]
    spec = importlib.util.spec_from_file_location(
        f"plan_kernel_{name}", tree / "ratatosk_tpu_torch" / "ops" /
        "plan_kernel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.cuda_lib = _LibOf(lib)
    return lib, mod


def plan_calls(torch, dp, reads, spans, stride: int):
    """(kernel name -> (call(module), plain result), the probe's stride
    options): the runs and the probe of one batch, called through a tree's
    wrapper module, and their plain versions' results."""
    import numpy as np
    from ratatosk_tpu_torch.correct.engine import _NEAR_EXACT_SKIP
    from ratatosk_tpu_torch.ops import plan_device as PD
    dev = dp.device
    rcodes, _, rcap = dp.runs_inputs(reads)
    rcodes = torch.from_numpy(rcodes).to(dev)
    got = dp.probe_inputs(reads, spans)
    codes = torch.from_numpy(got[0]).to(dev)
    L = len(codes)
    starts = torch.from_numpy(np.asarray(got[-1], np.int64)).to(dev)
    sstart = PD.span_sstart(starts, L)
    opts = dp.probe_options(L, stride=stride, near_exact_skip=_NEAR_EXACT_SKIP)

    def probe(mod):
        span_arg = sstart if "sstart" in mod.PROBE_PTRS else starts
        return mod.probe_kernel(codes, span_arg, dp.hx, dp.pf_tbl,
                                dp.hf_tbl, **opts)

    return {"runs_kernel": (
        lambda mod: mod.runs_kernel(rcodes, dp.hx, dp.nk_dev, k=dp.k,
                                    rcap=rcap),
        PD._runs_kernel(rcodes, dp.hx, dp.nk_dev, k=dp.k, rcap=rcap)),
        "probe_kernel": (probe, PD._probe_kernel(
            codes, sstart, dp.hx, dp.pf_tbl, dp.hf_tbl, **opts))}


def run_plan(torch, lib, mod, call, want, name: str, reps=10):
    """(ms, [(kernel, ms)] or None) of one tree's planner kernel on one
    batch; raises unless it equals the plain version (on an overflowing
    probe batch: `of` and stats[0:3])."""
    got = call(mod)
    torch.cuda.synchronize()
    pairs = list(zip(got, want))
    if name == "probe_kernel" and bool(want[5]):
        pairs = [(got[5], want[5]), (got[6][:3], want[6][:3])]
    if not all(g.dtype == w.dtype and torch.equal(g, w) for g, w in pairs):
        raise AssertionError(f"{mod.__name__}.{name} differs from its plain "
                             "version")
    split = getattr(lib, "plan_split_read", None)
    clk = getattr(lib, "plan_clock_read", None)
    cycles = (ctypes.c_ulonglong * (2 * CLOCK_PHASES))()
    if clk is not None and clk(cycles):
        raise RuntimeError("plan_clock_read failed")
    buf = (ctypes.c_float * 32)()
    ms, parts = 0.0, None
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        call(mod)
        b.record()
        torch.cuda.synchronize()
        ms += a.elapsed_time(b) / reps
        if split is not None:
            n = split(buf, 32)
            names = [lib.plan_split_name(i).decode() for i in range(n)]
            if parts is None:
                parts = [[nm, 0.0] for nm in names]
            for p, v in zip(parts, buf[:n]):
                p[1] += v / reps
    if clk is not None:
        if clk(cycles):
            raise RuntimeError("plan_clock_read failed")
        k = 1 if name == "runs_kernel" else 0
        cyc = cycles[k * CLOCK_PHASES:(k + 1) * CLOCK_PHASES]
        tot = max(sum(cyc), 1)
        parts.append(["; SM cycles by phase (share)", ", ".join(
            f"{ph} {100 * c / tot:.1f}%" for ph, c in
            zip(CLOCK_NAMES[name], cyc) if c)])
    return ms, parts


def random_read_rate(torch, dev, reps: int = 5) -> str:
    """The card's rate of random 32-byte sectors: torch.take of 2^24 random
    4-byte entries of a 2 GiB table (each read its own sector, with 12
    bytes of index and output streamed beside it), the planner kernels'
    yardstick."""
    tbl = torch.zeros(1 << 29, dtype=torch.int32, device=dev)
    idx = torch.randint(0, 1 << 29, (1 << 24,), device=dev)
    torch.take(tbl, idx)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        torch.take(tbl, idx)
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / reps
    rate = (1 << 24) / ms * 1e3
    del tbl, idx
    return (f"random reads: 2^24 from 2 GiB in {ms:.4f} ms, {rate / 1e9:.3f}G "
            f"sectors/s ({rate * 32 / 1e12:.3f} TB/s at 32 B, "
            f"{rate * 64 / 1e12:.3f} TB/s at 64 B a read)")


def plan_sizes(CS, sl, dev):
    """[devplan]'s batches (CS.plan_batches) and the first 16 reads of
    each: (graph, size, planner, reads, the spans the host planner would
    probe)."""
    from ratatosk_tpu_torch.correct.seeds import find_runs
    for graph, corr, dp, batch, _ in CS.plan_batches(sl, dev):
        runs = [find_runs(corr.cdbg, r) for r in batch]
        spans = CS._probe_spans(corr.cdbg, corr.colors, runs, batch,
                                sl["o1"].weak_seed_min_gap)
        for size, n in (("batch", len(batch)), ("16 reads", 16)):
            yield graph, size, dp, batch[:n], [s for s in spans if s[0] < n]


def main_plan(torch, CS, args, trees, order, dev, smi) -> int:
    """--kernel runs|probe|plan: the planner's kernels of each tree on
    [devplan]'s batches, in turns."""
    names = PLAN_KINDS[args.kernel]
    split = (set() if args.split is None else
             set(trees) if args.split == "" else set(args.split.split(",")))
    print(random_read_rate(torch, dev), flush=True)
    libs = {n: load_plan_tree(n, Path(d).resolve(), n in split)
            for n, d in trees.items()}
    with tempfile.TemporaryDirectory(prefix="kernel_compare_") as workdir:
        sl = CS.run_slice(dev, args.genome_bp, args.long_reads, workdir, smi)
        for graph, size, dp, reads, spans in plan_sizes(CS, sl, dev):
            calls = plan_calls(torch, dp, reads, spans,
                               sl["o1"].weak_seed_stride)
            for kname in names:
                call, want = calls[kname]
                extra = (f"{int(want[-1])} runs" if kname == "runs_kernel"
                         else f"stats {want[6].tolist()}, of "
                         f"{bool(want[5])}")
                print(f"{kname} {graph} {size}: {len(reads)} reads / "
                      f"{sum(map(len, reads))} bp, {len(spans)} spans; "
                      f"{extra}", flush=True)
                for tname in order:
                    lib, mod = libs[tname]
                    ms, parts = run_plan(torch, lib, mod, call, want, kname)
                    line = f"  {tname}: {ms:.4f} ms; equal to the plain version"
                    if parts is not None:
                        kern = [p for p in parts if isinstance(p[1], float)]
                        line += (f"; {len(kern)} CUDA kernels: " + ", ".join(
                            f"{p} {v:.4f}" for p, v in kern))
                        line += "".join(f"{p} {v}" for p, v in parts
                                        if not isinstance(v, float))
                    print(line, flush=True)
    print(smi, flush=True)
    return 0


def clocks(kind: str, lib):
    """An instrumented copy's counters, zeroed after the read; None for a
    library without them. Beam: [2][P] cycles by launch and part, then [2]
    steps (P = beam_clock_parts(), else 8). Finish: [P] cycles by part,
    then the rows walked and the most rows of one region."""
    read = getattr(lib, f"{kind}_clock_read", None)
    if read is None:
        return None
    parts = getattr(lib, f"{kind}_clock_parts", None)
    n = parts() if parts is not None else 8
    size = 2 * n + 2 if kind == "beam" else n + 2
    buf = (ctypes.c_ulonglong * size)()
    if read(buf):
        raise RuntimeError(f"{kind}_clock_read failed")
    return list(buf)


def _marks(torch, stream):
    """A 1 ms device sleep, then an event; returns (events, add-one)."""
    torch.cuda._sleep(2_000_000)
    marks = [torch.cuda.Event(enable_timing=True)]
    marks[0].record(stream)

    def mark():
        marks.append(torch.cuda.Event(enable_timing=True))
        marks[-1].record(stream)
    return marks, mark


def run_beam(torch, lib, mod, b, want, reps=5):
    """(phase-1 ms, phase-2 ms, cycle split or None) of one tree's beam
    kernel on one launch; raises unless its result equals the plain
    version's. A device sleep first keeps the host's enqueue out of launch
    1's time."""
    from ratatosk_tpu_torch.correct import beam as BM
    from ratatosk_tpu_torch.ops import cuda_lib
    g, rb = b["g"], b["rb"]
    dev = rb.tgt_masks.device
    stream = torch.cuda.current_stream(dev)

    def call():
        marks, mark = _marks(torch, stream)
        res = mod.enqueue(lib, g, rb, beam=b["beam"], W=b["W"],
                          lmax=b["lmax"], min_cov=b["min_cov"], sprint=8,
                          index=cuda_lib.device_index(dev),
                          stream=stream.cuda_stream, counted=mark)
        return res, marks

    clocks("beam", lib)
    got, _ = call()
    torch.cuda.synchronize()
    split = clocks("beam", lib)
    for f in BM.FIELDS:
        if not torch.equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"{mod.__name__} differs from the plain "
                                 f"version in {f}")
    p1 = p2 = 0.0
    for _ in range(reps):
        _, m = call()
        torch.cuda.synchronize()
        p1 += m[0].elapsed_time(m[1]) / reps
        p2 += m[1].elapsed_time(m[2]) / reps
    return p1, p2, split


def run_finish(torch, lib, mod, b, res, want, reps=10):
    """(ms, cycle split or None) of one tree's finish kernel on one launch;
    raises unless its result equals finish_bundle's."""
    from ratatosk_tpu_torch.ops import cuda_lib
    rb = b["rb"]
    dev = rb.tgt_masks.device
    stream = torch.cuda.current_stream(dev)
    arrays = dict(tgt_masks=rb.tgt_masks, tgt_len=rb.tgt_len,
                  tgt_qual=rb.tgt_qual, best_seq=res.best_seq,
                  best_len=res.best_len, best_dist=res.best_dist,
                  best_end=res.best_end, second_dist=res.second_dist,
                  completed=res.completed)

    def call():
        marks, mark = _marks(torch, stream)
        out = mod.enqueue(lib, arrays, qv_max=b["qv_max"], min_k=b["k"],
                          w=b["band"], min_score_open=b["mso"],
                          index=cuda_lib.device_index(dev),
                          stream=stream.cuda_stream, counted=mark)
        return out, marks

    clocks("finish", lib)
    got, _ = call()
    torch.cuda.synchronize()
    split = clocks("finish", lib)
    if not (torch.equal(got.scalars, want.scalars)
            and torch.equal(got.seq_packed, want.seq_packed)):
        raise AssertionError(f"{mod.__name__} differs from finish_bundle")
    ms = 0.0
    for _ in range(reps):
        _, m = call()
        torch.cuda.synchronize()
        ms += m[0].elapsed_time(m[1]) / reps
    return ms, split


def load_sprint_tree(name: str, tree: Path, clocks_on: bool):
    """(library, wrapper module) of one tree's sprint kernel: its
    csrc/sprint.cu built alone (with SPRINT_CLOCKS defined when clocks_on)
    and its own ops/sprint.py bound to that library."""
    from ratatosk_tpu_torch.ops import cuda_lib
    text = (tree / "ratatosk_tpu_torch" / "csrc" / "sprint.cu").read_text()
    if clocks_on:
        text = "#define SPRINT_CLOCKS 1\n" + text
    h = hashlib.sha256((text + " ".join(cuda_lib.NVCC_FLAGS))
                       .encode()).hexdigest()[:16]
    build = tree / "ratatosk_tpu_torch" / "build"
    out = build / f"libsprint_{h}.so"
    if not out.exists():
        build.mkdir(parents=True, exist_ok=True)
        src = build / f"sprint_{h}.cu"
        src.write_text(text)
        proc = subprocess.run([cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-o",
                               str(out), str(src)], capture_output=True,
                              text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
        print(f"{name}: ptxas " + ptxas_report(proc.stdout + proc.stderr),
              flush=True)
    lib = ctypes.CDLL(str(out))
    for entry in ("sprint_rows_launch", "sprint_rows_max_width"):
        res, args = cuda_lib.SIGNATURES[entry]
        fn = getattr(lib, entry)
        fn.restype, fn.argtypes = res, args
    if hasattr(lib, "sprint_clock_read"):
        lib.sprint_clock_read.restype = ctypes.c_int
        lib.sprint_clock_read.argtypes = [ctypes.c_void_p]
    spec = importlib.util.spec_from_file_location(
        f"sprint_{name}", tree / "ratatosk_tpu_torch" / "ops" / "sprint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.cuda_lib = _LibOf(lib)
    if lib.sprint_rows_max_width() != mod.MAX_WIDTH:
        raise RuntimeError(f"{name}: sprint_rows_max_width() "
                           f"{lib.sprint_rows_max_width()}, MAX_WIDTH "
                           f"{mod.MAX_WIDTH}")
    return lib, mod


def run_sprint(torch, CS, lib, mod, arrs, want, smax: int):
    """(ms, SM cycles by phase and entries, or None) of one tree's sprint
    kernel on one launch (chip_smoke._call_ms, 10 calls); raises unless it
    equals sprint_rows_ref."""
    got = mod.sprint_rows(*arrs, smax=smax)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{mod.__name__}.sprint_rows differs from "
                             "sprint_rows_ref")
    clk = getattr(lib, "sprint_clock_read", None)
    cycles = (ctypes.c_ulonglong * (len(SPRINT_PHASES) + 1))()
    if clk is not None and clk(cycles):
        raise RuntimeError("sprint_clock_read failed")
    ms = CS._call_ms(torch, lambda: mod.sprint_rows(*arrs, smax=smax),
                     reps=10)
    if clk is None:
        return ms, None
    if clk(cycles):
        raise RuntimeError("sprint_clock_read failed")
    return ms, list(cycles)


def main_sprint(torch, CS, args, trees, order, dev, smi) -> int:
    """--kernel sprint: each tree's sprint kernel on [kernel]'s random
    launches and on one engine-formed launch, in turns."""
    from ratatosk_tpu_torch.ops import sprint as SP
    split = (set() if args.split is None else
             set(trees) if args.split == "" else set(args.split.split(",")))
    libs = {n: load_sprint_tree(n, Path(d).resolve(), n in split)
            for n, d in trees.items()}
    smax = CS.KERNEL_SHAPES["smax"]
    cases = []
    for key, arrs in CS.sprint_cases(dev):
        cases.append((key, arrs))
        if isinstance(key, int):
            # the same launch with no entry advancing (a copy of the rows)
            # and with every entry advancing smax-1 substeps
            copy = [a.clone() for a in arrs]
            copy[6].zero_()
            full = [a.clone() for a in arrs]
            full[5].fill_(smax - 1)
            full[6].fill_(1)
            cases += [(f"{key} all copy", copy), (f"{key} all advance", full)]
    with tempfile.TemporaryDirectory(prefix="kernel_compare_") as workdir:
        sl = CS.run_slice(dev, args.genome_bp, args.long_reads, workdir, smi)
        head = CS.head_reads(sl, workdir, 16)
        _, _, cap = CS.steps_pass(dev, sl, head, str(Path(workdir) /
                                                     "steps.fq"))
    cases.append(("engine NT=256", cap.args))
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    print(f"floor: a 4-byte add_ timed the same way, "
          f"{CS._call_ms(torch, lambda: one.add_(1), reps=10):.4f} ms",
          flush=True)
    if cap.smax != smax:
        raise RuntimeError(f"the engine's launch has smax={cap.smax}")
    for key, arrs in cases:
        R, B, W = arrs[0].shape
        want = SP.sprint_rows_ref(*arrs, smax=smax)
        bound, by = CS._bound_ms(*CS.sprint_work(arrs, smax))
        moving = int(((arrs[6] != 0) & (arrs[5][:, None] > 0)).sum())
        clone = CS._call_ms(torch, lambda: arrs[0].clone(), reps=10)
        print(f"sprint {key}: R={R} B={B} W={W}, {moving} of {R * B} "
              f"entries advance; bound {bound:.4f} ms ({by}); the rows' "
              f"clone() {clone:.4f} ms", flush=True)
        for tname in order:
            lib, mod = libs[tname]
            if mod.refuses(W):
                print(f"  {tname}: refuses {mod.refuses(W)}", flush=True)
                continue
            ms, cyc = run_sprint(torch, CS, lib, mod, arrs, want, smax)
            line = (f"  {tname}: {ms:.4f} ms ({bound / ms:.1%} of the "
                    "bound); equal to sprint_rows_ref")
            if cyc is not None:
                tot = max(sum(cyc[:-1]), 1)
                line += (f"; SM cycles by phase: " + ", ".join(
                    f"{p} {100 * c / tot:.1f}%" for p, c in
                    zip(SPRINT_PHASES, cyc)) +
                    f"; {tot / max(cyc[-1], 1):.0f} a warp's entry")
            print(line, flush=True)
    print(smi, flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=tuple(SOURCES) + tuple(PLAN_KINDS),
                    default="beam")
    ap.add_argument("--split", nargs="?", const="", default=None,
                    metavar="NAME,...",
                    help="planner kernels: time each CUDA kernel of a call; "
                    "sprint: SM cycles by phase (of the named trees only, "
                    "when names are given)")
    ap.add_argument("--genome-bp", type=int, default=4_000_000)
    ap.add_argument("--long-reads", type=int, default=256)
    ap.add_argument("--order", default=None,
                    help="comma-separated tree names, repeats allowed "
                    "(default: each tree once, in the order given)")
    ap.add_argument("trees", nargs="+", help="NAME=DIR")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as CS
    from ratatosk_tpu_torch.correct import beam as BM
    from ratatosk_tpu_torch.correct import finish as FN
    if not torch.cuda.is_available():
        raise SystemExit("kernel_compare: torch sees no CUDA device")
    kind = args.kernel
    trees = dict(t.split("=", 1) for t in args.trees)
    order = args.order.split(",") if args.order else list(trees)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = CS._cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).splitlines()[0]
    print(smi, flush=True)
    if kind in PLAN_KINDS:
        return main_plan(torch, CS, args, trees, order, dev, smi)
    if kind == "sprint":
        return main_sprint(torch, CS, args, trees, order, dev, smi)
    libs = {n: load_tree(kind, n, Path(d).resolve()) for n, d in trees.items()}
    with tempfile.TemporaryDirectory(prefix="kernel_compare_") as workdir:
        sl = CS.run_slice(dev, args.genome_bp, args.long_reads, workdir, smi)
        batches = CS.bucket_batches(sl, dev)
    for nt, b in batches.items():
        kw = dict(beam=b["beam"], lmax=b["lmax"], min_cov=b["min_cov"],
                  band=b["band"])
        want = BM.beam_search(b["g"], b["rb"], impl="torch", **kw)
        R = b["rb"].tgt_masks.shape[0]
        if kind == "beam":
            wk = CS.beam_work(torch, b["g"], b["rb"], n_real=b["n_real"],
                              **kw)
            T = wk["T"]
            print(f"NT={nt} ({b['tag']}): R={R} ({b['n_real']} real) "
                  f"B={b['beam']} W={b['W']} T={T} f_max={wk['f_max']} "
                  f"f_mean={wk['f_mean']:.2f}", flush=True)
        else:
            rb = b["rb"]
            fwant = FN.finish_bundle(rb.tgt_masks, rb.tgt_len, rb.tgt_qual,
                                     b["qv_max"], b["k"], want, w=b["band"],
                                     min_score_open=b["mso"])
            fw = CS.finish_work(torch, rb, want, band=b["band"],
                                n_real=b["n_real"])
            print(f"NT={nt} ({b['tag']}): R={R} ({b['n_real']} real) "
                  f"L={b['lmax']} W={fw['W']}, {fw['rows']} DP rows, the "
                  f"longest region {fw['max_rows']} rows", flush=True)
        for name in order:
            lib, mod = libs[name]
            if kind == "beam":
                p1, p2, split = run_beam(torch, lib, mod, b, want)
                ms = p1 + p2
                print(f"  {name}: {ms:.4f} ms (phase 1 {p1:.4f}, phase 2 "
                      f"{p2:.4f}), {ms / max(T, 1) * 1e3:.2f} us per step; "
                      f"bit-identical", flush=True)
                if split is None:
                    continue
                n = (len(split) - 2) // 2
                for ph in (0, 1):
                    steps = max(split[2 * n + ph], 1)
                    cyc = split[n * ph:n * ph + n]
                    tot = max(sum(cyc), 1)
                    print(f"    phase {ph + 1}: {split[2 * n + ph]} "
                          "region-steps; cycles per region-step by part: "
                          + ", ".join(f"{p} {c / steps:.0f} "
                                      f"({100 * c / tot:.1f}%)"
                                      for p, c in zip(PARTS[kind, n], cyc)),
                          flush=True)
            else:
                ms, split = run_finish(torch, lib, mod, b, want, fwant)
                print(f"  {name}: {ms:.4f} ms, {ms / fw['max_rows'] * 1e3:.3f}"
                      f" us per row of the longest region; bit-identical",
                      flush=True)
                if split is None:
                    continue
                n = len(split) - 2
                rows, most = max(split[n], 1), split[n + 1]
                tot = max(sum(split[:n]), 1)
                print(f"    {split[n]} rows walked (the most {most}); SM "
                      "cycles per row by part: "
                      + ", ".join(f"{p} {c / rows:.0f} ({100 * c / tot:.1f}%)"
                                  for p, c in zip(PARTS[kind, n],
                                                  split[:n])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
