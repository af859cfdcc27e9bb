#!/usr/bin/env python3
"""Time versions of the fused beam kernel on one card, on the same launches.

    python3 scripts/beam_kernel_compare.py [--genome-bp N] [--long-reads N]
        [--order old,new,new,old] NAME=DIR [NAME=DIR ...]

Each DIR is a tree that holds `ratatosk_tpu_torch/csrc/beam.cu` and
`ratatosk_tpu_torch/ops/beam_kernel.py` (a checkout of another commit, or
only those two files); the name `this` stands for this checkout. Every other
tree's beam.cu is built alone with the package's nvcc flags into
`DIR/ratatosk_tpu_torch/build/`, and its own beam_kernel.enqueue drives it.

The launches are chip_smoke.py's `[kernel]` batches: the slice's reads run
through both passes, then one engine-formed launch per bucket (NT 256 /
2048 / 5376, beam 16). Per bucket and tree, in the order given (so that two
versions alternate on one card): the result against the plain version
(bit-identical or it raises), then the mean of 5 timed calls after a
warm-up, with CUDA events around each of the two launches (phase 1, phase
2), and ms per step (the call's time over the launch's T). A library that
exports `beam_clock_read` (an instrumented copy) also gets its SM cycles by
part of a step, summed over blocks, per block-step. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# the parts of an instrumented copy's counters, by their number: the
# block-per-region kernel's and the warp-per-region kernel's
PARTS = {8: ("bookkeeping", "sprint", "cand_stats", "scoreboard_rank",
             "color", "row_rebuild", "window_shift", "load_save_pick_walk"),
         10: ("classify_keeps", "record_bases_row", "sprint", "cand_stats",
              "cand_write", "scoreboard_rank", "color", "new_entries",
              "row_rebuild", "load_save_pick_walk")}


def load_tree(name: str, tree: Path):
    """(library, beam_kernel module) of one tree."""
    from ratatosk_tpu_torch.ops import beam_kernel, cuda_lib
    if name == "this":
        return cuda_lib.library(), beam_kernel
    src = tree / "ratatosk_tpu_torch" / "csrc" / "beam.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(cuda_lib.NVCC_FLAGS)
                       .encode()).hexdigest()[:16]
    out = tree / "ratatosk_tpu_torch" / "build" / f"libbeam_{h}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([cuda_lib.nvcc(), *cuda_lib.NVCC_FLAGS, "-o",
                               str(out), str(src)], capture_output=True,
                              text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(out))
    res, args = cuda_lib.SIGNATURES["beam_search_launch"]
    lib.beam_search_launch.restype, lib.beam_search_launch.argtypes = res, args
    spec = importlib.util.spec_from_file_location(
        f"beam_kernel_{name}",
        tree / "ratatosk_tpu_torch" / "ops" / "beam_kernel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return lib, mod


def clocks(lib):
    """The instrumented counters ([2][P] cycles by launch and part, then
    [2] steps), zeroed after the read; None for a library without them.
    P is beam_clock_parts() where the library has it, else 8."""
    if not hasattr(lib, "beam_clock_read"):
        return None
    n = lib.beam_clock_parts() if hasattr(lib, "beam_clock_parts") else 8
    buf = (ctypes.c_ulonglong * (2 * n + 2))()
    if lib.beam_clock_read(buf):
        raise RuntimeError("beam_clock_read failed")
    return list(buf)


def run_tree(torch, lib, mod, b, want, reps=5):
    """(phase-1 ms, phase-2 ms, cycle split or None) of one tree on one
    launch; raises unless its result equals the plain version's."""
    from ratatosk_tpu_torch.correct import beam as BM
    from ratatosk_tpu_torch.ops import cuda_lib
    g, rb = b["g"], b["rb"]
    dev = rb.tgt_masks.device
    stream = torch.cuda.current_stream(dev)
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731

    def call():
        # a 1 ms device sleep first: the host's enqueue stays out of
        # launch 1's time
        torch.cuda._sleep(2_000_000)
        marks = [ev()]
        marks[0].record(stream)

        def counted():
            marks.append(ev())
            marks[-1].record(stream)
        res = mod.enqueue(lib, g, rb, beam=b["beam"], W=b["W"],
                          lmax=b["lmax"], min_cov=b["min_cov"], sprint=8,
                          index=cuda_lib.device_index(dev),
                          stream=stream.cuda_stream, counted=counted)
        return res, marks

    clocks(lib)
    got, _ = call()
    torch.cuda.synchronize()
    split = clocks(lib)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
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
    if not torch.cuda.is_available():
        raise SystemExit("beam_kernel_compare: torch sees no CUDA device")
    trees = dict(t.split("=", 1) for t in args.trees)
    order = args.order.split(",") if args.order else list(trees)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = CS._cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).splitlines()[0]
    print(smi, flush=True)
    libs = {n: load_tree(n, Path(d).resolve()) for n, d in trees.items()}
    with tempfile.TemporaryDirectory(prefix="beam_compare_") as workdir:
        sl = CS.run_slice(dev, args.genome_bp, args.long_reads, workdir, smi)
        batches = CS.bucket_batches(sl, dev)
    for nt, b in batches.items():
        kw = dict(beam=b["beam"], lmax=b["lmax"], min_cov=b["min_cov"],
                  band=b["band"])
        want = BM.beam_search(b["g"], b["rb"], impl="torch", **kw)
        wk = CS.beam_work(torch, b["g"], b["rb"], n_real=b["n_real"], **kw)
        T = wk["T"]
        print(f"NT={nt} ({b['tag']}): R={b['rb'].tgt_masks.shape[0]} "
              f"({b['n_real']} real) B={b['beam']} W={b['W']} T={T} f_max="
              f"{wk['f_max']} f_mean={wk['f_mean']:.2f}", flush=True)
        for name in order:
            lib, mod = libs[name]
            p1, p2, split = run_tree(torch, lib, mod, b, want)
            ms = p1 + p2
            print(f"  {name}: {ms:.4f} ms (phase 1 {p1:.4f}, phase 2 "
                  f"{p2:.4f}), {ms / max(T, 1) * 1e3:.2f} us per step; "
                  f"bit-identical", flush=True)
            if split is not None:
                n = (len(split) - 2) // 2
                for ph in (0, 1):
                    steps = max(split[2 * n + ph], 1)
                    cyc = split[n * ph:n * ph + n]
                    tot = max(sum(cyc), 1)
                    print(f"    phase {ph + 1}: {split[2 * n + ph]} "
                          "region-steps; cycles per region-step by part: "
                          + ", ".join(f"{p} {c / steps:.0f} "
                                      f"({100 * c / tot:.1f}%)"
                                      for p, c in zip(PARTS[n], cyc)),
                          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
