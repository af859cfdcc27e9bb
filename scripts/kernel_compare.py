#!/usr/bin/env python3
"""Time versions of the fused beam kernel or of the finish kernel on one
card, on the same launches.

    python3 scripts/kernel_compare.py [--kernel beam|finish] [--genome-bp N]
        [--long-reads N] [--order old,new,new,old] NAME=DIR [NAME=DIR ...]

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
per region-step or per row. Needs a CUDA device.
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
           "finish": ("finish.cu", "finish_kernel", "finish_bundle_launch")}


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", choices=tuple(SOURCES), default="beam")
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
