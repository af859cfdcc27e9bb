"""One run of one cell of the port's benchmark, on cuda:0.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of BENCHMARK.json's `workloads`; its configuration,
traffic mix and metric readers are files under benchmark/ found by name
(cells.py). Set-up, the window and the record: job.py. The comparison that
decides `correct`: check.py. Progress goes to standard error; the last line
of standard output is one JSON object (correct, attempted, failed, metrics,
device, with --trace 1 breakdown, and check last). It exits with 1 and
prints no result when torch sees no CUDA device or fewer than the cell
asks for, and when jax, jaxlib, flax or the JAX package is loaded once the
window has closed.
"""

from __future__ import annotations

import time

T_START = time.time()   # set-up opens here, before the imports

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# the JAX package, and what it needs, by whole top-level module name: the
# port's name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "ratatosk_tpu")


def forbidden_modules(modules=None) -> list:
    """Top-level names in sys.modules (or `modules`) that are FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def card_info(torch, n: int) -> dict:
    """The card's name and power limit (nvidia-smi), the cards the run uses."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = "nvidia-smi unavailable"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": n, "power_limit": smi.rsplit(",", 1)[-1].strip()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import cells
    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("benchmark: torch sees no CUDA device", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} cards, torch sees "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    result = run(cell, args.seed, args.seconds, bool(args.trace),
                 torch.device("cuda", 0))
    if result is None:
        return 1
    print(json.dumps(result), flush=True)
    return 0


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float = T_START):
    """The run's result line as a dict, or None when a forbidden module is
    loaded once the window has closed (named on standard error)."""
    import torch

    from benchmark import cells, check, job
    seed_data = seed % (1 << 63)

    def per_layer(rec):
        rec["per_layer"] = cells.read_metrics(cell.per_layer, rec)

    with tempfile.TemporaryDirectory(prefix="benchmark_") as tmp:
        r = job.run_cell(cell, seed_data, seconds, trace, device, Path(tmp),
                         t_start, per_layer=per_layer)
        bad = forbidden_modules()
        if bad:
            print(f"benchmark: loaded once the window closed: {bad}",
                  file=sys.stderr)
            return None
        rec = r.record
        t0 = time.time()
        numbers = check.verify(r, seed_data, cell.traffic["check_reads"],
                               device)
        job.log(f"check: {numbers} ({time.time() - t0:.1f}s)")
    correct = check.holds(numbers)
    device_rec = {"platform": "cpu", "kind": "cpu", "count": 1} \
        if device.type != "cuda" else card_info(torch, cell.chips)
    device_rec["memory_peak_bytes"] = rec["memory_peak_bytes"]
    out = {"correct": correct, "attempted": rec["reads"],
           "failed": numbers["reads_missing"] + numbers["reads_differ"]}
    if trace:
        out["metrics"] = rec["per_layer"]
        prof = rec["profile"]
        device_rec["busy_s"] = prof["busy_s"]
        device_rec["window_s"] = rec["trace_window_s"]
        out["device"] = device_rec
        out["breakdown"] = {
            "device_ops": sorted(([n, s] for n, s in prof["by_name"].items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": prof["idle_gaps"]}
    else:
        out["metrics"] = cells.read_metrics(cell.end_to_end, rec)
        out["device"] = device_rec
    out["record"] = {k: rec[k] for k in ("jobs", "wraps", "window_s",
                                          "bases", "job_s", "timers",
                                          "host")}
    out["check"] = {k: {"value": numbers[k], "limit": lim}
                    for k, lim in check.LIMITS.items()}
    for k, lim in check.LIMITS.items():
        print(f"check {k} {numbers[k]} limit {lim}", file=sys.stderr)
    print(f"check correct {str(correct).lower()}", file=sys.stderr, flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
