"""The readings that the limits of check.py were set from, on the chip
at a cell's own size (not part of a benchmark run):

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 [--seconds 1]

For each seed: the cell's set-up and a short window at its own load (at
least one whole job), then the reference's own index; the program's
numbers against the float32 reference, and the control's: the reference
with its candidate scores ranked in bfloat16, the nearest precision below
the float32 the configuration states, put in the program's place and
compared the same way. One JSON line a seed on standard output, the numbers
at the end; chiprun_out/control_<cell>.json gets them all.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def readings(cell, seed: int, seconds: float, device,
             t_start: float) -> dict:
    """The program's and the control's numbers at one seed."""
    import torch

    from benchmark import check, job
    with tempfile.TemporaryDirectory(prefix="benchmark_control_") as tmp:
        r = job.run_cell(cell, seed, seconds, False, device, Path(tmp),
                         t_start)
        got, missing = check.program_records(r)
        idx = check.sample(r, seed, cell.traffic["check_reads"])
        t0 = time.time()
        want, low = check.reference_records(
            r, idx, device, (torch.float32, torch.bfloat16))
        ref_s = time.time() - t0
    ctrl = {name: [rec] for name, rec in low.items()}
    return {"seed": seed, "reads_checked": len(idx),
            "program": {"reads_missing": missing,
                        "reads_differ": check.compare(got, want)},
            "control": {"reads_missing": 0,
                        "reads_differ": check.compare(ctrl, want)},
            "control_reads": sorted(n for n in want if low[n] != want[n]),
            "reference_s": ref_s, "record": {
                k: r.record[k] for k in ("setup_s", "window_s", "bases",
                                         "jobs")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    import torch

    from benchmark import cells
    if not torch.cuda.is_available():
        print("control: torch sees no CUDA device", file=sys.stderr)
        return 1
    cell = cells.load_cell(args.workload)
    rows = []
    for s in args.seeds.split(","):
        t0 = time.time() if rows else T_START
        rows.append(readings(cell, int(s), args.seconds,
                             torch.device("cuda", 0), t0))
        print(json.dumps(rows[-1]), flush=True)
    out = ROOT / "chiprun_out" / f"control_{cell.name}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
