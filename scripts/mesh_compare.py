#!/usr/bin/env python3
"""Time the mesh of versions of the port on one card, on the same data.

    python3 scripts/mesh_compare.py [--genome-bp N] [--long-reads N]
        [--order a,b,b,a] NAME=DIR [NAME=DIR ...]

Each DIR is a checkout of the port (a tree holding `ratatosk_tpu_torch/`);
the name `this` stands for this checkout. The slice of chip_smoke.py is
built once by this checkout (its reads, both passes' graphs and FASTQ
files), and its graphs are pickled for the trees. Then, in the order given
(so that versions alternate), one process per entry imports its tree's
package alone and runs both passes of the slice through fresh Correctors:
once to warm up, then on one device, on the mesh, on the mesh and on one
device again. The mesh is cuda:0..n-1 with two or more cards, else two
slots on cuda:0, as in chip_smoke.py `[mesh]`. Every run's FASTQ files
must equal the slice's byte for byte. The passes run untraced and with no
spy on the mesh. Prints each process's pass seconds and one JSON line per
process. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def worker(data_dir: str, name: str, tree: str) -> int:
    """One tree's runs, in this process; the package is the tree's."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch
    from ratatosk_tpu_torch.correct.engine import Corrector
    from ratatosk_tpu_torch.ops import cuda_lib
    from ratatosk_tpu_torch.ops import native_align as NA
    from ratatosk_tpu_torch.parallel import mesh as M
    from ratatosk_tpu_torch.pipeline import correct_file
    import ratatosk_tpu_torch
    pkg = Path(ratatosk_tpu_torch.__file__).resolve().parent
    if pkg.parent != Path(tree).resolve():
        raise SystemExit(f"mesh_compare: imported {pkg}, not {tree}'s")
    with open(os.path.join(data_dir, "slice.pkl"), "rb") as f:
        d = pickle.load(f)
    NA.available()                                  # built outside the timing
    t = time.time()
    cuda_lib.library()
    t_build = time.time() - t
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    n = torch.cuda.device_count()
    devs = ([torch.device("cuda", i) for i in range(n)] if n >= 2
            else [dev] * 2)
    mesh = M.make_mesh(devices=devs)
    graphs = ((d["cdbg1"], d["colors1"]), (d["cdbg2"], d["colors2"]))

    def two_passes(place):
        o1, o2 = d["o1"], d["o2"]
        corrs = [Corrector(cdbg, colors, o, **place)
                 for (cdbg, colors), o in zip(graphs, (o1, o2))]
        corrs[0].warmup_compile()
        torch.cuda.synchronize()
        secs = []
        for p, corr, o, src, ref in ((1, corrs[0], o1, d["lr_path"],
                                      d["p1_path"]),
                                     (2, corrs[1], o2, d["p1_path"],
                                      d["p2_path"])):
            out = os.path.join(data_dir, f"{name}.{os.getpid()}.p{p}.fastq")
            t = time.time()
            correct_file(corr, o, [src], out, p)
            torch.cuda.synchronize()
            secs.append(time.time() - t)
            if Path(out).read_bytes() != Path(ref).read_bytes():
                raise AssertionError(f"{name}: pass-{p} FASTQ differs from "
                                     "the slice's")
            os.unlink(out)
        return secs

    one, on_mesh = dict(device=dev), dict(mesh=mesh)
    warm = two_passes(one) + two_passes(on_mesh)
    runs = {"one": [], "mesh": []}
    for kind in ("one", "mesh", "mesh", "one"):
        runs[kind].append(two_passes(one if kind == "one" else on_mesh))
    for kind, secs in runs.items():
        print(f"  {name} ({pkg.parent}): {kind}: "
              + "; ".join(f"pass 1 {a:.3f}s, pass 2 {b:.3f}s"
                          for a, b in secs), flush=True)
    mean = {k: [sum(s[i] for s in v) / len(v) for i in (0, 1)]
            for k, v in runs.items()}
    print(f"  {name}: mesh / one device: pass 1 "
          f"{mean['mesh'][0] / mean['one'][0]:.3f}x, pass 2 "
          f"{mean['mesh'][1] / mean['one'][1]:.3f}x (kernel library "
          f"{t_build:.1f}s, warm-up passes "
          f"{', '.join(f'{x:.2f}' for x in warm)}s)", flush=True)
    print(json.dumps({"name": name, "slots": mesh.size, "runs": runs,
                      "mean": mean}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--genome-bp", type=int, default=4_000_000)
    ap.add_argument("--long-reads", type=int, default=256)
    ap.add_argument("--order", default=None,
                    help="comma-separated tree names, repeats allowed "
                    "(default: each tree once, in the order given)")
    ap.add_argument("--worker", nargs=3, metavar=("DATA", "NAME", "TREE"),
                    help=argparse.SUPPRESS)
    ap.add_argument("trees", nargs="*", help="NAME=DIR")
    args = ap.parse_args(argv)
    if args.worker:
        return worker(*args.worker)
    trees = {n: (str(ROOT) if n == "this" else d)
             for n, d in (t.split("=", 1) for t in args.trees)}
    order = args.order.split(",") if args.order else list(trees)
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as CS
    if not torch.cuda.is_available():
        raise SystemExit("mesh_compare: torch sees no CUDA device")
    dev = torch.device("cuda", 0)
    smi = CS._cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).splitlines()[0]
    print(smi, flush=True)
    with tempfile.TemporaryDirectory(prefix="mesh_compare_") as workdir:
        sl = CS.run_slice(dev, args.genome_bp, args.long_reads, workdir, smi)
        with open(os.path.join(workdir, "slice.pkl"), "wb") as f:
            pickle.dump(dict(cdbg1=sl["corr1"].cdbg,
                             colors1=sl["corr1"].colors,
                             cdbg2=sl["corr2"].cdbg,
                             colors2=sl["corr2"].colors, o1=sl["o1"],
                             o2=sl["o2"], lr_path=sl["lr_path"],
                             p1_path=sl["p1_path"], p2_path=sl["p2_path"]),
                        f, protocol=pickle.HIGHEST_PROTOCOL)
        del sl
        for name in order:
            env = dict(os.environ, PYTHONPATH="")
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--worker",
                 workdir, name, trees[name]], env=env, timeout=1800)
            if proc.returncode:
                raise SystemExit(f"mesh_compare: {name} exited "
                                 f"{proc.returncode}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
