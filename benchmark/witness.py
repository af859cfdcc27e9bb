"""A witness for the data and the plain reference from outside the port: the
JAX package's own runs of bench.py's pass 1.

    python3 benchmark/witness.py [--device cpu|cuda] [--full]

The JAX package (ratatosk_tpu), run on the CPU on bench.py's data at seed
1234, recorded the sha256 of its inputs (the short reads as FASTA `>S<i>`,
the long reads as FASTQ) and of its pass-1 FASTQ, for bench.py's default
size (4 Mbp, 5,000 long reads) and for its smoke size (1 Mbp, 64 long
reads). The digests are copied here as constants, so that nothing of the
port or of the JAX package is read. The witness holds gen.py's draw at
seed 1234 to both sizes' inputs, and the reference's pass-1 correction of
the smoke size's 64 reads, on its own index, to the JAX package's pass-1
FASTQ byte for byte; with --full, also its pass-1 correction of the
default size's 5,000 reads (32 minutes on 8 CPU cores). Exit 0 when every
digest is equal, 1 otherwise.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SEED = 1234
# data/jax_digests.json entries "bench_default" and "bench_smoke", written by
# scripts/jax_digests.py with JAX 0.9.0 on the CPU at commit 7f6bcca
JAX = {
    "bench_default": {
        "genome_bp": 4_000_000, "n_long_reads": 5000,
        "short.fa": "88488956aa00ebe26bd58a6467b4ca4e"
                    "3a8e68013303492fffe676730c7277e0",
        "long.fq": "b3534930511b159aad15869a914d6c6a"
                   "504ec0831a1e5f22ade24cd37cf4edcd",
        "pass1": "ddeee179c55e9394d780f87826441cfc"
                 "46da0169c9f8c917647f58881931a53f"},
    "bench_smoke": {
        "genome_bp": 1_000_000, "n_long_reads": 64,
        "short.fa": "84152d277ea657e8328ed513b1d0aac7"
                    "9afb6c53bd3d4825f6370825a5d05d74",
        "long.fq": "ef38e0bfa9b2ff0becaadfc5aff85725"
                   "520cbc595176f755207ccb893f0a48cd",
        "pass1": "2106ab81920f47c00f2876bb5c524bcd"
                 "c8a4f6e4c6c49447e699161764935a9a"},
}
# bench.py's data and options, as the JAX package's entries name them
CONFIG = {"repeat_frac": 0.15, "repeat_len": 250, "short_coverage": 40.0,
          "short_read_len": 120}
TRAFFIC = {"read_len": 4000, "error": 0.1, "mix": [0.5, 0.25, 0.25]}
OPTIONS = {"small_k": 31, "k": 63, "beam_width": 16, "batch_regions": 512,
           "nb_threads": 2, "read_batch_bp": 1048576}


def data(entry: str):
    """(short reads, long reads) of an entry's size at seed 1234 (gen.py)."""
    from benchmark import gen
    e = JAX[entry]
    return gen.simulate(dict(CONFIG, genome_bp=e["genome_bp"]),
                        dict(TRAFFIC, pool_reads=e["n_long_reads"]), SEED)


def inputs_sha256(sreads, lreads) -> dict:
    """sha256 of the short reads as FASTA and the long reads as FASTQ, as
    bench.py writes them."""
    from benchmark.fastq import decode
    fa, fq = hashlib.sha256(), hashlib.sha256()
    for i, r in enumerate(sreads):
        fa.update(f">S{i}\n{decode(r)}\n".encode())
    for i, r in enumerate(lreads):
        fq.update(f"@L{i}\n{decode(r)}\n+\n{'!' * len(r)}\n".encode())
    return {"short.fa": fa.hexdigest(), "long.fq": fq.hexdigest()}


def reference_pass1_sha256(sreads, lreads, device, batch: int = 256) -> str:
    """sha256 of the reference's pass-1 FASTQ of every long read, on its own
    index of the short reads, written as the `correct` command writes it;
    `batch` reads at a time, about as many as the program's 1 MiB batches
    hold."""
    import numpy as np
    import torch

    from benchmark.reference import engine as E
    from benchmark.reference import index as I
    from benchmark.reference.config import CorrectOpt
    opt = CorrectOpt(**OPTIONS)
    cdbg, colors = I.build_index(opt, 1, sreads, ((r, None) for r in lreads))
    corr = E.Corrector(cdbg, colors, I.pass_opt(opt, 1), device=device,
                       score_dtype=torch.float32)
    h = hashlib.sha256()
    for a in range(0, len(lreads), batch):
        reads = lreads[a:a + batch]
        quals = [np.full(len(r), 33, np.uint8) for r in reads]
        for i, cr in enumerate(corr.correct_batch(reads, quals), a):
            h.update(f"@L{i}\n{cr.seq}\n+\n{cr.qual_str}\n".encode())
    return h.hexdigest()


def witness(device, full: bool = False) -> dict:
    """{check: [got, want]} of every digest compared."""
    out = {}
    for entry in ("bench_default", "bench_smoke"):
        t0 = time.time()
        sreads, lreads = data(entry)
        for k, v in inputs_sha256(sreads, lreads).items():
            out[f"{entry} {k}"] = [v, JAX[entry][k]]
        if entry == "bench_smoke" or full:
            out[f"{entry} pass1 (reference)"] = [
                reference_pass1_sha256(sreads, lreads, device),
                JAX[entry]["pass1"]]
        print(f"[witness] {entry} ({time.time() - t0:.1f}s)",
              file=sys.stderr, flush=True)
    return out


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda" if torch.cuda.is_available()
                    else "cpu")
    ap.add_argument("--full", action="store_true",
                    help="also the reference's pass 1 at the default size")
    args = ap.parse_args(argv)
    out = witness(torch.device(args.device), args.full)
    same = all(got == want for got, want in out.values())
    print(json.dumps({"equal": same, "device": args.device,
                      "digests": out}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
