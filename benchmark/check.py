"""The comparison that decides `correct`.

Two numbers, each with its limit:

- reads_missing: reads of a window job's input that its output does not
  hold, by name and in input order, over every job of the window (0);
- reads_differ: reads of a sample, drawn from the seed out of the reads the
  window corrected and holding the longest of them, whose corrected record
  (sequence with its IUPAC codes, and quality string) differs from the
  plain reference's (0).

The reference (reference/) derives its own index from the short and long
reads the benchmark handed the program and corrects the sampled reads with
its plain route; it reads the program's output only to compare. An exact
comparison has the limit 0 (PERF.md gives the readings it was set from).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.fastq import read_fastq

LIMITS = {"reads_missing": 0, "reads_differ": 0}


def sample(run, seed: int, n: int) -> list:
    """Pool indices of n reads the window corrected, drawn from the seed:
    the longest of them first, then the others at random."""
    done = sorted({i for j in run.jobs for i in run.chunks[j["chunk"]]})
    longest = max(done, key=lambda i: (len(run.long_reads[i]), -i))
    rest = [i for i in done if i != longest]
    rng = np.random.default_rng([seed, 1])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [longest] + sorted(rest[p] for p in pick)


def program_records(run) -> tuple:
    """({name: [(sequence, quality) of each job that wrote it]} of the
    window's output, the number of input reads that an output lacks or
    holds out of order)."""
    got, missing = {}, 0
    for j in run.jobs:
        want = [f"L{i}" for i in run.chunks[j["chunk"]]]
        recs = read_fastq(j["out"])
        names = [r[0] for r in recs]
        missing += sum(1 for p, name in enumerate(want)
                       if p >= len(names) or names[p] != name)
        for name, seq, qual in recs:
            got.setdefault(name, []).append((seq, qual))
    return got, missing


def reference_records(run, idx: list, device,
                      score_dtypes=(torch.float32,)) -> list:
    """For each of score_dtypes, {name: (sequence, quality)} of the reads
    `idx` corrected by the reference, its candidate scores ranked in that
    type, on its own index of the run's reads (derived once)."""
    from benchmark.job import log
    from benchmark.reference import engine as E
    from benchmark.reference import index as I
    from benchmark.reference.config import CorrectOpt
    opt = CorrectOpt(**run.options)
    t0 = time.time()
    cdbg, colors = I.build_index(opt, run.pass_no, run.short_reads,
                                 ((r, None) for r in run.long_reads))
    log(f"reference index: {cdbg.n_unitigs} unitigs, {cdbg.index.n} k-mers "
        f"({time.time() - t0:.1f}s)")
    reads = [run.long_reads[i] for i in idx]
    quals = [np.full(len(r), 33, np.uint8) for r in reads]
    out = []
    for dt in score_dtypes:
        corr = E.Corrector(cdbg, colors, I.pass_opt(opt, run.pass_no),
                           device=device, score_dtype=dt)
        t0 = time.time()
        out.append({f"L{i}": (cr.seq, cr.qual_str)
                    for i, cr in zip(idx, corr.correct_batch(reads, quals))})
        log(f"reference, scores in {dt}: {len(idx)} reads "
            f"({time.time() - t0:.1f}s)")
        del corr
    return out


def compare(got: dict, want: dict) -> int:
    """How many of `want`'s reads `got` lacks, or holds otherwise in some
    job (a read corrected again after the window wrapped round)."""
    return sum(1 for name, rec in want.items()
               if not got.get(name) or any(r != rec for r in got[name]))


def verify(run, seed: int, n_check: int, device) -> dict:
    """{number: value} of the run, as LIMITS names them."""
    got, missing = program_records(run)
    idx = sample(run, seed, n_check)
    want, = reference_records(run, idx, device)
    return {"reads_missing": missing, "reads_differ": compare(got, want),
            "reads_checked": len(idx)}


def holds(numbers: dict) -> bool:
    return all(numbers[k] <= lim for k, lim in LIMITS.items())
