"""One run of a cell: set-up, the measured window, and the record that the
metric readers and the check read.

Set-up makes the data from the seed (gen.py), builds the pass's index
through the port (graph.build + graph.colors for pass 1,
pipeline.build_pass2_index for pass 2), builds the Corrector on the card,
loads the kernel library (built once per checkout into
ratatosk_tpu_torch/build/), writes the traffic's pool of long reads as
chunk files of job_reads reads each, and corrects the first warm_reads
reads once. The window then runs one correction job after another through
pipeline.correct_file, the entry of `correct -1` / `correct -2`, each on the
next chunk (wrapping round to the first), each ending in a synchronize, and
closes at the first job end past --seconds. From the Corrector on, torch's
CPU threads are the job's own `nb_threads` (a `correct -c <n>` job asks its
cluster for n cores), so that the program's threads do not outnumber them.
"""

from __future__ import annotations

import dataclasses
import gc
import resource
import sys
import time
from pathlib import Path

import torch

from benchmark import gen, host
from benchmark.fastq import write_fastq


def log(msg: str) -> None:
    print(f"[benchmark] {msg}", file=sys.stderr, flush=True)


def rss_gb() -> float:
    """The process's peak resident memory so far, GB (ru_maxrss is KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


@dataclasses.dataclass
class Run:
    """What a run keeps for the check after the window: the data it handed
    the program, the chunks' read indices and each window job."""
    pass_no: int
    options: dict
    short_reads: list
    long_reads: list
    chunks: list          # [[pool index of each read of the chunk]]
    chunk_paths: list
    jobs: list            # [{"chunk", "out", "seconds"}]
    record: dict


def run_window(corr, opt, pass_no, chunk_paths, chunk_bases, seconds,
               device, correct_file, workdir: Path):
    """Correction jobs back to back until the first job end past `seconds`.
    Returns (jobs, window seconds, input bases corrected)."""
    jobs, bases = [], 0
    t_win = time.perf_counter()
    while True:
        j = len(jobs)
        c = j % len(chunk_paths)
        out = str(workdir / f"out_{j}.fq")
        t0 = time.perf_counter()
        correct_file(corr, opt, [chunk_paths[c]], out, pass_no)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        jobs.append({"chunk": c, "out": out, "seconds": t1 - t0})
        bases += chunk_bases[c]
        if t1 - t_win >= seconds:
            return jobs, t1 - t_win, bases


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             workdir: Path, t_start: float, per_layer=None) -> Run:
    """One run of `cell` on `device`, its files in `workdir`. t_start: the
    process's start, which opens set-up. With `trace`, the window runs under
    torch.profiler and `per_layer(record)` reads the per-layer metrics into
    the record before the program's state is freed."""
    from ratatosk_tpu_torch import pipeline
    from ratatosk_tpu_torch.config import CorrectOpt
    from ratatosk_tpu_torch.correct import engine
    from ratatosk_tpu_torch.graph import build as B
    from ratatosk_tpu_torch.graph.colors import color_graph

    cfg, trf = cell.config, cell.traffic
    pass_no = cfg["pass"]
    log(f"{cell.name}: seed {seed}, {seconds} s window, trace {int(trace)}")
    sreads, lreads = gen.simulate(cfg, trf, seed)
    log(f"data: {len(sreads)} short reads, {len(lreads)} long reads "
        f"({time.time() - t_start:.1f}s)")

    opt = CorrectOpt(**cfg["options"])
    opt_p = pipeline._pass_opt(opt, pass_no)
    t0 = time.time()
    if pass_no == 1:
        cdbg = B.build_cdbg(sreads, opt.small_k, min_count=opt.min_count_kmer)
        colors = color_graph(cdbg, sreads)
    else:
        cdbg, colors = pipeline.build_pass2_index(
            opt, ((r, None) for r in lreads), sreads,
            list(range(len(sreads))))
    index_s = time.time() - t0
    log(f"index: k={cdbg.k}, {cdbg.n_unitigs} unitigs, {cdbg.index.n} "
        f"k-mers ({index_s:.1f}s)")

    threads = torch.get_num_threads()
    torch.set_num_threads(opt.nb_threads)
    corr = engine.Corrector(cdbg, colors, opt_p, device=device)
    corr.warmup_compile()

    n_job = trf["job_reads"]
    chunks = [list(range(a, min(a + n_job, len(lreads))))
              for a in range(0, len(lreads), n_job)]
    chunk_paths = []
    for c, idx in enumerate(chunks):
        path = workdir / f"in_{c}.fq"
        write_fastq(path, ((f"L{i}", lreads[i]) for i in idx))
        chunk_paths.append(str(path))
    chunk_bases = [sum(len(lreads[i]) for i in idx) for idx in chunks]
    warm = workdir / "warm.fq"
    write_fastq(warm, ((f"L{i}", lreads[i])
                       for i in range(min(trf["warm_reads"], len(lreads)))))
    pipeline.correct_file(corr, opt_p, [str(warm)],
                          str(workdir / "warm.out.fq"), pass_no)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    corr.timers = dict.fromkeys(corr.timers, 0.0)
    probe0 = host.probe()
    setup_s = time.time() - t_start
    log(f"set-up {setup_s:.1f}s")
    h0 = host.snapshot()

    prof = cap = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        from benchmark import trace as TR
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with TR.capture(corr, engine) as cap, \
                profile(activities=acts) as prof:
            jobs, window_s, bases = run_window(
                corr, opt_p, pass_no, chunk_paths, chunk_bases, seconds,
                device, pipeline.correct_file, workdir)
    else:
        jobs, window_s, bases = run_window(
            corr, opt_p, pass_no, chunk_paths, chunk_bases, seconds, device,
            pipeline.correct_file, workdir)
    h1 = host.snapshot()
    torch.set_num_threads(threads)
    rec = {
        "host": dict(host.over(h0, h1), probe_s=[probe0, host.probe()]),
        "setup_s": setup_s, "window_s": window_s, "bases": bases,
        "jobs": len(jobs), "wraps": len(jobs) // len(chunks),
        "reads": sum(len(chunks[j["chunk"]]) for j in jobs),
        "job_s": [j["seconds"] for j in jobs],
        "timers": dict(corr.timers), "index_build_s": index_s,
        "peak_rss_gb": rss_gb(),
        "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else 0),
    }
    log(f"window: {len(jobs)} jobs ({rec['wraps']} wraps), {bases} bases "
        f"in {window_s:.2f}s = {bases / window_s:.1f} bases/s; timers "
        + ", ".join(f"{k} {v:.2f}s" for k, v in rec["timers"].items()))
    log(f"host: {rec['host']}")
    if trace:
        from benchmark import trace as TR
        rec["profile"] = TR.read_profile(prof, cap.clock)
        rec["launches"] = cap.launches
        rec["trace_window_s"] = window_s
        if per_layer is not None:
            per_layer(rec)
        del prof, cap
        rec.pop("launches")
    del corr, cdbg, colors
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return Run(pass_no=pass_no, options=cfg["options"], short_reads=sreads,
               long_reads=lreads, chunks=chunks, chunk_paths=chunk_paths,
               jobs=jobs, record=rec)
