#!/usr/bin/env python3
"""Scaling of the port from 1 card to N: bench.py's data and options through
the multi-host launcher with one process per card, and through the mesh of
one process over several cards; the pass window, corrected bases/s and the
scaling efficiency of each.

    python3 scripts/dist_scale_torch.py [small | <genome_bp> [n_reads]]
        [--procs 1,2,4] [--mesh 1,2,4] [--seed 1234] [--out PATH]
        [--device cuda]

Data: bench_torch.py's simulation (its size rules, seed, genome, short
reads, then long reads), the short reads written once as FASTA and the long
reads once as FASTQ. Options: bench.py's (k 31/63, beam 16, 512 regions a
launch, -c 2, 1 MiB read batches), given to the `correct` command's flags;
the command's other defaults (SNP detection, pass-1 edge rescue) hold.

--procs: for each N, N processes of `python -m
ratatosk_tpu_torch.distributed_correct` on a free localhost port, process i
with CUDA_VISIBLE_DEVICES=i and --devices 1, all started together.
--mesh: for each M, both passes in one process through Corrector(mesh=) over
cuda:0..M-1 (M=1: one card, no mesh), the indexes built once as the `correct`
command builds them, each pass on a fresh Corrector. An empty list skips
either part. The kernel library and the native libraries are built once,
before any run.

Per N and M: each pass's seconds (the trace's pass_done events: correct_file
from its start to its writer's close) for every process; the pass window
T = max over processes of pass 1 + max over processes of pass 2 (the slowest
host sets the pace; index builds and the pass-1 -> pass-2 hand-off stay
outside, as in bench.py); bases/s = input long bases / T; E(N) = bases/s(N) /
(N x bases/s(1)). Beside them, per process: the first batch's seconds (first
use is paid once per process and stays in T), the Corrector's timers (plan,
launch, finish, wait), the kernels' launches, peak device memory, peak RSS,
and the hand-off (all-gather, merge, pass-2 index, SNP detection, barriers)
apart; the host's usable cores; every card's name and power limit.

Checks, each of which raises: every N and every M writes the same pass-1 and
final FASTQ (sha256), and where ratatosk_tpu_torch/data/jax_digests.json
holds the JAX package's digests of this data and these flags (cli_default,
cli_small), the JAX package's (jax_match); the final error on the first 400
reads is below a fifth of the raw error; on the card every process and
every mesh pass launched the fused beam and finish kernels. It runs on the
card: without one, or with an N or M above the visible cards, it raises
before any work (--device cpu is for the tests: gloo processes on the CPU,
mesh slots on the CPU). Progress goes to stderr; the JSON result is the
last line of stdout and is written to --out (default
chiprun_out/dist_scale.json).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import bench_torch  # noqa: E402
from ratatosk_tpu_torch import digests, dna  # noqa: E402

DEFAULT_OUT = ROOT / "chiprun_out" / "dist_scale.json"
# bench.py's options, as the `correct` command's flags (-c 2: two threads)
OPTIONS = dict(k1=31, k2=63, beam_width=16, batch_regions=512, cores=2)
PATH_KERNELS = tuple(bench_torch.PATH_KERNELS)
RUN_TIMEOUT = 3000          # seconds a launcher run or the mesh run may take
_WORKER = ("import sys; sys.path.insert(0, sys.argv[1]); "
           "import dist_scale_torch as S; sys.exit(S.{}(sys.argv[2:]))")


def log(msg: str) -> None:
    print(f"[scale] {msg}", file=sys.stderr, flush=True)


def counts(text: str) -> list:
    """'1,2,4' -> [1, 2, 4]; '' -> []. Raises on a count below 1."""
    out = [int(x) for x in text.split(",") if x.strip()]
    if any(n < 1 for n in out):
        raise ValueError(f"counts must be at least 1: {text!r}")
    return out


def check_device(device: str, procs: list, mesh: list) -> None:
    """Raise unless the run can have every card it asks for: on `cuda` a
    visible card, and no N or M above the visible count (it never runs
    fewer than asked)."""
    if device == "cpu":
        return
    if device != "cuda":
        raise ValueError(f"--device is cuda or cpu, not {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("dist_scale_torch: torch sees no CUDA device")
    visible = torch.cuda.device_count()
    top = max(procs + mesh, default=0)
    if top > visible:
        raise RuntimeError(f"{top} cards asked for, {visible} visible")


def flags(**options) -> list:
    """The `correct` flags that set a run's options (OPTIONS, with
    `options` over them): its key among the JAX package's digests."""
    o = dict(OPTIONS, **options)
    return ["-c", str(o["cores"]), "-k", str(o["k1"]), "-K", str(o["k2"]),
            "--beam-width", str(o["beam_width"]),
            "--batch-regions", str(o["batch_regions"]), "--devices", "1"]


def cli_argv(short_fa: str, long_fq: str, out: str, trace=None,
             **options) -> list:
    """The `correct` flags of one run: the files, flags(**options), and the
    trace file when given."""
    return (["-s", short_fa, "-l", long_fq, "-o", out, *flags(**options),
             "-v"] + (["--trace-json", trace] if trace else []))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_commands(n: int, port: int, argv_of, device: str,
                    result_of) -> list:
    """(command, environment) of each process of an N-process launcher run:
    process i runs distributed_correct with --process-id i on `device`,
    sees card i alone (CUDA_VISIBLE_DEVICES=i), takes the `correct` flags
    argv_of(i) and writes its record to result_of(i)."""
    cmds = []
    for i in range(n):
        env = dict(os.environ, PYTHONPATH=str(ROOT),
                   CUDA_VISIBLE_DEVICES=str(i))
        if device == "cpu":
            env["OMP_NUM_THREADS"] = "1"
        cmds.append(([sys.executable, "-c",
                      _WORKER.format("scatter_worker"),
                      str(Path(__file__).resolve().parent), str(i), str(n),
                      str(port), device, result_of(i), "--", *argv_of(i)],
                     env))
    return cmds


# ---- in the worker processes -------------------------------------------------

class Recorder:
    """Times this process's pipeline steps by wrapping them where the
    launcher and the pipeline look them up: each correct_file pass (its
    Corrector's timers reset first, then its seconds, timers, the kernels'
    launches, peak device memory and RSS) and the steps around the passes
    (named spans)."""

    def __init__(self):
        from ratatosk_tpu_torch import pipeline
        from ratatosk_tpu_torch.parallel import build_dist, distributed
        self.t_start = time.time()
        self.passes, self.spans = [], []
        self.label = None
        # the steps of the pass-1 -> pass-2 hand-off
        steps = {pipeline: ("build_pass2_index", "_detect_snps"),
                 distributed: ("allgather_bytes", "merge_parts", "barrier"),
                 build_dist: ("color_graph_dist",)}
        for mod, names in steps.items():
            for name in names:
                setattr(mod, name, self._span(name, getattr(mod, name)))
        pipeline.correct_file = self._pass(pipeline.correct_file)

    def _span(self, name, fn):
        def timed(*args, **kw):
            t0 = time.time()
            try:
                return fn(*args, **kw)
            finally:
                self.spans.append((name, t0, time.time()))
        return timed

    def _pass(self, correct_file):
        from ratatosk_tpu_torch.ops import beam_kernel, finish_kernel
        kernels = {"fused_beam_search": beam_kernel.fused_beam_search,
                   "finish_bundle_kernel": finish_kernel.finish_bundle_kernel}

        def timed(corrector, opt, in_paths, out_path, pass_no, **kw):
            devs = (corrector.mesh.distinct() if corrector.mesh is not None
                    else [corrector.device])
            cards = [torch.device("cuda", torch.cuda.current_device()
                                  if d.index is None else d.index)
                     for d in devs if d.type == "cuda"]
            for d in cards:
                torch.cuda.reset_peak_memory_stats(d)
            corrector.timers = dict.fromkeys(corrector.timers, 0.0)
            before = {n: fn.launches for n, fn in kernels.items()}
            t0 = time.time()
            out = correct_file(corrector, opt, in_paths, out_path, pass_no,
                               **kw)
            for d in cards:
                torch.cuda.synchronize(d)
            gb = 1 << 30
            self.passes.append(dict(
                label=self.label, pass_no=pass_no, t0=t0, t1=time.time(),
                timers=dict(corrector.timers),
                launches={n: fn.launches - before[n]
                          for n, fn in kernels.items()},
                peak_allocated_gb={str(d): torch.cuda.max_memory_allocated(d)
                                   / gb for d in cards},
                peak_reserved_gb={str(d): torch.cuda.max_memory_reserved(d)
                                  / gb for d in cards},
                rss_gb=bench_torch.rss_gb()))
            return out
        return timed

    def dump(self, path: str, **extra) -> None:
        with open(path, "w") as f:
            json.dump(dict(t_start=self.t_start, t_end=time.time(),
                           passes=self.passes, spans=self.spans,
                           peak_rss_gb=bench_torch.rss_gb(), **extra), f)


def scatter_worker(argv) -> int:
    """Process `pid` of an N-process launcher run (launch_commands):
    distributed_correct.main on `device`, recorded."""
    pid, n, port, device, result = argv[:5]
    rest = argv[6:]                                   # past the "--"
    rec = Recorder()
    from ratatosk_tpu_torch import distributed_correct
    distributed_correct.main(
        ["--coordinator", f"localhost:{port}", "--num-processes", n,
         "--process-id", pid, "--", *rest], device=device)
    rec.dump(result, pid=int(pid), n=int(n))
    return 0


def mesh_of(m: int, device: torch.device):
    """None for one device, else a mesh of m slots: cuda:0..m-1 on the card,
    m CPU slots on the CPU."""
    from ratatosk_tpu_torch.parallel import mesh as M
    if m == 1:
        return None
    if device.type == "cpu":
        return M.make_mesh(devices=["cpu"] * m)
    return M.make_mesh(devices=[torch.device("cuda", i) for i in range(m)])


def mesh_worker(argv) -> int:
    """Both passes for each mesh size in this process, as
    pipeline.run_correct runs them (its steps in its order, each Corrector on
    the mesh of that size), the indexes built once; each pass's FASTQ to
    <prefix>.mesh<M>.* and its trace to <prefix>.mesh<M>.trace.jsonl."""
    sizes, device, result = argv[:3]
    from ratatosk_tpu_torch.distributed_correct import correct_opt
    opt = correct_opt(argv[4:])
    rec = Recorder()
    from ratatosk_tpu_torch import pipeline as P
    from ratatosk_tpu_torch.correct.engine import Corrector
    from ratatosk_tpu_torch.io import fastx
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
    sizes = counts(sizes)
    prefix = opt.prefix_filename_out
    shorts, ids, _ = P.load_short_reads(opt)
    cdbg, colors = P.build_pass1_index(opt, shorts, ids)
    cdbg2_pre = P.rescue_edges_pass1(opt, cdbg, colors, shorts)
    meshes = {m: mesh_of(m, dev) for m in sizes}

    def passes(pass_no, cdbg, colors, src):
        o = P._pass_opt(opt, pass_no)
        snps = P._detect_snps(opt, cdbg, colors)
        outs = {}
        for m in sizes:
            corr = Corrector(cdbg, colors, o, snps=snps, mesh=meshes[m],
                             device=dev)
            corr.warmup_compile()
            outs[m] = f"{prefix}.mesh{m}." + ("2.fastq" if pass_no == 1
                                               else "fastq")
            rec.label = f"mesh{m}"
            P.correct_file(corr, dataclasses.replace(
                o, trace_json=f"{prefix}.mesh{m}.trace.jsonl"), src(m),
                outs[m], pass_no,
                trim_qual=opt.trim_qual if pass_no == 2 else 0)
            del corr
        return outs

    p1 = passes(1, cdbg, colors, lambda m: opt.filename_long_in)
    del cdbg, colors
    first = p1[sizes[0]]
    cdbg2, colors2 = P.build_pass2_index(
        opt, ((r.codes, r.qual) for r in fastx.read_many([first])), shorts,
        ids, prebuilt_cdbg=cdbg2_pre)
    passes(2, cdbg2, colors2, lambda m: [p1[m]])
    rec.dump(result, sizes=sizes)
    return 0


# ---- in the parent ---------------------------------------------------------

def read_trace(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def pass_seconds(events: list) -> dict:
    """{pass_no: (seconds, first batch's seconds)} from one process's trace
    events: pass_done's secs, and the first batch event of the pass after
    its start (pass_done's ts less its secs; the trace keeps milliseconds)."""
    out = {}
    for e in events:
        if e["ev"] != "pass_done":
            continue
        start = e["ts"] - e["secs"]
        first = min((b["ts"] for b in events if b["ev"] == "batch"
                     and b["pass_no"] == e["pass_no"]
                     and start - 1e-3 <= b["ts"] <= e["ts"]), default=None)
        out[e["pass_no"]] = (e["secs"], None if first is None
                             else round(first - start, 3))
    return out


def pass_window(per_process: list) -> dict:
    """T from each process's {pass_no: seconds}: the slowest process's pass
    1 plus the slowest process's pass 2."""
    p1 = max(p[1] for p in per_process)
    p2 = max(p[2] for p in per_process)
    return {"pass1_max_s": p1, "pass2_max_s": p2, "T_s": p1 + p2}


def scaling(rows: list, bases: int) -> list:
    """Adds bases_per_s (bases / T) and efficiency (bases/s over N times the
    bases/s at 1; None without a run at 1) to each row {n, T_s}."""
    one = next((r for r in rows if r["n"] == 1), None)
    for r in rows:
        r["bases_per_s"] = bases / r["T_s"]
    for r in rows:
        r["efficiency"] = (None if one is None else
                           r["bases_per_s"] / (r["n"] * one["bases_per_s"]))
    return rows


def handoff(rec: dict) -> dict:
    """A process's seconds from the end of its pass 1 to the start of its
    pass 2, and each recorded step's seconds inside that window."""
    p = {x["pass_no"]: x for x in rec["passes"]}
    a, b = p[1]["t1"], p[2]["t0"]
    parts = {}
    for name, t0, t1 in rec["spans"]:
        if a <= t0 and t1 <= b:
            parts[name] = parts.get(name, 0.0) + t1 - t0
    return {"seconds": b - a, "steps_s": parts}


def _process_row(rec: dict, events: list, on_card: bool, tag: str) -> dict:
    """One process's two passes from its record and its trace events;
    raises when a pass is missing or, on the card, a kernel of the path
    never launched in it."""
    secs = pass_seconds(events)
    passes = {x["pass_no"]: x for x in rec["passes"]}
    if sorted(secs) != [1, 2] or sorted(passes) != [1, 2]:
        raise AssertionError(f"{tag}: passes {sorted(secs)} in the trace, "
                             f"{sorted(passes)} recorded")
    if on_card:
        for p, x in passes.items():
            idle = [n for n in PATH_KERNELS if x["launches"][n] <= 0]
            if idle:
                raise AssertionError(f"{tag} pass {p}: {idle} never "
                                     f"launched: {x['launches']}")
    return {
        "pass_s": {p: secs[p][0] for p in (1, 2)},
        "first_batch_s": {p: secs[p][1] for p in (1, 2)},
        "timers": {p: passes[p]["timers"] for p in (1, 2)},
        "launches": {p: passes[p]["launches"] for p in (1, 2)},
        "peak_allocated_gb": {p: passes[p]["peak_allocated_gb"]
                              for p in (1, 2)},
        "peak_reserved_gb": {p: passes[p]["peak_reserved_gb"]
                             for p in (1, 2)},
        "peak_rss_gb": rec["peak_rss_gb"]}


def run_processes(cmds, cwd: str, tag: str) -> float:
    """Start every command at once, wait for all; raise with the stderr
    tail of the first that fails. Returns the wall seconds."""
    procs, logs = [], []
    t = time.time()
    try:
        for i, (cmd, env) in enumerate(cmds):
            logs.append(open(os.path.join(cwd, f"{tag}.{i}.log"), "w+"))
            procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env,
                                          stdout=logs[-1],
                                          stderr=subprocess.STDOUT))
        deadline = t + RUN_TIMEOUT
        for p in procs:
            p.wait(timeout=max(deadline - time.time(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.time() - t
    for i, (p, f) in enumerate(zip(procs, logs)):
        f.seek(0)
        text = f.read()
        f.close()
        if p.returncode != 0:
            raise AssertionError(f"{tag} process {i} exited {p.returncode}:"
                                 f"\n{text[-4000:]}")
    return wall


def scatter(n: int, data: dict, workdir: str, device: str,
            options: dict) -> dict:
    """One N-process launcher run; its row."""
    d = os.path.join(workdir, f"procs{n}")
    os.makedirs(d)
    out = os.path.join(d, "out")
    cmds = launch_commands(
        n, free_port(),
        lambda i: cli_argv(data["short_fa"], data["long_fq"], out,
                           os.path.join(d, f"trace{i}.jsonl"), **options),
        device, lambda i: os.path.join(d, f"rec{i}.json"))
    wall = run_processes(cmds, d, "proc")
    procs = []
    for i in range(n):
        with open(os.path.join(d, f"rec{i}.json")) as f:
            rec = json.load(f)
        proc = _process_row(rec, read_trace(
            os.path.join(d, f"trace{i}.jsonl")), device == "cuda",
            f"procs={n} process {i}")
        first = min(x["t0"] for x in rec["passes"])
        procs.append(dict(proc, setup_s=first - rec["t_start"],
                          handoff=handoff(rec),
                          wall_s=rec["t_end"] - rec["t_start"]))
    row = {"n": n, "wall_s": wall,
           **pass_window([p["pass_s"] for p in procs]),
           "handoff_max_s": max(p["handoff"]["seconds"] for p in procs),
           "setup_max_s": max(p["setup_s"] for p in procs),
           "sha256": {"pass1": bench_torch.sha256(out + ".2.fastq"),
                      "final": bench_torch.sha256(out + ".fastq")},
           "final_fastq": out + ".fastq", "pass1_fastq": out + ".2.fastq",
           "processes": procs}
    log(f"procs={n}: pass 1 " + " / ".join(
        f"{p['pass_s'][1]:.2f}" for p in procs) + "s, pass 2 " + " / ".join(
        f"{p['pass_s'][2]:.2f}" for p in procs) + f"s; T {row['T_s']:.2f}s; "
        f"hand-off {row['handoff_max_s']:.2f}s; wall {wall:.1f}s")
    return row


def mesh(sizes: list, data: dict, workdir: str, device: str,
         options: dict) -> list:
    """Every mesh size in one process; a row per size."""
    d = os.path.join(workdir, "mesh")
    os.makedirs(d)
    prefix = os.path.join(d, "out")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    result = os.path.join(d, "rec.json")
    argv = cli_argv(data["short_fa"], data["long_fq"], prefix, **options)
    wall = run_processes([([sys.executable, "-c",
                            _WORKER.format("mesh_worker"),
                            str(Path(__file__).resolve().parent),
                            ",".join(map(str, sizes)), device, result, "--",
                            *argv], env)], d, "mesh")
    with open(result) as f:
        rec = json.load(f)
    rows = []
    for m in sizes:
        one = dict(rec, passes=[x for x in rec["passes"]
                                if x["label"] == f"mesh{m}"])
        proc = _process_row(one, read_trace(f"{prefix}.mesh{m}.trace.jsonl"),
                            device == "cuda", f"mesh={m}")
        rows.append({"n": m, **pass_window([proc["pass_s"]]),
                     "sha256": {
                         "pass1": bench_torch.sha256(f"{prefix}.mesh{m}.2.fastq"),
                         "final": bench_torch.sha256(f"{prefix}.mesh{m}.fastq")},
                     "process": proc})
        log(f"mesh={m}: pass 1 {proc['pass_s'][1]:.2f}s, pass 2 "
            f"{proc['pass_s'][2]:.2f}s; T {rows[-1]['T_s']:.2f}s")
    log(f"mesh process: {wall:.1f}s wall")
    return rows


def smi_lines(device: str) -> list:
    """Every card's `name, power limit` from nvidia-smi; [] off the card."""
    if device != "cuda":
        return []
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()


def simulate(size_args, seed: int, workdir: str) -> dict:
    """bench_torch.py's data: the short reads as FASTA, the long reads as
    FASTQ, the first reads' truths."""
    glen, n_reads, repeat_frac, repeat_len = bench_torch.sizes(
        list(size_args))
    rng, genome, sreads = bench_torch.simulate_short(seed, glen, repeat_frac,
                                                     repeat_len)
    short_fa = os.path.join(workdir, "short.fa")
    with open(short_fa, "w") as f:
        for i, r in enumerate(sreads):
            f.write(f">S{i}\n{dna.decode(r)}\n")
    long_fq = os.path.join(workdir, "long.fq")
    truths, total = bench_torch.write_long_reads(rng, genome, n_reads,
                                                 long_fq)
    return dict(short_fa=short_fa, long_fq=long_fq, truths=truths,
                long_read_bp=total, genome_bp=glen, n_long_reads=n_reads,
                n_short_reads=len(sreads))


def prebuild(device: str) -> float:
    """The kernel library (on the card) and the native libraries, once,
    before any run: the processes then load what is built."""
    from ratatosk_tpu_torch.io import native as NF
    from ratatosk_tpu_torch.ops import cuda_lib
    from ratatosk_tpu_torch.ops import native_align as NA
    from ratatosk_tpu_torch.ops import native_kmers as NK
    t = time.time()
    if device == "cuda":
        cuda_lib.library()
    NF.available(), NK.available(), NA.available()
    return time.time() - t


def run(size_args=(), *, procs=(1, 2, 4), mesh_sizes=(1, 2, 4),
        device: str = "cuda", seed: int = 1234, workdir: str,
        **options) -> dict:
    """The scaling run; options: `correct` flags over OPTIONS (the tests'
    smaller beam and launches). Returns the result; raises when a check
    fails or a card is missing."""
    t_all = time.time()
    procs, mesh_sizes = list(procs), list(mesh_sizes)
    if any(n < 1 for n in procs + mesh_sizes):
        raise ValueError("every count must be at least 1")
    if not procs and not mesh_sizes:
        raise ValueError("nothing to run: --procs and --mesh are empty")
    check_device(device, procs, mesh_sizes)
    cards = smi_lines(device)
    cores = len(os.sched_getaffinity(0))
    log(f"{cores} usable host cores; cards: {cards or 'none (cpu)'}")
    build_s = prebuild(device)
    t = time.time()
    data = simulate(size_args, seed, workdir)
    simulate_s = time.time() - t
    log(f"simulated {data['genome_bp']} bp genome, {data['n_short_reads']} "
        f"short reads, {data['n_long_reads']} long reads "
        f"({data['long_read_bp']} bp) in {simulate_s:.1f}s")
    bases = data["long_read_bp"]
    rows = scaling([scatter(n, data, workdir, device, options)
                    for n in procs], bases)
    mrows = (scaling(mesh(mesh_sizes, data, workdir, device, options), bases)
             if mesh_sizes else [])
    shas = {json.dumps(r["sha256"], sort_keys=True) for r in rows + mrows}
    if len(shas) != 1:
        raise AssertionError(f"the runs' FASTQ differ: {shas}")
    # held to the JAX package's digests of this data and these flags (a
    # mismatch raises)
    jax_entry = digests.check(
        "cli", bench_torch.data_rule(size_args, seed), flags(**options),
        lambda: {"short.fa": digests.file_sha256(data["short_fa"]),
                 "long.fq": digests.file_sha256(data["long_fq"])},
        json.loads(next(iter(shas))))
    jax_match = None if jax_entry is None else True
    log("no JAX package digests for this data and these flags"
        if jax_entry is None else
        f"FASTQ equal to the JAX package's (entry {jax_entry})")
    final = (rows[0]["final_fastq"] if rows else
             os.path.join(workdir, "mesh", f"out.mesh{mesh_sizes[0]}.fastq"))
    p1 = final[:-len(".fastq")] + ".2.fastq"
    err = {"raw": bench_torch.residual_error(data["long_fq"], data["truths"]),
           "pass1": bench_torch.residual_error(p1, data["truths"]),
           "final": bench_torch.residual_error(final, data["truths"])}
    if not err["final"] < err["raw"] / 5:
        raise AssertionError(f"final error {err['final']:.5f} is not below a "
                             f"fifth of the raw {err['raw']:.5f}")
    for r in rows:
        r.pop("final_fastq"), r.pop("pass1_fastq")
    for kind, rs in (("procs", rows), ("mesh", mrows)):
        for r in rs:
            e = r["efficiency"]
            log(f"{kind}={r['n']}: T {r['T_s']:.3f}s, {r['bases_per_s']:.1f} "
                f"bases/s, E {'-' if e is None else f'{e:.3f}'}")
    return {
        "metric": bench_torch.METRIC, "unit": "bases/s", "device": device,
        "cards": cards, "count": (torch.cuda.device_count()
                                  if device == "cuda" else 0),
        "usable_cores": cores, "seed": seed, "genome_bp": data["genome_bp"],
        "n_long_reads": data["n_long_reads"], "long_read_bp": bases,
        "options": dict(OPTIONS, **options),
        "scatter": rows, "mesh": mrows,
        "fastq_sha256": json.loads(shas.pop()), "error": err,
        "jax_entry": jax_entry,
        "jax_match": jax_match,
        "kernel_build_s": build_s, "simulate_s": simulate_s,
        "total_wall_s": time.time() - t_all}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("size", nargs="*",
                    help="small, or <genome_bp> [n_reads] (bench.py's "
                    "rules; default: 4 Mbp, 5,000 reads)")
    ap.add_argument("--procs", default="1,2,4",
                    help="launcher runs: processes, one card each")
    ap.add_argument("--mesh", default="1,2,4",
                    help="mesh runs: cards of one process's mesh")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (tests only)")
    args = ap.parse_args(argv)
    if len(args.size) > 2 or (args.size and args.size[0] == "small"
                              and len(args.size) > 1):
        ap.error("size is `small` or <genome_bp> [n_reads]")
    procs, mesh_sizes = counts(args.procs), counts(args.mesh)
    with tempfile.TemporaryDirectory(prefix="rtpu_dist_scale_") as workdir:
        result = run(args.size, procs=procs, mesh_sizes=mesh_sizes,
                     device=args.device, seed=args.seed, workdir=workdir)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result) + "\n")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
