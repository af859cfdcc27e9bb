"""What the traced run reads: the device's busy time and kernel times from
torch.profiler, host spans the benchmark records around the program's calls
(torch.profiler.record_function), and each launch of the port's beam and
finish kernels with the inputs that size its work.

The spans and the launch capture are the benchmark's own, installed on the
Corrector and on the engine module for the traced run only and removed
after it; the program carries no spans of its own yet. The profiler records
only the spans of the thread that drives the card; the planner thread's
come from the host clock, put on the profiler's time line by the offset
between the two records of the driving thread's spans.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import threading
import time

import torch

# CUDA kernels of the port's main path, by a part of their names
BEAM_KERNEL = "beam_kernel"
FINISH_KERNEL = "finish_kernel"
# host spans on the thread that drives the card, in the order a batch meets
# them: the launch and read-back of its regions, then its assembly; and the
# planner thread's span
MAIN_SPANS = ("execute_regions", "assemble_batch")
PLAN_SPAN = "plan_batch"


@dataclasses.dataclass
class Launch:
    """One engine launch (two beam-kernel launches and one finish-kernel
    launch), with what sizes its work."""
    nt: int
    n_real: int
    lmax: int
    band: int
    tgt_len: torch.Tensor
    scalars: torch.Tensor
    beam_args: dict = None   # g, rb and the beam options: first of a bucket


@dataclasses.dataclass
class Capture:
    launches: list   # [Launch]
    clock: list      # [(span name, start us, end us)] on the host clock


@contextlib.contextmanager
def capture(corr, engine_module):
    """Records every launch of `corr` and wraps its plan / execute /
    assemble calls in named spans, on the profiler and on the host clock,
    until the block ends. Yields the Capture."""
    launches, clock = [], []
    seen = set()
    state = threading.local()
    orig_launch = corr._launch_bucket
    orig_finish = engine_module._beam_finish

    def launch_bucket(specs, nt, mirrored, beam=None, pool=None):
        state.n_real = len(specs)
        return orig_launch(specs, nt, mirrored, beam=beam, pool=pool)

    def beam_finish(g, rb, qv_max, min_k, **kw):
        fin = orig_finish(g, rb, qv_max, min_k, **kw)
        nt = rb.tgt_masks.shape[1]
        rec = Launch(nt=nt, n_real=state.n_real, lmax=kw["lmax"],
                     band=kw["band"], tgt_len=rb.tgt_len,
                     scalars=fin.scalars)
        if nt not in seen:
            seen.add(nt)
            rec.beam_args = dict(g=g, rb=rb, beam=kw["beam"],
                                 lmax=kw["lmax"], band=kw["band"],
                                 min_cov=kw["min_cov"])
        launches.append(rec)
        return fin

    def spanned(name, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(name):
                    return fn(*a, **kw)
            finally:
                clock.append((name, t0 * 1e6, time.perf_counter() * 1e6))
        return call

    corr._launch_bucket = launch_bucket
    engine_module._beam_finish = beam_finish
    corr.plan_batch = spanned("plan_batch", corr.plan_batch)
    corr._execute_regions = spanned("execute_regions",
                                    corr._execute_regions)
    corr.assemble_batch = spanned("assemble_batch", corr.assemble_batch)
    try:
        yield Capture(launches, clock)
    finally:
        engine_module._beam_finish = orig_finish
        for name in ("_launch_bucket", "plan_batch", "_execute_regions",
                     "assemble_batch"):
            del corr.__dict__[name]


def union_s(spans) -> float:
    """Seconds covered by the union of (start_us, end_us) intervals."""
    busy, hi = 0.0, None
    for a, b in sorted(spans):
        if hi is None or a > hi:
            busy += b - a
            hi = b
        elif b > hi:
            busy += b - hi
            hi = b
    return busy / 1e6


def _on_profile(clock: list, host: list) -> list:
    """The host clock's planner spans on the profiler's time line: shifted
    by the median offset between the k-th record of each driving-thread span
    on the profiler (`host`) and on the host clock."""
    offsets = []
    for name in MAIN_SPANS:
        prof_k = sorted(a for a, _, n in host if n == name)
        clock_k = sorted(a for n, a, _ in clock if n == name)
        if len(prof_k) == len(clock_k):
            offsets += [p - c for p, c in zip(prof_k, clock_k)]
    if not offsets:
        return []
    off = statistics.median(offsets)
    return [(a + off, b + off, n) for n, a, b in clock if n == PLAN_SPAN]


def read_profile(prof, clock: list) -> dict:
    """From a torch.profiler run: the device ops' intervals and their busy
    union (bench_torch.device_busy's reckoning), device seconds by op name,
    the beam and finish kernels' intervals in launch order, and the idle
    gaps between device ops, each named by the benchmark's span that the
    thread driving the card was in at the gap's middle, or, where it was in
    none, "wait:plan_batch" while the planner thread planned ("other":
    reading input or writing output). Only that thread enters MAIN_SPANS.
    The spans' own marks on the device timeline are no device work."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.events():
        r = (e.time_range.start, e.time_range.end, e.name)
        if e.name in MAIN_SPANS:
            if e.device_type != DeviceType.CUDA:
                host.append(r)
        elif e.device_type == DeviceType.CUDA:
            dev.append(r)
    plan = _on_profile(clock, host)
    dev.sort()
    by_name = {}
    for a, b, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
    gaps, hi = [], None
    for a, b, _ in dev:
        if hi is not None and a > hi:
            gaps.append((hi, a))
        hi = b if hi is None else max(hi, b)

    def span_at(t):
        for a, b, n in host:
            if a <= t <= b:
                return n
        for a, b, _ in plan:
            if a <= t <= b:
                return "wait:" + PLAN_SPAN
        return "other"

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    idle = [[span_at((a + b) / 2), (b - a) / 1e6] for a, b in longest]
    return {
        "device_ops": len(dev),
        "busy_s": union_s([(a, b) for a, b, _ in dev]),
        "by_name": by_name,
        "beam": [(a, b) for a, b, n in dev if BEAM_KERNEL in n],
        "finish": [(a, b) for a, b, n in dev if FINISH_KERNEL in n],
        "idle_gaps": idle,
    }
