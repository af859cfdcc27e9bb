"""Where and how pipeline.correct_file plans a read batch: three planners,
each with `submit(batch, job, b)` and `collect(ticket, job, b, timers)`.

`planner_for` holds the whole rule. With one thread (`nb_threads`) each
batch is planned inline (`Inline`). With more, batch N+1 is planned while
the driving thread launches, finishes and writes batch N (the double
buffer): in W planner processes (`PlanPool`) where the host planner plans
on the host index (no device planner, sharded index or mesh) on a host with
more than two usable cores, else on one planner thread (`OnThread`). The
device planner and the sharded index touch CUDA while they plan, and CUDA
does not survive a fork.

Each process runs the unchanged `Planner.plan_batch` on one contiguous
slice of the reads (about equal bases each, `split`). The plan is per read
apart from the numbering of its regions, so the slices merged in read order
(`merge`) give the whole batch's plan field for field.

The pool starts once per Planner (`pools`), at the first job that takes it,
and forks every worker before it starts a thread of its own; the workers
share the Planner's pages and plan with it as it stood then. The index's
lazy tables are built first (`_prepare`), and `gc.freeze()` keeps either
side's collector from writing to, and so copying, every inherited page. A
worker never runs torch or CUDA: any CUDA call in a process forked after
CUDA's initialisation raises. W and the workers' cores follow the cores
this process may use (`worker_count`, `worker_cores`).
"""

from __future__ import annotations

import contextlib
import gc
import multiprocessing
import os
import pickle
import weakref
from concurrent import futures
from concurrent.futures.process import BrokenProcessPool
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ratatosk_tpu_torch import trace as TR

# in a worker, the Planner it plans with and the worker's index; in this
# process, the Planner only while the pool forks its workers
_planner, _proc = None, -1
# the started PlanPool of each Planner
pools = weakref.WeakKeyDictionary()


def usable_cores() -> List[int]:
    """The cores this process may run on."""
    return sorted(os.sched_getaffinity(0))


def worker_count(cores: int) -> int:
    """W, the planner processes of a host with `cores` usable cores."""
    return min(4, max(2, (cores - 1) // 2))


def worker_cores(cores: List[int]) -> List[int]:
    """The cores the workers run on: all but one, the driving thread's."""
    return cores[1:]


@contextlib.contextmanager
def planner_for(corrector, opt):
    """The planner of a correct_file job on `corrector` with `opt`, for the
    block; a Planner's processes outlive it."""
    if opt.nb_threads <= 1:
        yield Inline(corrector)
    elif (corrector.devplan is not None or corrector.sharded is not None
          or corrector.mesh is not None or len(usable_cores()) <= 2):
        with futures.ThreadPoolExecutor(max_workers=1) as ex:
            yield OnThread(corrector, ex)
    else:
        pool = pools.get(corrector.planner)
        if pool is None or pool.closed:
            cores = usable_cores()
            pool = PlanPool(corrector.planner, worker_count(len(cores)),
                            worker_cores(cores))
            pools[corrector.planner] = pool
        yield pool


def close(planner) -> None:
    """Stops `planner`'s processes, if they started."""
    if planner in pools:
        pools.pop(planner).close()


def _wait(futs, b: int, timers: dict) -> None:
    # the double buffer's wait for batch b's plan: `ahead`, futures done
    with TR.span("wait", timers) as span:
        if span:
            span.set("first", int(b == 0))
            span.set("ahead", sum(f.done() for f in futs))
        futures.wait(futs)


class Inline:
    """Plans each batch on the driving thread when it is submitted, under
    the job's span, through `corrector.plan_batch` as it stands then."""
    ahead = 0

    def __init__(self, corrector):
        self.corrector = corrector

    def submit(self, batch, job, b: int):
        reads, quals, names = batch
        with TR.within(job, b):
            return names, quals, self.corrector.plan_batch(reads, quals,
                                                           names)

    def collect(self, planned, job, b: int, timers: dict):
        return planned


class OnThread(Inline):
    """Plans each batch as Inline does, on one planner thread."""
    ahead = 1

    def __init__(self, corrector, ex):
        self.corrector, self._ex = corrector, ex

    def submit(self, batch, job, b: int):
        return self._ex.submit(super().submit, batch, job, b)

    def collect(self, fut, job, b: int, timers: dict):
        _wait([fut], b, timers)
        return fut.result()


def split(lengths: Sequence[int], w: int) -> List[Tuple[int, int]]:
    """At most `w` contiguous (lo, hi) slices of reads of these lengths,
    about equal bases each, none empty."""
    n = len(lengths)
    w = max(1, min(w, n))
    cum = np.cumsum(lengths)
    cuts = [0]
    for j in range(1, w):
        # reads [0, c) hold at least j / w of the bases; every slice keeps
        # one read
        c = int(np.searchsorted(cum, cum[-1] * j / w)) + 1
        cuts.append(min(max(c, cuts[-1] + 1), n - (w - j)))
    cuts.append(n)
    return list(zip(cuts[:-1], cuts[1:]))


def merge(parts) -> Tuple[list, list]:
    """The batch's (plans, regions) from its slices' `plan_batch` results,
    in read order: (first read, plans, regions) of each. A slice's
    ("region", i) segments and its regions' read_idx move past the slices
    before it."""
    plans, regions = [], []
    for lo, s_plans, s_regions in parts:
        off = len(regions)
        if off:
            s_plans = [[("region", seg[1] + off) if seg[0] == "region"
                        else seg for seg in segs] for segs in s_plans]
        for sp in s_regions:
            sp.read_idx += lo
        plans += s_plans
        regions += s_regions
    return plans, regions


def private_mb() -> Optional[int]:
    """This process's private memory, MB: Private_Clean + Private_Dirty of
    /proc/self/smaps_rollup, or summed over /proc/self/smaps where a kernel
    has no rollup; None where it has neither."""
    for path in ("/proc/self/smaps_rollup", "/proc/self/smaps"):
        try:
            with open(path) as f:
                kb = sum(int(line.split()[1]) for line in f
                         if line.startswith(("Private_Clean:",
                                             "Private_Dirty:")))
        except FileNotFoundError:
            continue
        return round(kb * 1024 / 1e6)
    return None


def _prepare(planner) -> None:
    """Builds the lazy tables of the index that the host planner reads, so
    that the forked workers share them."""
    from ratatosk_tpu_torch.correct import seeds
    from ratatosk_tpu_torch.ops import native_kmers as NK
    index = planner.cdbg.index
    native = NK.available()
    if native:
        NK.hash_dir(index)
    if planner.opt.use_weak_seeds:
        seeds._probe_prefilter(index)
        if native:
            seeds._half_filter(index)


def _start_worker(counter, cores: List[int]) -> None:
    global _proc
    with counter.get_lock():   # the worker's index among the workers
        _proc = counter.value
        counter.value += 1
    TR._active = None   # a recording open at the fork is the parent's
    if cores:
        os.sched_setaffinity(0, cores)


def _plan_slice(reads, quals, names, s: int, traced: bool) -> bytes:
    """In a worker: slice `s` of a batch, planned; pickled here so that the
    driving thread, not the pool's thread, unpickles it."""
    timers = {"plan": 0.0}
    rows = None
    with TR.recording() if traced else contextlib.nullcontext() as rec:
        _, plans, regions = _planner.plan_batch(reads, quals, names, timers)
    if traced:
        rows = [sp.as_dict() for sp in rec.spans]
        plan = next(r for r in rows if r["name"] == "plan")
        plan.update(proc=_proc, slice=s)
        priv = private_mb()
        if priv is not None:
            plan["priv_mb"] = priv
    return pickle.dumps((plans, regions, timers["plan"], rows),
                        pickle.HIGHEST_PROTOCOL)


def _shutdown(executor) -> None:
    executor.shutdown(wait=True, cancel_futures=True)
    gc.unfreeze()


class PlanPool:
    """W planner processes forked from this one, each with its copy of one
    Planner; closed with it (`close`, or when it is collected)."""
    ahead = 1

    def __init__(self, planner, workers: int, cores: List[int]):
        global _planner
        _prepare(planner)
        ctx = multiprocessing.get_context("fork")
        gc.collect()
        gc.freeze()
        _planner = planner
        ex = None
        try:
            ex = futures.ProcessPoolExecutor(
                workers, mp_context=ctx, initializer=_start_worker,
                initargs=(ctx.Value("i", 0), cores))
            # the first task forks every worker, before the pool's thread
            ex.submit(int).result()
        except BaseException:
            if ex is not None:
                ex.shutdown(wait=True, cancel_futures=True)
            gc.unfreeze()
            raise
        finally:
            _planner = None
        self.workers = workers
        # close() stops the workers, waiting for the slices they plan
        self.close = weakref.finalize(planner, _shutdown, ex)
        self._ex = ex

    @property
    def closed(self) -> bool:
        return not self.close.alive

    def submit(self, batch, job, b: int):
        """Batch b, (reads, quals: None or one per read, names), in slices
        to the workers, which record their spans where `job` records: the
        ticket (batch, slices, their futures)."""
        reads, quals, names = batch
        bounds = split([len(r) for r in reads], self.workers)
        try:
            futs = [self._ex.submit(
                _plan_slice, reads[lo:hi],
                None if quals is None else quals[lo:hi], names[lo:hi], s,
                bool(job)) for s, (lo, hi) in enumerate(bounds)]
        except BrokenProcessPool:
            self.close()
            raise
        return batch, bounds, futs

    def collect(self, ticket, job, batch: int, timers: dict):
        """On the driving thread, after the wait for the slices, inside a
        `plan.merge` span: the batch's (names, quals, (reads_np, plans,
        regions)), as the in-process plan gives it. Adds the slices'
        planner seconds to timers["plan"] and their spans to `job`'s tree
        at `batch`; raises what a slice raised. A worker that died breaks
        the pool, which closes."""
        (reads, quals, names), bounds, futs = ticket
        _wait(futs, batch, timers)
        with TR.span("plan.merge"):
            parts = []
            # unpickling makes thousands of objects, and the collector
            # would walk them again and again
            gc_on = gc.isenabled()
            gc.disable()
            try:
                for (lo, _), fut in zip(bounds, futs):
                    plans, regions, plan_s, rows = pickle.loads(fut.result())
                    timers["plan"] += plan_s
                    TR.adopt(rows, job, batch)
                    parts.append((lo, plans, regions))
            except BrokenProcessPool:
                self.close()
                raise
            finally:
                if gc_on:
                    gc.enable()
            plans, regions = merge(parts)
            reads_np = [np.asarray(r, dtype=np.uint8) for r in reads]
        return names, quals, (reads_np, plans, regions)
