"""Planner processes: the double buffer's plan of a read batch, in slices.

pipeline.correct_file plans read batch N+1 while its driving thread
launches, finishes and writes batch N. On this module's path, W planner
processes plan the batch, each running the unchanged `Corrector.plan_batch`
on one contiguous slice of its reads (about equal bases each, `split`), and
the driving thread merges the slices in read order (`merge`). `plan_batch`
is per read apart from the numbering of its regions: the exact runs, the
probe's spans, `_plan_read` and the splices each take one read at a time.
So the merge, which moves each slice's region and read indices past the
slices before it, gives the whole batch's plan field for field, and the
launches are composed as before. The double buffer keeps its depth: one
batch planned ahead.

Who takes the pool (`wanted`): a job of more than one thread
(`nb_threads`) planned by the host planner on the host index (no device
planner, no sharded index, no mesh) on a host with more than two usable
cores. The device planner and the sharded index touch CUDA while they plan,
and CUDA does not survive a fork, so they plan on a thread of this process;
one thread plans inline.

Fork. A worker needs the Corrector's graph, colours and index; forked from
this process it shares their pages instead of holding a copy. The pool
starts once per Corrector, at the first correct_file that takes it, and
forks every worker before the pool starts a thread of its own. The index's
lazy tables are built first (`_prepare`), so that the workers share them,
and `gc.freeze()` keeps the collector of either side from writing into
every inherited object (each write copies a page). A worker runs Python,
numpy and the port's native libraries, which start their threads per call;
never torch or CUDA. torch marks a process forked after CUDA's
initialisation, and any CUDA call there raises. The workers plan with the
Corrector as it stood when they started.

Cores: W and the cores the workers run on follow the cores this process
may use (`worker_count`, `worker_cores`); the driving thread keeps one.
"""

from __future__ import annotations

import gc
import multiprocessing
import os
import pickle
import weakref
from concurrent.futures import ProcessPoolExecutor
from concurrent.futures.process import BrokenProcessPool
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ratatosk_tpu_torch import trace as TR

# in a worker, the Corrector it plans with; in this process, the Corrector
# only while the pool forks its workers
_corrector = None


def usable_cores() -> List[int]:
    """The cores this process may run on."""
    return sorted(os.sched_getaffinity(0))


def worker_count(cores: int) -> int:
    """W, the planner processes of a host with `cores` usable cores."""
    return min(4, max(2, (cores - 1) // 2))


def worker_cores(cores: List[int]) -> List[int]:
    """The cores the workers run on: all but one, the driving thread's."""
    return cores[1:]


def wanted(corrector, opt) -> bool:
    """Whether correct_file plans `corrector`'s batches in planner
    processes."""
    return (opt.nb_threads > 1 and corrector.devplan is None
            and corrector.sharded is None and corrector.mesh is None
            and len(usable_cores()) > 2)


def pool_for(corrector, opt) -> Optional["PlanPool"]:
    """`corrector`'s planner processes, started at the first call that
    takes them; None where it plans in this process."""
    if not wanted(corrector, opt):
        return None
    pool = corrector.plan_pool
    if pool is None or pool.closed:
        cores = usable_cores()
        pool = PlanPool(corrector, worker_count(len(cores)),
                        worker_cores(cores))
        corrector.plan_pool = pool
    return pool


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


def _prepare(corrector) -> None:
    """Builds the lazy tables of the index that the host planner reads, so
    that the forked workers share them."""
    from ratatosk_tpu_torch.correct import seeds
    from ratatosk_tpu_torch.ops import native_kmers as NK
    index = corrector.cdbg.index
    native = NK.available()
    if native:
        NK.hash_dir(index)
    if corrector.opt.use_weak_seeds:
        seeds._probe_prefilter(index)
        if native:
            seeds._half_filter(index)


def _start_worker(counter, cores: List[int]) -> None:
    with counter.get_lock():   # the worker's index among the workers
        _corrector.plan_proc = counter.value
        counter.value += 1
    TR._active = None   # a recording open at the fork is the parent's
    if cores:
        os.sched_setaffinity(0, cores)


def _plan_slice(reads, quals, names, s: int, traced: bool) -> bytes:
    """In a worker: slice `s` of a batch, planned; pickled here so that the
    driving thread, not the pool's thread, unpickles it."""
    corr = _corrector
    corr.plan_slice = s
    corr.timers = dict.fromkeys(corr.timers, 0.0)
    rows = None
    if traced:
        with TR.recording() as rec:
            _, plans, regions = corr.plan_batch(reads, quals, names)
        rows = [sp.as_dict() for sp in rec.spans]
        priv = private_mb()
        if priv is not None:
            next(r for r in rows if r["name"] == "plan")["priv_mb"] = priv
    else:
        _, plans, regions = corr.plan_batch(reads, quals, names)
    return pickle.dumps((plans, regions, corr.timers["plan"], rows),
                        pickle.HIGHEST_PROTOCOL)


def _shutdown(executor) -> None:
    executor.shutdown(wait=True, cancel_futures=True)
    gc.unfreeze()


class Ticket(NamedTuple):
    """A batch submitted to the pool: its reads and its slices' futures."""
    reads: list
    quals: Optional[list]
    names: list
    bounds: List[Tuple[int, int]]
    futures: list


class PlanPool:
    """W planner processes forked from this one, each with its copy of one
    Corrector; closed with it (Corrector.close, or when it is collected)."""

    def __init__(self, corrector, workers: int, cores: List[int]):
        global _corrector
        _prepare(corrector)
        ctx = multiprocessing.get_context("fork")
        gc.collect()
        gc.freeze()
        _corrector = corrector
        ex = None
        try:
            ex = ProcessPoolExecutor(workers, mp_context=ctx,
                                     initializer=_start_worker,
                                     initargs=(ctx.Value("i", 0), cores))
            # the first task forks every worker, before the pool's thread
            ex.submit(int).result()
        except BaseException:
            if ex is not None:
                ex.shutdown(wait=True, cancel_futures=True)
            gc.unfreeze()
            raise
        finally:
            _corrector = None
        self.workers = workers
        self._close = weakref.finalize(corrector, _shutdown, ex)
        self._ex = ex

    @property
    def closed(self) -> bool:
        return not self._close.alive

    def close(self) -> None:
        """Stops the workers (waiting for the slices they are planning)."""
        self._close()

    def submit(self, reads, quals, names, traced: bool) -> Ticket:
        """Batch `reads` (with `quals`, None or one per read, and `names`)
        in slices to the workers; `traced` records their spans."""
        bounds = split([len(r) for r in reads], self.workers)
        try:
            futs = [self._ex.submit(
                _plan_slice, reads[lo:hi],
                None if quals is None else quals[lo:hi], names[lo:hi], s,
                traced) for s, (lo, hi) in enumerate(bounds)]
        except BrokenProcessPool:
            self.close()
            raise
        return Ticket(reads, quals, names, bounds, futs)

    def collect(self, ticket: Ticket, job, batch: int, timers: dict):
        """On the driving thread, inside a `plan.merge` span: the batch's
        (names, quals, (reads_np, plans, regions)), as the in-process plan
        gives it. Adds the slices' planner seconds to timers["plan"] and
        their spans to `job`'s tree at `batch`; raises what a slice raised.
        A worker that died breaks the pool, which closes."""
        with TR.span("plan.merge"):
            parts = []
            # unpickling makes thousands of objects, and the collector
            # would walk them again and again
            gc_on = gc.isenabled()
            gc.disable()
            try:
                for (lo, _), fut in zip(ticket.bounds, ticket.futures):
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
            reads_np = [np.asarray(r, dtype=np.uint8) for r in ticket.reads]
        return ticket.names, ticket.quals, (reads_np, plans, regions)
