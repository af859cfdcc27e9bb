"""Tracing: spans of each correction job, kept in memory, and the JSONL
event stream of `--trace-json PATH` (CorrectOpt.trace_json).

Spans. `span(name)` opens one at a layer boundary of the correction job
(pipeline.correct_file, correct/plan_pool.py, correct/planner.py and
correct/engine.py). A span records its name, its
id and its parent's, the (job, batch) pair it belongs to, the thread, its
start and end from `time.time_ns()` and the thread's CPU nanoseconds over
it (`time.thread_time_ns()`), and, where a reader needs one, an integer
field. The clock is CLOCK_REALTIME, the clock of torch.profiler's
`trace_start_ns`, to which every profiler event's `time_range` is relative,
so the spans go onto the profiler's time line without a fitted offset. The
parent is the innermost span or `within` frame open on the calling thread;
a thread that works for another (the planner thread of the double buffer)
is handed its parent explicitly with `within(parent, batch)`. A `job` span
roots a job: its id is the job of every span under it.

Nothing records unless `recording()` is open or a pass runs with
`--trace-json`. Then `span()` returns the shared no-op NOOP, which reads no
clock and allocates nothing; a span given the Corrector's `timers` still
reads the clock twice and adds the seconds to `timers[name]`, as it does
when recording, so each boundary is clocked once.

Events. One line per event: {"ts": epoch_s, "ev": name, ...fields}, `ts`
the time the event happened. A pass with `--trace-json` writes the events
and spans of its finished batches every pipeline.TRACE_EVERY batches, and
the rest at its end or when it raises; the spans written leave the
recorder. The other events are written when they happen.

Event vocabulary (stable keys, additive only):
  graph_build   {pass_no, k, unitigs, kmers, secs}
  batch         {pass_no, batch, reads, bases, regions, plan_s, launch_s,
                 finish_s[, devplan_fallbacks]}: that batch's own seconds,
                 from its spans
  pass_done     {pass_no, reads, bases, secs}
  rescue        {edges, secs}
  snp           {sites, secs}
  span          {name, id, parent, job, batch, thread, t0_ns, t1_ns, cpu_ns
                 [, first, ahead | batched | maxq_bp, proc, slice[, priv_mb]]}:
                 each span of the pass's job; `first` on the double buffer's
                 `wait` spans, 1 for a job's batch 0, and `ahead`, the
                 batch's plan slices already done when the wait opened;
                 `batched` on the planner's `plan.runs` spans, 1 when the
                 batch's exact runs were found in one pass over the batch
                 (correct/runs_batch.py), 0 when read by read; on `plan`
                 spans `maxq_bp`, the bases of the plan's reads that the
                 pass-2 max-quality skip left raw, `proc`, the planner
                 process's index (-1: planned in this process), `slice`, the
                 slice of the batch it planned, and, from a planner process,
                 `priv_mb`, that process's private memory after the plan (MB)

A plan made in a planner process (correct/plan_pool.py) is recorded there
and handed back with its result; `adopt` puts its spans under the job's
span, with ids of this recorder and the planner process's pid as their
thread.

The pass-2 index build (pipeline.build_pass2_index) is a span tree of its
own, outside any job: `index` {k, reads, short, masked} over its children
`index.graph` and `index.colour`. It is kept by `recording()` only; no
event writes it.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from typing import Dict, List, Optional


class _Noop:
    """The span when nothing records: one shared context, falsy, that reads
    no clock."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, key: str, value: int) -> None:
        pass


NOOP = _Noop()


class _Clock(_Noop):
    """A timer's boundary when nothing records: its two clock readings feed
    timers[key]."""
    __slots__ = ("timers", "key", "t0")

    def __init__(self, timers: dict, key: str):
        self.timers, self.key = timers, key

    def __enter__(self):
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.timers[self.key] += (time.time_ns() - self.t0) / 1e9
        return False


class Span:
    __slots__ = ("name", "id", "parent", "job", "batch", "thread", "t0",
                 "t1", "cpu", "fields", "_rec", "_timers")

    def __init__(self, rec: "Recorder", name: str, timers: Optional[dict],
                 batch: Optional[int]):
        self._rec, self.name, self._timers = rec, name, timers
        self.id = next(rec._ids)
        self.batch = batch
        self.fields = None

    def __enter__(self):
        stack = self._rec._stack()
        top = stack[-1] if stack else None
        self.parent = top.id if top is not None else None
        self.job = self.id if self.name == "job" else (
            top.job if top is not None else None)
        if self.batch is None and top is not None:
            self.batch = top.batch
        self.thread = threading.get_native_id()
        stack.append(self)
        # the wall clock brackets the thread's CPU clock
        self.t0 = time.time_ns()
        self.cpu = time.thread_time_ns()
        return self

    def __exit__(self, *exc):
        self.cpu = time.thread_time_ns() - self.cpu
        self.t1 = time.time_ns()
        self._rec._stack().pop()
        self._rec._add(self)
        if self._timers is not None:
            self._timers[self.name] += (self.t1 - self.t0) / 1e9
        return False

    def set(self, key: str, value: int) -> None:
        if self.fields is None:
            self.fields = {}
        self.fields[key] = value

    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def as_dict(self) -> dict:
        d = {"name": self.name, "id": self.id, "parent": self.parent,
             "job": self.job, "batch": self.batch, "thread": self.thread,
             "t0_ns": self.t0, "t1_ns": self.t1, "cpu_ns": self.cpu}
        if self.fields:
            d.update(self.fields)
        return d


class _Within:
    """A frame that makes `parent`'s span, at `batch`, the parent of the
    spans opened on this thread until it closes."""
    __slots__ = ("id", "job", "batch", "_rec")

    def __init__(self, rec: "Recorder", parent: Span, batch: int):
        self._rec, self.id, self.job, self.batch = (rec, parent.id,
                                                    parent.job, batch)

    def __enter__(self):
        self._rec._stack().append(self)
        return self

    def __exit__(self, *exc):
        self._rec._stack().pop()
        return False


class Recorder:
    """The spans closed while it records, in the order they closed."""

    def __init__(self):
        self.spans: List[Span] = []
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _add(self, span: Span) -> None:
        with self._lock:
            self.spans.append(span)

    def take(self, job: int, lo: int = 0, hi: Optional[int] = None
             ) -> List[Span]:
        """Removes and returns the spans of `job` whose batch is in
        [lo, hi); with hi None, from lo on and those of no batch."""
        def out(s):
            if s.job != job:
                return False
            if s.batch is None:
                return hi is None
            return s.batch >= lo and (hi is None or s.batch < hi)
        with self._lock:
            taken = [s for s in self.spans if out(s)]
            self.spans = [s for s in self.spans if not out(s)]
        return taken


_active: Optional[Recorder] = None


def span(name: str, timers: Optional[dict] = None,
         batch: Optional[int] = None):
    """A span named `name` (a context; `set(key, value)` adds a field). With
    `timers`, its seconds also add to timers[name], recording or not.
    `batch` sets its batch where the parent's is not it."""
    rec = _active
    if rec is None:
        return NOOP if timers is None else _Clock(timers, name)
    return Span(rec, name, timers, batch)


def within(parent, batch: int):
    """A context in which `parent` (a span, or NOOP) at `batch` is the
    parent of the spans this thread opens: how a thread that works for
    another is handed its parent."""
    rec = _active
    if rec is None or not parent:
        return NOOP
    return _Within(rec, parent, batch)


@contextlib.contextmanager
def recording():
    """Records spans until the block ends; yields the Recorder. Inside an
    open recording it yields that one, which goes on recording after."""
    global _active
    if _active is not None:
        yield _active
        return
    _active = Recorder()
    try:
        yield _active
    finally:
        _active = None


def adopt(rows, parent, batch: int) -> None:
    """Adds spans recorded elsewhere (`Span.as_dict` rows, children before
    their parents, as a recorder closes them) to the open recording: new
    ids, the rows' roots under `parent` (a span, or NOOP) at `batch`."""
    rec = _active
    if rec is None or not parent or not rows:
        return
    ids = {r["id"]: next(rec._ids) for r in rows}
    for r in rows:
        sp = Span.__new__(Span)
        sp._rec, sp._timers = rec, None
        sp.name, sp.thread = r["name"], r["thread"]
        sp.t0, sp.t1, sp.cpu = r["t0_ns"], r["t1_ns"], r["cpu_ns"]
        sp.id = ids[r["id"]]
        sp.parent = ids.get(r["parent"], parent.id)
        sp.job, sp.batch = parent.job, batch
        sp.fields = {k: v for k, v in r.items() if k not in _ROW_KEYS} or None
        rec._add(sp)


_ROW_KEYS = frozenset(("name", "id", "parent", "job", "batch", "thread",
                       "t0_ns", "t1_ns", "cpu_ns"))


def seconds_by_batch(spans, names) -> Dict[int, Dict[str, float]]:
    """{batch: {name: seconds}} over the spans named in `names`."""
    out: Dict[int, Dict[str, float]] = {}
    for s in spans:
        if s.name in names:
            per = out.setdefault(s.batch, {})
            per[s.name] = per.get(s.name, 0.0) + s.seconds()
    return out


def record(ev: str, ts: Optional[float] = None, **fields) -> dict:
    """One event: {"ts", "ev", ...fields}, ts now unless given."""
    rec = {"ts": round(time.time() if ts is None else ts, 3), "ev": ev}
    rec.update(fields)
    return rec


class Tracer:
    """The JSONL writer of one path: appends events to the file, one line
    each, in one write a call."""

    def __init__(self, path: Optional[str]):
        self.path = path

    def event(self, ev: str, **fields) -> None:
        self.write([record(ev, **fields)])

    def write(self, records: list) -> None:
        if self.path is None or not records:
            return
        with open(self.path, "a") as f:
            f.write("".join(json.dumps(r) + "\n" for r in records))


NULL = Tracer(None)
_writers: Dict[str, Tracer] = {}


def make(path: Optional[str]) -> Tracer:
    """The writer of `path` (one per path in a process), or NULL."""
    if not path:
        return NULL
    return _writers.setdefault(path, Tracer(path))
