"""Structured tracing/metrics: JSONL event stream for the pipeline.

The reference reports progress as free-text stderr prints behind `-v`
(Ratatosk.cpp passim); production runs need machine-readable telemetry. One
line per event: {"ts": epoch_s, "ev": name, ...fields}. Enabled by
`--trace-json PATH` (CorrectOpt.trace_json); zero overhead when off.

Event vocabulary (stable keys, additive only):
  graph_build   {pass, k, unitigs, kmers, secs}
  batch         {pass, reads, bases, regions, plan_s, launch_s, finish_s}
  pass_done     {pass, reads, bases, secs}
  rescue        {edges}
  snp           {sites}
"""

from __future__ import annotations

import json
import time
from typing import Optional


class Tracer:
    def __init__(self, path: Optional[str]):
        self._f = open(path, "a") if path else None

    def event(self, ev: str, **fields) -> None:
        if self._f is None:
            return
        rec = {"ts": round(time.time(), 3), "ev": ev}
        rec.update(fields)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


NULL = Tracer(None)


def make(path: Optional[str]) -> Tracer:
    return Tracer(path) if path else NULL
