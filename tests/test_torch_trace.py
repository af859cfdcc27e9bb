"""The port's spans and JSONL events (ratatosk_tpu_torch/trace.py) on a small
correction job on the CPU: the recorder off costs nothing and records
nothing, on it gives one span tree per job across the planner and driving
threads, its spans feed Corrector.timers, its clock is the profiler's, the
output does not move, and --trace-json writes the events and the spans."""

from __future__ import annotations

import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

from ratatosk_tpu_torch import dna, pipeline
from ratatosk_tpu_torch import testing as T
from ratatosk_tpu_torch import trace as TR
from ratatosk_tpu_torch.config import CorrectOpt
from ratatosk_tpu_torch.correct.engine import Corrector

# children of a job on the thread that drives it, of a plan on the planner's
DRIVING = {"read", "wait", "launch", "finish", "assemble", "write"}
PLAN_PARTS = ("plan.runs", "plan.probe", "plan.waypoints", "plan.reads",
              "plan.splices")
TIMED = ("plan", "launch", "finish", "wait")


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """A pass-1 Corrector on a 12 kbp genome and four ~2 kbp long reads,
    one read a batch (read_batch_bp 1,500)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("torch_trace")
    rng = np.random.default_rng(1717)
    genome = T.random_genome(rng, 12000)
    sreads = T.short_reads(rng, genome, coverage=30.0, read_len=100)
    lr = tmp / "long.fq"
    with open(lr, "w") as f:
        for i, (noisy, _, _) in enumerate(T.long_reads(
                rng, genome, n=4, min_len=1800, max_len=2200, err=0.12)):
            f.write(f"@lr{i}\n{dna.decode(noisy)}\n+\n{'!' * len(noisy)}\n")
    opt = CorrectOpt(small_k=17, k=31, beam_width=8, batch_regions=32,
                     read_batch_bp=1500, nb_threads=1,
                     weak_seed_min_gap=80)
    o1 = pipeline._pass_opt(opt, 1)
    cdbg, colors = pipeline.build_pass1_index(o1, sreads,
                                              list(range(len(sreads))))
    corr = Corrector(cdbg, colors, o1, device="cpu")
    yield corr, o1, str(lr), tmp
    torch.set_num_threads(n)


def run(job, threads: int, out: str, **opt_kw):
    corr, opt, lr, tmp = job
    o = dataclasses.replace(opt, nb_threads=threads, **opt_kw)
    corr.timers = dict.fromkeys(corr.timers, 0.0)
    path = str(tmp / out)
    pipeline.correct_file(corr, o, [lr], path, 1)
    with open(path, "rb") as f:
        return f.read()


def recorded(job, threads: int, out: str):
    with TR.recording() as rec:
        data = run(job, threads, out)
    return rec.spans, data


def test_off_is_the_shared_noop_and_timers_still_add():
    assert TR._active is None
    sp = TR.span("plan.reads")
    assert sp is TR.NOOP and not sp
    with sp as inner:
        inner.set("regions", 3)
    assert TR.within(sp, 0) is TR.NOOP
    timers = {"plan": 0.0}
    with TR.span("plan", timers) as t:
        time.sleep(0.002)
    assert not t and timers["plan"] >= 0.002
    with TR.recording() as rec:
        pass
    assert rec.spans == [] and TR._active is None


def _tree(spans):
    by_id = {s.id: s for s in spans}
    jobs = [s for s in spans if s.name == "job"]
    assert len(jobs) == 1
    root = jobs[0]
    assert root.parent is None and root.job == root.id
    for s in spans:
        assert s.job == root.id, s.name
        assert root.t0 <= s.t0 <= s.t1 <= root.t1, s.name
        assert s.cpu >= 0
        # the one field: a wait's `first`
        assert s.fields is None or (s.name == "wait"
                                    and set(s.fields) == {"first"}), s.name
        if s is root:
            continue
        parent = by_id[s.parent]
        assert s.batch is not None, s.name
        if s.name in PLAN_PARTS:
            assert parent.name == "plan" and s.thread == parent.thread
            assert s.batch == parent.batch
        else:
            assert parent is root, s.name
    return root


def test_tree_with_one_thread(job):
    spans, _ = recorded(job, 1, "one.fq")
    root = _tree(spans)
    names = {s.name for s in spans}
    assert names >= {"job", "read", "plan", "launch", "finish", "assemble",
                     "write", *PLAN_PARTS}
    assert "wait" not in names
    assert {s.thread for s in spans} == {root.thread}
    plans = [s for s in spans if s.name == "plan"]
    assert sorted(s.batch for s in plans) == [0, 1, 2, 3]
    for p in plans:
        assert {s.name for s in spans if s.parent == p.id} == set(PLAN_PARTS)
    # a read span a batch, and the last one, which finds the input's end
    reads = sorted(s.batch for s in spans if s.name == "read")
    assert reads == [0, 1, 2, 3, 4]
    for s in spans:
        if s.name in DRIVING or s.name == "plan":
            assert s.parent == root.id and s.batch in range(5), s.name


def test_tree_with_two_threads(job):
    spans, _ = recorded(job, 2, "two.fq")
    root = _tree(spans)
    plans = [s for s in spans if s.name == "plan"]
    assert {s.thread for s in plans} != {root.thread}
    assert all(s.thread != root.thread for s in plans)
    assert all(s.parent == root.id for s in plans)
    waits = [s for s in spans if s.name == "wait"]
    assert sorted(s.batch for s in waits) == [0, 1, 2, 3]
    assert [s.batch for s in waits if s.fields["first"]] == [0]
    for s in spans:
        if s.name in DRIVING:
            assert s.thread == root.thread, s.name
    # the (job, batch) pairs of the planner thread are the driving thread's
    assert {(s.job, s.batch) for s in plans} == \
        {(s.job, s.batch) for s in waits}


@pytest.mark.parametrize("threads", [1, 2])
def test_span_sums_are_the_timers(job, threads):
    spans, _ = recorded(job, threads, f"sums{threads}.fq")
    timers = job[0].timers
    for name in TIMED:
        got = sum(s.seconds() for s in spans if s.name == name)
        assert got == pytest.approx(timers[name], rel=1e-9, abs=1e-12), name
    plan = sum(s.seconds() for s in spans if s.name == "plan")
    parts = sum(s.seconds() for s in spans if s.name in PLAN_PARTS)
    assert parts <= plan and parts >= 0.9 * plan


def test_clock_is_the_profilers():
    from torch.profiler import ProfilerActivity, profile
    with TR.recording() as rec, \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        with TR.span("job"):
            with TR.span("read", batch=0):
                with torch.profiler.record_function("inside"):
                    time.sleep(0.02)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    ev = [e for e in prof.events() if e.name == "inside"]
    assert len(ev) == 1
    a = start_ns + ev[0].time_range.start * 1000
    b = start_ns + ev[0].time_range.end * 1000
    read = next(s for s in rec.spans if s.name == "read")
    assert read.t0 - 2e6 <= a and b <= read.t1 + 2e6
    assert abs(a - read.t0) < 2e6 and abs(read.t1 - b) < 2e6


@pytest.mark.parametrize("threads", [1, 2])
def test_output_is_the_same_recorded_or_not(job, threads):
    off = run(job, threads, f"off{threads}.fq")
    _, on = recorded(job, threads, f"on{threads}.fq")
    assert off and on == off


def test_trace_json_holds_the_events_and_spans(job):
    corr, opt, lr, tmp = job
    path = str(tmp / "trace.jsonl")
    run(job, 2, "json.fq", trace_json=path)
    assert TR._active is None
    evs = [json.loads(line) for line in open(path)]
    assert all("ts" in e and "ev" in e for e in evs)
    batches = [e for e in evs if e["ev"] == "batch"]
    done = [e for e in evs if e["ev"] == "pass_done"]
    spans = [e for e in evs if e["ev"] == "span"]
    assert [b["batch"] for b in batches] == [0, 1, 2, 3]
    assert len(done) == 1 and done[0]["pass_no"] == 1
    assert done[0]["reads"] == 4 == sum(b["reads"] for b in batches)
    assert done[0]["bases"] == sum(b["bases"] for b in batches)
    for b in batches:
        assert b["pass_no"] == 1 and b["regions"] >= 0
        assert b["ts"] <= done[0]["ts"]
        own = {n: sum((s["t1_ns"] - s["t0_ns"]) / 1e9 for s in spans
                      if s["name"] == n and s["batch"] == b["batch"])
               for n in ("plan", "launch", "finish")}
        for n, v in own.items():
            assert b[f"{n}_s"] == pytest.approx(v, abs=1.5e-3), n
        assert sum(s["name"] == "plan" and s["batch"] == b["batch"]
                   for s in spans) == 1
    # the per-batch seconds add up to the pass's timers, not repeat them
    assert sum(b["plan_s"] for b in batches) == pytest.approx(
        corr.timers["plan"], abs=5e-3)
    root = [s for s in spans if s["name"] == "job"]
    assert len(root) == 1 and all(s["job"] == root[0]["id"] for s in spans)
    assert {s["name"] for s in spans} >= DRIVING | {"plan", *PLAN_PARTS}
    n_lines = len(evs)
    run(job, 1, "json2.fq", trace_json=path)
    evs2 = [json.loads(line) for line in open(path)]
    assert evs2[:n_lines] == evs
    assert sum(e["ev"] == "pass_done" for e in evs2) == 2


def test_trace_json_writes_batches_as_they_finish_and_when_it_raises(
        job, monkeypatch):
    corr, opt, lr, tmp = job
    path = str(tmp / "raises.jsonl")
    monkeypatch.setattr(pipeline, "TRACE_EVERY", 2)
    seen = []
    assemble = corr.assemble_batch

    def failing(*a, **kw):
        # batches 0 and 1 are in the file once batch 1 is written; batch 2
        # then fails in its assembly, while batch 3's plan may be open
        if len(seen) == 2:
            assert [e["batch"] for e in map(json.loads, open(path))
                    if e["ev"] == "batch"] == [0, 1]
            raise RuntimeError("planted")
        seen.append(1)
        return assemble(*a, **kw)

    monkeypatch.setattr(corr, "assemble_batch", failing)
    with pytest.raises(RuntimeError, match="planted"):
        run(job, 2, "raises.fq", trace_json=path)
    assert TR._active is None
    evs = [json.loads(line) for line in open(path)]
    assert [e["batch"] for e in evs if e["ev"] == "batch"] == [0, 1]
    assert not [e for e in evs if e["ev"] == "pass_done"]
    spans = [e for e in evs if e["ev"] == "span"]
    ids = [s["id"] for s in spans]
    assert len(ids) == len(set(ids))
    # the job's span, and batch 2's, though the pass raised
    assert [s["name"] for s in spans].count("job") == 1
    assert {"plan", "wait", "launch", "finish"} <= {
        s["name"] for s in spans if s["batch"] == 2}


def test_recording_nests_and_threads_take_their_parent():
    with TR.recording() as outer:
        with TR.recording() as inner:
            assert inner is outer
        assert TR._active is outer
        with TR.span("job") as root:
            def work():
                with TR.within(root, 7):
                    with TR.span("plan"):
                        pass
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    assert TR._active is None
    plan = next(s for s in outer.spans if s.name == "plan")
    assert (plan.parent, plan.job, plan.batch) == (root.id, root.id, 7)
    assert plan.thread != root.thread
