"""The port's spans and JSONL events (ratatosk_tpu_torch/trace.py) on a small
correction job on the CPU: the recorder off costs nothing and records
nothing, on it gives one span tree per job across the planner processes or
thread and the driving thread, its spans feed Corrector.timers, its clock is
the profiler's, the output does not move, and --trace-json writes the
events and the spans."""

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
from ratatosk_tpu_torch.correct import plan_pool as PP
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
    PP.close(corr.planner)
    torch.set_num_threads(n)


def run(job, threads: int, out: str, **opt_kw):
    corr, opt, lr, tmp = job
    o = dataclasses.replace(opt, nb_threads=threads, **opt_kw)
    corr.timers = dict.fromkeys(corr.timers, 0.0)
    path = str(tmp / out)
    pipeline.correct_file(corr, o, [lr], path, 1)
    with open(path, "rb") as f:
        return f.read()


def recorded(job, threads: int, out: str, **opt_kw):
    with TR.recording() as rec:
        data = run(job, threads, out, **opt_kw)
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
        # the fields: a wait's `first` and `ahead`, a plan.runs'
        # `batched`, a plan's `maxq_bp`, `proc` and `slice` (and `priv_mb`
        # from a planner process)
        assert s.fields is None or (
            {s.name: set(s.fields)}
            in ({"wait": {"first", "ahead"}}, {"plan.runs": {"batched"}},
                {"plan": {"maxq_bp", "proc", "slice"}},
                {"plan": {"maxq_bp", "proc", "slice", "priv_mb"}})), s.name
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


def test_tree_with_planner_processes(job, monkeypatch):
    """Three planner processes (as on an eight-core host), three reads in
    batch 0 and one in batch 1: each slice's `plan` tree sits in the job's
    tree at its batch, on its worker's pid, with `proc`, `slice` and
    `priv_mb`; the wait carries `ahead`; a `plan.merge` a batch on the
    driving thread after its wait; the plan spans sum to timers["plan"]."""
    import os

    monkeypatch.setattr(PP, "usable_cores", lambda: list(range(8)))
    monkeypatch.setattr(PP, "worker_cores",
                        lambda cores: sorted(os.sched_getaffinity(0)))
    spans, _ = recorded(job, 2, "procs.fq", read_batch_bp=4500)
    root = _tree(spans)
    by_id = {s.id: s for s in spans}
    plans = [s for s in spans if s.name == "plan"]
    assert sorted((s.batch, s.fields["slice"]) for s in plans) == \
        [(0, 0), (0, 1), (0, 2), (1, 0)]
    for p in plans:
        assert p.parent == root.id and p.thread != root.thread
        assert 0 <= p.fields["proc"] < 3 and p.fields["priv_mb"] > 0
        kids = [s for s in spans if s.parent == p.id]
        assert {s.name for s in kids} == set(PLAN_PARTS)
        assert all(s.thread == p.thread and s.batch == p.batch
                   for s in kids)
    assert len({p.thread for p in plans if p.batch == 0}) == 3
    assert len({(p.thread, p.fields["proc"]) for p in plans}) == \
        len({p.thread for p in plans})
    waits = {s.batch: s for s in spans if s.name == "wait"}
    merges = [s for s in spans if s.name == "plan.merge"]
    assert sorted(waits) == sorted(s.batch for s in merges) == [0, 1]
    assert waits[0].fields["ahead"] in (0, 1, 2, 3)
    assert waits[1].fields["ahead"] in (0, 1)
    for m in merges:
        assert by_id[m.parent] is root and m.thread == root.thread
        assert waits[m.batch].t1 <= m.t0
    got = sum(s.seconds() for s in plans)
    assert got == pytest.approx(job[0].timers["plan"], rel=1e-9, abs=1e-12)


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


# ---------- pass 2: the index build's spans, max quality ----


@pytest.fixture(scope="module")
def pass2(tmp_path_factory):
    """Pass-2 inputs on a 12 kbp genome: five ~2 kbp long reads at pass 1's
    residual error, two of them under min_len_2nd_pass, and one more read
    with 2,300 random bases planted between two stretches of the genome
    (a gap region); qualities drawn over 0-40, so that
    min_confidence_2nd_pass 0.5 masks a part of each read."""
    tmp = tmp_path_factory.mktemp("torch_trace_p2")
    rng = np.random.default_rng(2929)
    genome = T.random_genome(rng, 12000)
    sreads = T.short_reads(rng, genome, coverage=30.0, read_len=100)
    reads = [noisy for noisy, _, _ in T.long_reads(
        rng, genome, n=5, min_len=1800, max_len=2200, err=0.012)]
    junk = rng.integers(0, 4, 2300).astype(np.uint8)
    reads.append(np.concatenate([genome[1000:2500], junk,
                                 genome[2500:4000]]))
    quals = [rng.integers(33, 74, len(r)).astype(np.uint8) for r in reads]
    opt = CorrectOpt(small_k=17, k=31, beam_width=8, batch_regions=32,
                     read_batch_bp=4000, nb_threads=1, weak_seed_min_gap=80,
                     min_len_2nd_pass=2000, min_confidence_2nd_pass=0.5)
    lr = tmp / "p1out.fq"
    with open(lr, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{dna.decode(r)}\n+\n{'!' * len(r)}\n")
    return opt, sreads, reads, quals, str(lr), tmp


def _index(opt, sreads, reads, quals, prebuilt=None):
    return pipeline.build_pass2_index(
        opt, zip(reads, quals), sreads, list(range(len(sreads))),
        prebuilt_cdbg=prebuilt)


@pytest.mark.parametrize("prebuilt", [False, True])
def test_pass2_index_is_one_span_tree_with_its_counts(pass2, prebuilt):
    opt, sreads, reads, quals, _, _ = pass2
    from ratatosk_tpu_torch.graph import build as B
    cdbg0 = (B.build_cdbg(sreads, opt.k, min_count=opt.min_count_kmer)
             if prebuilt else None)
    with TR.recording() as rec:
        cdbg, _ = _index(opt, sreads, reads, quals, cdbg0)
    assert [s.name for s in rec.spans] == ["index.graph", "index.colour",
                                           "index"]
    graph, colour, root = rec.spans
    assert root.parent is None and root.job is None and root.batch is None
    assert graph.parent == colour.parent == root.id
    assert root.t0 <= graph.t0 <= graph.t1 <= colour.t0 <= colour.t1 \
        <= root.t1
    assert graph.fields is None and colour.fields is None
    min_q = 33 + int(opt.min_confidence_2nd_pass * opt.max_qual)
    long_ = [i for i, r in enumerate(reads) if len(r) >= opt.min_len_2nd_pass]
    assert 0 < len(long_) < len(reads)
    assert root.fields == {
        "k": opt.k, "reads": len(long_), "short": len(reads) - len(long_),
        "masked": sum(int((quals[i] < min_q).sum()) for i in long_)}
    assert cdbg.k == opt.k and (cdbg0 is None or cdbg is cdbg0)


@pytest.fixture(scope="module")
def pass2_job(pass2):
    opt, sreads, reads, quals, lr, tmp = pass2
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    o2 = pipeline._pass_opt(opt, 2)
    cdbg, colors = _index(opt, sreads, reads, quals)
    yield Corrector(cdbg, colors, o2, device="cpu"), o2, lr, tmp
    torch.set_num_threads(n)


def _gap_region(corr, reads, quals):
    _, _, regions = corr.plan_batch(reads, quals)
    return next(sp for sp in regions if sp.kind == "gap")


def test_pass2_maxq_bp_is_the_planted_span(pass2, pass2_job):
    """A gap region's raw span planted at maximal quality (the rest of the
    read low) is what the plan span's maxq_bp counts; 0 with the skip off
    (pass 1's options) on the same qualities."""
    _, _, reads, _, _, _ = pass2
    corr, o2, _, _ = pass2_job
    low = [np.full(len(r), 33 + 10, np.uint8) for r in reads]
    sp = _gap_region(corr, reads, low)
    quals = [q.copy() for q in low]
    quals[sp.read_idx][sp.raw_a:sp.raw_b] = 33 + corr.qv_max
    for skip, want in ((True, sp.raw_b - sp.raw_a), (False, 0)):
        corr.planner.opt = dataclasses.replace(
            o2, skip_max_quality_regions=skip)
        try:
            with TR.recording() as rec:
                _, _, regions = corr.plan_batch(reads, quals)
        finally:
            corr.planner.opt = o2
        plan, = [s for s in rec.spans if s.name == "plan"]
        assert plan.fields == {"maxq_bp": want, "proc": -1, "slice": 0}
        kept = [(r.read_idx, r.raw_a, r.raw_b) for r in regions]
        assert ((sp.read_idx, sp.raw_a, sp.raw_b) in kept) == (not skip)
    assert sp.raw_b - sp.raw_a > 0


def test_pass2_same_output_recorded_or_not_and_off_keeps_no_span(
        pass2, pass2_job, monkeypatch):
    """Off, pass 2's index build and job make no Span; on, the FASTQ and the
    index are the same."""
    opt, sreads, reads, quals, _, _ = pass2
    corr, o2, lr, tmp = pass2_job
    made = []

    class Counted(TR.Span):
        __slots__ = ()

        def __init__(self, *a, **kw):
            made.append(1)
            super().__init__(*a, **kw)

    monkeypatch.setattr(TR, "Span", Counted)

    def job(out):
        cdbg, colors = _index(opt, sreads, reads, quals)
        pipeline.correct_file(Corrector(cdbg, colors, o2, device="cpu"), o2,
                              [lr], str(tmp / out), 2)
        with open(tmp / out, "rb") as f:
            return cdbg, colors, f.read()

    cdbg_off, colors_off, off = job("p2_off.fq")
    assert made == [] and TR._active is None
    with TR.recording() as rec:
        cdbg_on, colors_on, on = job("p2_on.fq")
    assert len(made) == len(rec.spans) > 0
    assert off and on == off
    assert np.array_equal(cdbg_on.index.keys_lo, cdbg_off.index.keys_lo)
    assert np.array_equal(colors_on.coverage, colors_off.coverage)
