"""CPU tests of the readers of the program's spans (benchmark/spans.py and
the metrics/ files that read spans) on hand-built records. Run from the
repository root:

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import pytest

from benchmark import cells, spans

SPAN_METRICS = ("plan_runs_s_per_mbp", "plan_probe_s_per_mbp",
                "plan_waypoints_s_per_mbp", "plan_reads_s_per_mbp",
                "plan_splices_s_per_mbp", "plan_offcpu_pct",
                "first_wait_share_pct", "assemble_s_per_mbp",
                "fastq_s_per_mbp", "idle_unspanned_pct")
T0 = 1_700_000_000 * 10**9       # the job's start, ns
S = 10**9


def sp(name, id_, parent, a, b, thread=1, cpu=None, batch=0, **fields):
    """A span as the program's Span.as_dict gives it, a..b seconds past T0."""
    return dict(name=name, id=id_, parent=parent, job=1, batch=batch,
                thread=thread, t0_ns=T0 + int(a * S), t1_ns=T0 + int(b * S),
                cpu_ns=int((b - a) * S if cpu is None else cpu * S),
                **fields)


def record():
    """One 10 s job over 2 Mbp: the driving thread (1) in a child span all
    but its last second; the planner thread (2) plans batch 1 (0.5..3.9 s,
    its five parts) and sits in a plan span over 9..10 s too; the card busy
    9.5..9.75 s."""
    job = [sp("job", 1, None, 0, 10)]
    driving = [sp("read", 2, 1, 0, 1),
               sp("wait", 3, 1, 1, 3, first=1),
               sp("launch", 4, 1, 3, 4), sp("finish", 5, 1, 4, 6),
               sp("assemble", 6, 1, 6, 7), sp("write", 7, 1, 7, 8),
               sp("wait", 8, 1, 8, 9, batch=1, first=0)]
    plan = [sp("plan", 9, 1, 0.5, 3.9, thread=2, batch=1),
            sp("plan.runs", 10, 9, 0.5, 1.5, thread=2, batch=1),
            sp("plan.probe", 11, 9, 1.5, 2.0, thread=2, batch=1),
            sp("plan.waypoints", 12, 9, 2.0, 2.5, thread=2, cpu=0.25,
               batch=1),
            sp("plan.reads", 13, 9, 2.5, 3.5, thread=2, cpu=0.5, batch=1),
            sp("plan.splices", 14, 9, 3.5, 3.9, thread=2, batch=1),
            sp("plan", 15, 1, 9, 10, thread=2, batch=2)]
    # the profiler's clock starts 2 s before the job; busy in us from there
    prof = {"device_ops": 3, "busy_s": 0.25,
            "trace_start_ns": T0 - 2 * S,
            "busy": [[2e6 + 9.5e6, 2e6 + 9.75e6]]}
    return {"spans": job + driving + plan, "bases": 2_000_000,
            "window_s": 10.0, "trace_window_s": 10.0, "profile": prof,
            "timers": {"plan": 4.4, "launch": 1.0, "finish": 2.0,
                       "wait": 3.0}}


WANT = {"plan_runs_s_per_mbp": 0.5, "plan_probe_s_per_mbp": 0.25,
        "plan_waypoints_s_per_mbp": 0.25, "plan_reads_s_per_mbp": 0.5,
        "plan_splices_s_per_mbp": 0.2,
        # wall 0.5 + 1.0 s, thread CPU 0.25 + 0.5 s
        "plan_offcpu_pct": 50.0,
        # batch 0's wait, 2 s of 10
        "first_wait_share_pct": 20.0,
        "assemble_s_per_mbp": 0.5,
        # read 1 s + write 1 s over 2 Mbp
        "fastq_s_per_mbp": 1.0,
        # 9..10 s in no child of the job on its thread, the card busy for
        # 0.25 s of it: 0.75 s of 10
        "idle_unspanned_pct": 7.5}


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_on_a_hand_built_record(name):
    assert cells.load_reader(name)(record()) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_reader_without_spans_reads_nothing(name):
    rec = record()
    rec.pop("spans")
    assert cells.load_reader(name)(rec) is None
    rec["spans"] = []
    assert cells.load_reader(name)(rec) is None


def test_device_readers_need_the_profile_and_a_device_op():
    read = cells.load_reader("idle_unspanned_pct")
    for drop in ("trace_start_ns", "busy"):
        rec = record()
        rec["profile"].pop(drop)
        assert read(rec) is None
    rec = record()
    rec["profile"]["device_ops"] = 0
    assert read(rec) is None
    rec = record()
    rec.pop("profile")
    assert read(rec) is None
    # no plan part that runs only Python: no off-CPU share to read
    rec = record()
    rec["spans"] = [s for s in rec["spans"]
                    if s["name"] not in ("plan.waypoints", "plan.reads")]
    assert cells.load_reader("plan_offcpu_pct")(rec) is None


def test_the_five_parts_cover_the_plan():
    rec = record()
    parts = sum(cells.load_reader(f"plan_{p}_s_per_mbp")(rec)
                for p in ("runs", "probe", "waypoints", "reads", "splices"))
    plan = spans.seconds(rec["spans"][8:14], ("plan",)) / 2
    assert parts == pytest.approx(plan)
    assert spans.PLAN_PARTS == tuple(
        s["name"] for s in rec["spans"][9:14])


@pytest.mark.parametrize("a, b, want", [
    ([[0, 10]], [], [[0, 10]]),
    ([[0, 10]], [[0, 10]], []),
    ([[0, 10]], [[2, 3], [5, 6]], [[0, 2], [3, 5], [6, 10]]),
    ([[0, 4], [6, 10]], [[3, 7]], [[0, 3], [7, 10]]),
    ([[0, 4], [6, 10]], [[-5, 1], [9, 20]], [[1, 4], [6, 9]]),
    ([[1, 2]], [[0, 1], [2, 3]], [[1, 2]]),
])
def test_minus(a, b, want):
    assert spans.minus(a, b) == want


def test_merged():
    assert spans.merged([(5, 6), (0, 2), (1, 3), (3, 4)]) == [[0, 4], [5, 6]]
