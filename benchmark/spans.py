"""The program's own spans in a traced run's record: `spans`, one dict a
span as `Span.as_dict` of ratatosk_tpu_torch/trace.py gives it (name, id,
parent, job, batch, thread, t0_ns, t1_ns, cpu_ns and its fields), on
CLOCK_REALTIME nanoseconds, the clock of the profiler's `trace_start_ns`.
The record holds them where the traced window runs inside the program's
`trace.recording()`; job.py does not open one yet (PERF.md §7 names the
edit), so the readers of metrics/ that read spans return None until then,
as they do for a program that records none."""

from __future__ import annotations

# the planner's five parts, children of each `plan` span
PLAN_PARTS = ("plan.runs", "plan.probe", "plan.waypoints", "plan.reads",
              "plan.splices")


def of(rec) -> list:
    """The record's spans, or [] when it holds none."""
    return rec.get("spans") or []


def seconds(spans, names) -> float:
    """Wall seconds of the spans named in `names`."""
    return sum(s["t1_ns"] - s["t0_ns"] for s in spans
               if s["name"] in names) / 1e9


def s_per_mbp(rec, *names):
    """Seconds of the spans named over the window's input Mbp, or None."""
    spans = of(rec)
    if not spans:
        return None
    return seconds(spans, names) / (rec["bases"] / 1e6)


def merged(spans) -> list:
    """The union of (start, end) intervals as sorted, disjoint intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def minus(a: list, b: list) -> list:
    """Sorted disjoint intervals `a` less sorted disjoint intervals `b`."""
    out, j = [], 0
    for lo, hi in a:
        while j < len(b) and b[j][1] <= lo:
            j += 1
        k = j
        while lo < hi and k < len(b) and b[k][0] < hi:
            if b[k][0] > lo:
                out.append([lo, b[k][0]])
            lo = max(lo, b[k][1])
            k += 1
        if lo < hi:
            out.append([lo, hi])
    return out
