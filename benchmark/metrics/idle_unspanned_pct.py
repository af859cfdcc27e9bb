"""The idle time the program's spans cannot name: the share of the traced
window in which the card runs nothing (no CUDA interval of torch.profiler's
trace) and the thread that drives the card is inside a `job` span but in
none of that job's child spans on it (%). The spans go onto the profiler's
time line by its `trace_start_ns` (the record's `profile` keys
`trace_start_ns` and `busy`, the merged device intervals in us), on their
own clock, with no fitted offset. Nothing without the program's spans, a
device op or the profile's clock."""

from benchmark import spans, trace


def read(rec):
    sp, prof = spans.of(rec), rec.get("profile") or {}
    if not sp or not prof.get("device_ops") or "trace_start_ns" not in prof \
            or "busy" not in prof:
        return None
    jobs = [s for s in sp if s["name"] == "job"]
    if not jobs:
        return None
    ids = {s["id"] for s in jobs}
    threads = {s["thread"] for s in jobs}
    t0 = prof["trace_start_ns"]

    def us(s):   # on the profiler's time line
        return (s["t0_ns"] - t0) / 1e3, (s["t1_ns"] - t0) / 1e3

    inside = spans.merged([us(s) for s in jobs])
    named = spans.merged([us(s) for s in sp
                          if s["parent"] in ids and s["thread"] in threads])
    idle = spans.minus(spans.minus(inside, named), prof["busy"])
    return 100.0 * trace.union_s(idle) / rec["trace_window_s"]
