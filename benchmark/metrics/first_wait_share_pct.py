"""The unhidden first plan of each job: the driving thread's `wait` spans
for a job's batch 0 (`first` set), over the window's seconds (%); a part of
wait_share_pct. Nothing without the program's spans."""

from benchmark import spans


def read(rec):
    sp = spans.of(rec)
    if not sp:
        return None
    first = [s for s in sp if s["name"] == "wait" and s.get("first")]
    return 100.0 * spans.seconds(first, ("wait",)) / rec["window_s"]
