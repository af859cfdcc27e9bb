"""The planner's `plan.splices` spans (correct/engine.py), `_resolve_splices`:
the batch's same-unitig splice distances in one native call, over the
window's input Mbp (seconds a Mbp). Nothing without the program's spans."""

from benchmark import spans


def read(rec):
    return spans.s_per_mbp(rec, "plan.splices")
