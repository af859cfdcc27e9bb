"""The planner's `plan.reads` spans (correct/engine.py), the per-read loop:
`_plan_read` / `_plan_gap` over the batch's reads, over the window's input
Mbp (seconds a Mbp). Nothing without the program's spans."""

from benchmark import spans


def read(rec):
    return spans.s_per_mbp(rec, "plan.reads")
