"""The planner's `plan.runs` spans (correct/engine.py), the exact k-mer runs:
the anchor lookups (`find_runs`, or the device planner's runs) and
`filter_runs_by_color`, over the window's input Mbp (seconds a Mbp).
Nothing without the program's spans."""

from benchmark import spans


def read(rec):
    return spans.s_per_mbp(rec, "plan.runs")
