"""The planner's `plan.probe` spans (correct/engine.py), the 1-edit probe: the
anchor-free spans to probe and `find_weak_seeds_batch` (or the device
planner's probe), over the window's input Mbp (seconds a Mbp). Nothing
without the program's spans."""

from benchmark import spans


def read(rec):
    return spans.s_per_mbp(rec, "plan.probe")
