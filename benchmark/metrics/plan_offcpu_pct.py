"""The planner's off-CPU share where it runs only Python and numpy: 100 x
(1 - thread CPU seconds / wall seconds), summed over the window's
`plan.waypoints` and `plan.reads` spans (%). Neither makes a native call
that waits on its own threads, so the share is the time the planner thread
waited for the interpreter lock or was preempted. Nothing without the
program's spans, or without those spans."""

from benchmark import spans

PARTS = ("plan.waypoints", "plan.reads")


def read(rec):
    sp = [s for s in spans.of(rec) if s["name"] in PARTS]
    wall = sum(s["t1_ns"] - s["t0_ns"] for s in sp)
    if not wall:
        return None
    return 100.0 * (1.0 - sum(s["cpu_ns"] for s in sp) / wall)
