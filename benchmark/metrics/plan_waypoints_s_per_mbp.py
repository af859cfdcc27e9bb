"""The planner's `plan.waypoints` spans (correct/engine.py), the waypoint
choice: `_region_colors` and `select_waypoints` for each probed span, over
the window's input Mbp (seconds a Mbp). Nothing without the program's
spans."""

from benchmark import spans


def read(rec):
    return spans.s_per_mbp(rec, "plan.waypoints")
