"""What the host did around a run's window, to explain how far runs of one
seed spread: the process's CPU time and involuntary context switches, the
time the hypervisor gave the machine's CPUs to others (steal, /proc/stat),
the CPUs' clock (/proc/cpuinfo), the load, and a fixed piece of plain
Python work timed before and after the window (`probe`), which reads the
host's speed for one thread. None of it is a metric; each run prints it in
its record."""

from __future__ import annotations

import os
import resource
import time

HZ = os.sysconf("SC_CLK_TCK") if hasattr(os, "sysconf") else 100


def _steal_s():
    try:
        with open("/proc/stat") as f:
            cols = f.readline().split()
        return int(cols[8]) / HZ if cols[0] == "cpu" and len(cols) > 8 \
            else None
    except (OSError, ValueError):
        return None


def _mhz():
    try:
        with open("/proc/cpuinfo") as f:
            v = [float(ln.split(":")[1]) for ln in f
                 if ln.startswith("cpu MHz")]
        return sum(v) / len(v) if v else None
    except (OSError, ValueError):
        return None


def probe(n: int = 1_000_000) -> float:
    """Seconds that a fixed loop of plain Python takes on this thread."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(n):
        acc += i & 7
    return time.perf_counter() - t0


def snapshot() -> dict:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_s": ru.ru_utime + ru.ru_stime, "nivcsw": ru.ru_nivcsw,
            "steal_s": _steal_s(), "mhz": _mhz(),
            "load1": os.getloadavg()[0]}


def over(a: dict, b: dict) -> dict:
    """What the host did between snapshots a and b."""
    steal = None if None in (a["steal_s"], b["steal_s"]) \
        else b["steal_s"] - a["steal_s"]
    return {"cpu_s": b["cpu_s"] - a["cpu_s"],
            "nivcsw": b["nivcsw"] - a["nivcsw"], "steal_s": steal,
            "mhz": [a["mhz"], b["mhz"]], "load1": [a["load1"], b["load1"]]}
