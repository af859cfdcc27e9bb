"""Seconds from the process's start to the window's: imports, the data, the
index build, the Corrector, the kernel library (built in a checkout's first
run), the pool's chunk files and the warm-up job."""


def read(rec):
    return rec["setup_s"]
