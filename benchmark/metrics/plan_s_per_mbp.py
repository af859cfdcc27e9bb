"""Corrector.timers["plan"] over the window's input Mbp (seconds a Mbp)."""


def read(rec):
    return rec["timers"]["plan"] / (rec["bases"] / 1e6)
