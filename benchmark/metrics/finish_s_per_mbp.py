"""Corrector.timers["finish"] over the window's input Mbp (seconds a Mbp)."""


def read(rec):
    return rec["timers"]["finish"] / (rec["bases"] / 1e6)
