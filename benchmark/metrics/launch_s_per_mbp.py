"""Corrector.timers["launch"] over the window's input Mbp (seconds a Mbp)."""


def read(rec):
    return rec["timers"]["launch"] / (rec["bases"] / 1e6)
