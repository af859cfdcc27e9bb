"""The double buffer: Corrector.timers["wait"], the seconds the thread that
drives the card waits for the planner thread's next batch, as a share of the
window (%)."""


def read(rec):
    return 100.0 * rec["timers"]["wait"] / rec["window_s"]
