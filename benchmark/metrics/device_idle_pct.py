"""100 minus the share of the traced window in which some operation ran on
the card: the union of the CUDA intervals of torch.profiler's trace over the
window's seconds (%). Nothing when the profiler saw no device op."""


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof["device_ops"]:
        return None
    return 100.0 - 100.0 * prof["busy_s"] / rec["trace_window_s"]
