"""The fused beam kernel (csrc/beam.cu) against its roofline, SAMPLED: the
first launch of each width bucket (NT 256 / 2048 / 5376) in the traced
window, whose work benchmark/work.py:beam_work counts from a plain run of
the launch step by step after the window (too dear for every launch). The
sum of those launches' least times (the larger of int32 operations and
bytes over the H100's published peaks) over the sum of their device times:
both beam-kernel launches of each, from torch.profiler (%). Nothing when the
trace holds no beam launch, or not two for each captured launch."""

from benchmark import work


def read(rec):
    prof, launches = rec.get("profile"), rec.get("launches")
    if not prof or not launches or len(prof["beam"]) != 2 * len(launches):
        return None
    bound = device_s = 0.0
    for i, x in enumerate(launches):
        if x.beam_args is None:
            continue
        w = work.beam_work(n_real=x.n_real, **x.beam_args)
        bound += work.bound_s(w)
        (a1, b1), (a2, b2) = prof["beam"][2 * i], prof["beam"][2 * i + 1]
        device_s += (b1 - a1 + b2 - a2) / 1e6
    return 100.0 * bound / device_s if device_s else None
