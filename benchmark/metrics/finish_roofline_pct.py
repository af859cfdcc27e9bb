"""The finish kernel (csrc/finish.cu) against its roofline: the sum over
every launch in the traced window of the least time the card could take
(benchmark/work.py: finish_work on the launch's own inputs and outputs,
over the H100's published int32 and HBM peaks, the larger of the two) over
the sum of the launches' device times from torch.profiler (%). Nothing when
the trace holds no finish launch, or not one for each captured launch."""

from benchmark import work


def read(rec):
    prof, launches = rec.get("profile"), rec.get("launches")
    if not prof or not launches or len(prof["finish"]) != len(launches):
        return None
    bound = sum(work.bound_s(work.finish_work(
        x.tgt_len, x.scalars, lmax=x.lmax, nt=x.nt, band=x.band,
        n_real=x.n_real)) for x in launches)
    device_s = sum(b - a for a, b in prof["finish"]) / 1e6
    return 100.0 * bound / device_s
