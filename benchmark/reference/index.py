"""The index of a pass, derived by the reference itself: the port's
pipeline.build_pass2_index and pass-option rule (pipeline._pass_opt), and
the pass-1 build that bench_torch.py runs, frozen."""

from __future__ import annotations

import dataclasses

from . import build as B
from .colors import color_graph
from .config import CorrectOpt


def pass_opt(opt: CorrectOpt, pass_no: int) -> CorrectOpt:
    """Per-pass view: pass 2 corrects longer weak regions
    (Common.hpp:131-132) and skips regions already at maximal quality."""
    o = dataclasses.replace(opt)
    if pass_no == 2:
        o.max_len_weak_region1 = opt.max_len_weak_region2
        o.skip_max_quality_regions = True
    return o


def build_index(opt: CorrectOpt, pass_no: int, short_reads: list,
                long_reads=None):
    """(cdbg, colors) of the pass: pass 1 at small_k, coloured by the short
    reads; pass 2 at k, coloured by the long reads (codes, qual) that are at
    least min_len_2nd_pass long, bases under the pass-2 confidence masked."""
    if pass_no == 1:
        cdbg = B.build_cdbg(short_reads, opt.small_k,
                            min_count=opt.min_count_kmer)
        return cdbg, color_graph(cdbg, short_reads)
    cdbg = B.build_cdbg(short_reads, opt.k, min_count=opt.min_count_kmer)
    color_reads = []
    min_q = 33 + int(opt.min_confidence_2nd_pass * opt.max_qual)
    for codes, qual in long_reads:
        if len(codes) < opt.min_len_2nd_pass:
            continue
        masked = codes.copy()
        if qual is not None and opt.min_confidence_2nd_pass > 0:
            masked[qual < min_q] = 4
        color_reads.append(masked)
    return cdbg, color_graph(cdbg, color_reads, cap=opt.max_cov_vertices,
                             min_cov_edge=opt.min_cov_vertices,
                             spill_bytes=opt.spill_bytes)
