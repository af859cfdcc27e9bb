"""Shared inputs for the port's parity tests: weak-region batches planned by
the JAX package, run through its beam search, and carried across to torch as
NumPy arrays. Built once per test process."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from ratatosk_tpu import testing as JT
from ratatosk_tpu.correct import beam as JBM
from ratatosk_tpu.correct.engine import make_region_batch as jax_region_batch
from ratatosk_tpu_torch.correct import beam as TBM
from ratatosk_tpu_torch.correct.graphdev import DeviceGraph

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and the tensors here are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (case, NT, band): the exact 256 bucket, and one set of 100-512 bp regions
# run banded at 192 in a 512-wide and a 2048-wide bucket
CASES = {"nt256_exact": (256, 0), "nt512_band192": (512, 192),
         "nt2048_band192": (2048, 192)}


@functools.lru_cache(maxsize=None)
def _corrector(seed, glen, k, coverage):
    return JT.build_toy_corrector(seed=seed, glen=glen, k=k,
                                  coverage=coverage)


def _specs(case):
    if case == "nt256_exact":
        # tests/test_sprint_pallas.py:79-93
        genome, corr = _corrector(7, 20000, 21, 30.0)
        rng = np.random.default_rng(7)
        specs = JT.toy_region_specs(corr, genome, rng, 32)
        return corr, [s for s in specs if len(s.tgt) <= 256][:16]
    # tests/test_beam_band.py:12-21
    genome, corr = _corrector(77, 20000, 17, 35)
    rng = np.random.default_rng(77)
    specs = JT.toy_region_specs(corr, genome, rng, 120, err=0.12)
    return corr, [s for s in specs if 100 < len(s.tgt) <= 512][:8]


@functools.lru_cache(maxsize=None)
def beam_case(case):
    """(JAX corrector, JAX RegionBatch, lmax, band, JAX BeamResult)."""
    nt, band = CASES[case]
    corr, specs = _specs(case)
    rb, lmax = jax_region_batch(specs, nt, corr.colors.cap,
                                r_pad=max(len(specs), 8))
    res = JBM.beam_search(corr.g, rb, beam=8, lmax=lmax, min_cov=2,
                          band=band)
    return corr, rb, lmax, band, res


# (case, NT, band, len_factor): bands wider than 512 columns:
# band_width=600 in the 2048 bucket on regions longer than 600,
# and weak_region_len_factor=0.6 in the 256 bucket (lmax 568: the finish's
# full path row is 569 columns)
WIDE = {"nt2048_band600": (2048, 600, 0.25),
        "nt256_factor06": (256, 0, 0.6)}


@functools.lru_cache(maxsize=None)
def wide_case(case):
    """(JAX corrector, JAX RegionBatch, lmax, band, JAX BeamResult)."""
    nt, band, factor = WIDE[case]
    genome, corr = _corrector(5, 30000, 21, 25.0)
    specs = JT.toy_region_specs(corr, genome, np.random.default_rng(5), 120,
                                err=0.15)
    lo = band if band else 0
    specs = sorted((s for s in specs if lo < len(s.tgt) <= nt),
                   key=lambda s: len(s.tgt))[-8:]
    rb, lmax = jax_region_batch(specs, nt, corr.colors.cap, r_pad=8,
                                len_factor=factor)
    res = JBM.beam_search(corr.g, rb, beam=8, lmax=lmax, min_cov=2,
                          band=band)
    return corr, rb, lmax, band, res


def to_torch_graph(jg) -> DeviceGraph:
    return DeviceGraph.from_numpy(
        {f: np.asarray(getattr(jg, f))
         for f in ("kval", "useq", "utbl", "color_sig")}, CPU)


def to_torch_regions(jrb) -> TBM.RegionBatch:
    return TBM.RegionBatch.from_numpy(
        {f: np.asarray(v) for f, v in jrb._asdict().items()}, CPU)
