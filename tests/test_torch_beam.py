"""Port's beam search (ratatosk_tpu_torch/correct/beam.py, plain torch on the
CPU) against the JAX package's beam_search on the same graph and regions.
All seven BeamResult fields must be identical (tolerance 0), for the exact
NT=256 bucket and for 192-wide bands in 512- and 2048-wide buckets."""

import numpy as np
import pytest
import torch

from ratatosk_tpu_torch.correct import beam as TBM
from tests import torch_parity as TP
from tests.torch_parity import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("case", list(TP.CASES))
def test_beam_search_matches_jax(case):
    corr, jrb, lmax, band, want = TP.beam_case(case)
    got = TBM.beam_search(TP.to_torch_graph(corr.g), TP.to_torch_regions(jrb),
                          beam=8, lmax=lmax, min_cov=2, band=band)
    assert np.asarray(want.completed).any(), "fixture must complete regions"
    for f in TBM.FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


def test_plain_sprint_matches_default(case="nt256_exact"):
    """sprint_impl="torch" (the kernel's plain version, chosen explicitly)
    and the default route give the same result on CPU tensors."""
    corr, jrb, lmax, band, _ = TP.beam_case(case)
    g, rb = TP.to_torch_graph(corr.g), TP.to_torch_regions(jrb)
    a = TBM.beam_search(g, rb, beam=8, lmax=lmax, band=band)
    b = TBM.beam_search(g, rb, beam=8, lmax=lmax, band=band,
                        sprint_impl="torch")
    for f in TBM.FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_unknown_sprint_impl_raises():
    corr, jrb, lmax, band, _ = TP.beam_case("nt256_exact")
    with pytest.raises(ValueError):
        TBM.beam_search(TP.to_torch_graph(corr.g), TP.to_torch_regions(jrb),
                        beam=8, lmax=lmax, sprint_impl="pallas")
