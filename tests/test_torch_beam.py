"""Port's beam search (ratatosk_tpu_torch/correct/beam.py, plain torch on the
CPU) against the JAX package's beam_search on the same graph and regions.
All seven BeamResult fields must be identical (tolerance 0), for the exact
NT=256 bucket and for 192-wide bands in 512- and 2048-wide buckets; so must
beam_search_by_region, the plain version of the fused kernel's control
flow."""

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


@pytest.mark.parametrize("case", list(TP.CASES))
def test_beam_search_by_region_matches_jax(case):
    """The fused kernel's control flow in plain torch (each region alone to
    its own all-frozen step, then on to the launch-wide T) equals the JAX
    beam_search, all seven fields."""
    corr, jrb, lmax, band, want = TP.beam_case(case)
    got = TBM.beam_search_by_region(
        TP.to_torch_graph(corr.g), TP.to_torch_regions(jrb), beam=8,
        lmax=lmax, min_cov=2, band=band)
    for f in TBM.FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("impl", ["auto", "steps"])
def test_plain_sprint_matches_default(impl, case="nt256_exact"):
    """impl="torch" (the plain version throughout) and the kernel routes,
    which take the plain version on CPU tensors, give the same result."""
    from ratatosk_tpu_torch.ops.beam_kernel import fused_beam_search
    from ratatosk_tpu_torch.ops.sprint import sprint_rows
    corr, jrb, lmax, band, _ = TP.beam_case(case)
    g, rb = TP.to_torch_graph(corr.g), TP.to_torch_regions(jrb)
    before = (fused_beam_search.launches, sprint_rows.launches)
    a = TBM.beam_search(g, rb, beam=8, lmax=lmax, band=band, impl=impl)
    b = TBM.beam_search(g, rb, beam=8, lmax=lmax, band=band, impl="torch")
    assert (fused_beam_search.launches, sprint_rows.launches) == before
    for f in TBM.FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("impl", ["pallas", "sprint", ""])
def test_unknown_sprint_impl_raises(impl):
    corr, jrb, lmax, band, _ = TP.beam_case("nt256_exact")
    with pytest.raises(ValueError, match="impl"):
        TBM.beam_search(TP.to_torch_graph(corr.g), TP.to_torch_regions(jrb),
                        beam=8, lmax=lmax, impl=impl)


def test_fused_beam_search_has_no_kernel_off_the_card():
    """Only a CPU tensor takes the plain version: any other device gets the
    kernel or an error."""
    from ratatosk_tpu_torch.ops.beam_kernel import fused_beam_search
    corr, jrb, lmax, band, _ = TP.beam_case("nt256_exact")
    rb = TP.to_torch_regions(jrb)
    meta = TBM.RegionBatch(**{f: getattr(rb, f).to("meta")
                              for f in TBM.RegionBatch._DTYPES})
    with pytest.raises(ValueError, match="no kernel"):
        fused_beam_search(TP.to_torch_graph(corr.g), meta, beam=8, lmax=lmax)
