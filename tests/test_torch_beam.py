"""Port's beam search (ratatosk_tpu_torch/correct/beam.py, plain torch on the
CPU) against the JAX package's beam_search on the same graph and regions.
All seven BeamResult fields must be identical (tolerance 0), for the exact
NT=256 bucket and for 192-wide bands in 512- and 2048-wide buckets; so must
beam_search_by_region, the plain version of the fused kernel's control
flow (each region to its own all-frozen step f_r, then at most one step
more)."""

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
    its own all-frozen step f_r, then min(T, f_r+1) - f_r steps more, T the
    launch-wide step count) equals the JAX beam_search, all seven fields."""
    corr, jrb, lmax, band, want = TP.beam_case(case)
    got = TBM.beam_search_by_region(
        TP.to_torch_graph(corr.g), TP.to_torch_regions(jrb), beam=8,
        lmax=lmax, min_cov=2, band=band)
    for f in TBM.FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


@pytest.mark.parametrize("case", list(TP.WIDE))
def test_beam_search_wide_bands_match_jax(case):
    """band_width=600 in the 2048 bucket and weak_region_len_factor=0.6 in
    the 256 bucket (the widths the kernels took only up to 512 columns):
    the port's CPU route equals the JAX beam_search, all seven fields."""
    corr, jrb, lmax, band, want = TP.wide_case(case)
    assert np.asarray(want.completed).any(), "fixture must complete regions"
    if band:
        assert (np.asarray(jrb.tgt_len) > band).sum() >= 4
    got = TBM.beam_search(TP.to_torch_graph(corr.g), TP.to_torch_regions(jrb),
                          beam=8, lmax=lmax, min_cov=2, band=band)
    for f in TBM.FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


_ENTRY = ("tip", "off", "plen", "live", "cmin", "frozen", "compl_", "fdist",
          "fend", "ccsum", "nvis")
_REGION = ("pcount", "cbest", "cstep", "ccand", "cplen", "csecond", "cnum",
           "csbits", "cscnt")


@pytest.mark.parametrize("case", list(TP.CASES))
def test_steps_past_own_end_are_a_fixed_point(case):
    """Each region alone: the step after its own all-frozen step f_r (the
    one the fused kernel still runs) and the step after that leave the same
    live entries, region scalars and rows, and the latter records each live
    slot as its own parent with no emission (hist = slot << 3)."""
    corr, jrb, lmax, band, _ = TP.beam_case(case)
    g, rb = TP.to_torch_graph(corr.g), TP.to_torch_regions(jrb)
    W = TBM.band_width(rb.tgt_masks.shape[1], band)
    kw = dict(min_cov=2, smax=8, sprint_fn=TBM.sprint_rows_ref)
    checked = 0
    for r in range(rb.tgt_masks.shape[0]):
        rb_r = TBM._rows(rb, r)
        st, pt = TBM._init_state(rb_r, 8, lmax, W)
        st, f_r = TBM._run_steps(g, rb_r, pt, st, 0, lmax, until_frozen=True,
                                 **kw)
        if f_r + 2 > lmax:
            continue
        a = TBM._step(g, rb_r, pt, st, f_r, **kw)
        b = TBM._step(g, rb_r, pt, a, f_r + 1, **kw)
        live = a.live[0]
        assert torch.equal(live, b.live[0])
        for f in _ENTRY:
            assert torch.equal(getattr(a, f)[0][live],
                               getattr(b, f)[0][live]), f
        for f in _REGION:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert torch.equal(a.rwin[0][live], b.rwin[0][live])
        slots = torch.arange(8, dtype=torch.int32)[live]
        assert torch.equal(b.hist[f_r + 1, 0][live], slots << 3)
        checked += 1
    assert checked > 0


def _poison(st, rng):
    """Random values in every field of every entry that is not live, and
    in the band row of every entry that is not live and unfrozen."""
    dead = ~st.live
    inactive = (~st.live | st.frozen)[..., None].expand_as(st.rwin)

    def rand(t, lo, hi):
        x = torch.tensor(rng.integers(lo, hi, t.shape))
        return x.to(t.dtype)
    for f in _ENTRY:
        t = getattr(st, f)
        if f == "live":
            continue
        if t.dtype == torch.bool:
            noise = rand(t, 0, 2)
        elif t.dtype == torch.float32:
            noise = torch.tensor(rng.uniform(-4, 4, t.shape),
                                 dtype=torch.float32)
        else:
            noise = rand(t, -(1 << 20), 1 << 20)
        setattr(st, f, torch.where(dead, noise, t))
    st.rwin = torch.where(inactive, rand(st.rwin, 0, TBM.BIG + 1), st.rwin)
    return st


@pytest.mark.parametrize("case", list(TP.CASES))
def test_inactive_state_never_reaches_the_result(case):
    """The reference's step loop with every dead entry's fields and every
    inactive entry's row overwritten with noise after each step: all seven
    fields still equal the JAX beam_search (the fused kernel does no work
    for those entries)."""
    corr, jrb, lmax, band, want = TP.beam_case(case)
    g, rb = TP.to_torch_graph(corr.g), TP.to_torch_regions(jrb)
    W = TBM.band_width(rb.tgt_masks.shape[1], band)
    rng = np.random.default_rng(5)
    kw = dict(min_cov=2, smax=8, sprint_fn=TBM.sprint_rows_ref)
    st, pt = TBM._init_state(rb, 8, lmax, W)
    t = 0
    while t < lmax and bool((st.live & ~st.frozen).any()):
        st = _poison(TBM._step(g, rb, pt, st, t, **kw), rng)
        t += 1
    got = TBM._pick_and_reconstruct(rb, st, t, lmax=lmax, smax=8)
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
