"""Port's finish bundle (ratatosk_tpu_torch/correct/finish.py) against the
JAX package's finish_bundle, both fed the same JAX BeamResult. The decision
scalars and the packed winner paths must be identical (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratatosk_tpu.correct import beam as JBM
from ratatosk_tpu.correct import finish as JFN
from ratatosk_tpu_torch.correct import beam as TBM
from ratatosk_tpu_torch.correct import finish as TFN
from tests import finish_cases as FC
from tests import torch_parity as TP
from tests.torch_parity import one_torch_thread  # noqa: F401

QV_MAX, MIN_SCORE_OPEN = 40, 0.5


@pytest.mark.parametrize("case", list(TP.CASES))
def test_finish_bundle_matches_jax(case):
    corr, jrb, lmax, band, res = TP.beam_case(case)
    k = corr.cdbg.k
    want = JFN.finish_bundle(jrb.tgt_masks, jrb.tgt_len, jrb.tgt_qual,
                             jnp.int32(QV_MAX), jnp.int32(k), res, w=band,
                             min_score_open=MIN_SCORE_OPEN)
    trb = TP.to_torch_regions(jrb)
    tres = TBM.BeamResult(**{f: torch.tensor(np.asarray(getattr(res, f)))
                             for f in TBM.FIELDS})
    got = TFN.finish_bundle(trb.tgt_masks, trb.tgt_len, trb.tgt_qual,
                            QV_MAX, k, tres, w=band,
                            min_score_open=MIN_SCORE_OPEN)
    np.testing.assert_array_equal(got.scalars.numpy(),
                                  np.asarray(want.scalars))
    np.testing.assert_array_equal(got.seq_packed.numpy(),
                                  np.asarray(want.seq_packed))


@pytest.mark.parametrize("case", list(TP.CASES))
def test_finish_bundle_ignores_masks_past_tgt_len(case):
    """Random masks written into tgt_masks past each region's tgt_len (the
    engine's batches hold zeros there) change neither package's decisions:
    the finish kernel stops at tgt_len and must not depend on them."""
    corr, jrb, lmax, band, res = TP.beam_case(case)
    k = corr.cdbg.k
    masks = np.asarray(jrb.tgt_masks).copy()
    rng = np.random.default_rng(11)
    for r, n in enumerate(np.asarray(jrb.tgt_len)):
        masks[r, n:] = 1 << rng.integers(0, 4, masks.shape[1] - n)
    assert (masks != np.asarray(jrb.tgt_masks)).any()
    want = JFN.finish_bundle(jnp.asarray(masks), jrb.tgt_len, jrb.tgt_qual,
                             jnp.int32(QV_MAX), jnp.int32(k), res, w=band,
                             min_score_open=MIN_SCORE_OPEN)
    trb = TP.to_torch_regions(jrb)
    tres = TBM.BeamResult(**{f: torch.tensor(np.asarray(getattr(res, f)))
                             for f in TBM.FIELDS})
    got = TFN.finish_bundle(torch.tensor(masks), trb.tgt_len, trb.tgt_qual,
                            QV_MAX, k, tres, w=band,
                            min_score_open=MIN_SCORE_OPEN)
    clean = TFN.finish_bundle(trb.tgt_masks, trb.tgt_len, trb.tgt_qual,
                              QV_MAX, k, tres, w=band,
                              min_score_open=MIN_SCORE_OPEN)
    np.testing.assert_array_equal(got.scalars.numpy(),
                                  np.asarray(want.scalars))
    np.testing.assert_array_equal(got.scalars.numpy(), clean.scalars.numpy())
    np.testing.assert_array_equal(got.seq_packed.numpy(),
                                  np.asarray(want.seq_packed))


@pytest.mark.parametrize("case", list(TP.WIDE))
def test_finish_bundle_wide_bands_match_jax(case):
    """The finish at band_width=600 (2048 bucket) and at the 569-column
    full path row of weak_region_len_factor=0.6 (256 bucket)."""
    corr, jrb, lmax, band, res = TP.wide_case(case)
    if not band:
        assert lmax + 1 == 569
    k = corr.cdbg.k
    want = JFN.finish_bundle(jrb.tgt_masks, jrb.tgt_len, jrb.tgt_qual,
                             jnp.int32(QV_MAX), jnp.int32(k), res, w=band,
                             min_score_open=MIN_SCORE_OPEN)
    trb = TP.to_torch_regions(jrb)
    tres = TBM.BeamResult(**{f: torch.tensor(np.asarray(getattr(res, f)))
                             for f in TBM.FIELDS})
    got = TFN.finish_bundle(trb.tgt_masks, trb.tgt_len, trb.tgt_qual,
                            QV_MAX, k, tres, w=band,
                            min_score_open=MIN_SCORE_OPEN)
    np.testing.assert_array_equal(got.scalars.numpy(),
                                  np.asarray(want.scalars))
    np.testing.assert_array_equal(got.seq_packed.numpy(),
                                  np.asarray(want.seq_packed))


@pytest.mark.parametrize("shape", list(FC.SHAPES))
def test_finish_bundle_synthetic_matches_jax(shape):
    """Synthetic regions (tests/finish_cases.py) that reach every case of
    the band's window: an empty path, best_len + 1 < W, a path filling L,
    a short target, windows clamped at both ends, N masks; bands of 1 to
    2,100 columns and full path rows of 389 and 1,100. Both packages'
    finish_bundle, all scalars and the packed paths (tolerance 0)."""
    NT, L, w = FC.SHAPES[shape]
    arrs = FC.finish_case(sum(map(ord, shape)), NT, L)
    W = L + 1 if w <= 0 or w >= L + 1 else w
    blen, tlen = arrs["best_len"], arrs["tgt_len"]
    ws_hi = np.maximum(blen + 1 - W, 0)
    if W < L + 1:
        # some window clamps at both ends, and some path is shorter than W
        assert ((ws_hi > 0) & (tlen - W // 2 > ws_hi)).any()
        assert W == 1 or (blen[1:] + 1 < W).any()
    jres = JBM.BeamResult(**{f: jnp.asarray(arrs[f]) for f in TBM.FIELDS})
    want = JFN.finish_bundle(jnp.asarray(arrs["tgt_masks"]),
                             jnp.asarray(tlen), jnp.asarray(arrs["tgt_qual"]),
                             jnp.int32(QV_MAX), jnp.int32(21), jres, w=w,
                             min_score_open=MIN_SCORE_OPEN)
    tres = TBM.BeamResult(**{f: torch.tensor(arrs[f]) for f in TBM.FIELDS})
    got = TFN.finish_bundle(torch.tensor(arrs["tgt_masks"]),
                            torch.tensor(tlen),
                            torch.tensor(arrs["tgt_qual"]), QV_MAX, 21, tres,
                            w=w, min_score_open=MIN_SCORE_OPEN)
    np.testing.assert_array_equal(got.scalars.numpy(),
                                  np.asarray(want.scalars))
    np.testing.assert_array_equal(got.seq_packed.numpy(),
                                  np.asarray(want.seq_packed))


def test_finish_kernel_wrapper_takes_the_plain_version_on_cpu():
    """On CPU tensors finish_bundle_kernel is finish_bundle (no launch); any
    other device gets the kernel or an error."""
    from ratatosk_tpu_torch.ops.finish_kernel import finish_bundle_kernel
    corr, jrb, lmax, band, res = TP.beam_case("nt512_band192")
    trb = TP.to_torch_regions(jrb)
    tres = TBM.BeamResult(**{f: torch.tensor(np.asarray(getattr(res, f)))
                             for f in TBM.FIELDS})
    args = (trb.tgt_masks, trb.tgt_len, trb.tgt_qual, QV_MAX, corr.cdbg.k,
            tres)
    kw = dict(w=band, min_score_open=MIN_SCORE_OPEN)
    before = finish_bundle_kernel.launches
    got = finish_bundle_kernel(*args, **kw)
    assert finish_bundle_kernel.launches == before
    want = TFN.finish_bundle(*args, **kw)
    assert torch.equal(got.scalars, want.scalars)
    assert torch.equal(got.seq_packed, want.seq_packed)
    meta = TBM.BeamResult(**{f: getattr(tres, f).to("meta")
                             for f in TBM.FIELDS})
    with pytest.raises(ValueError, match="no kernel"):
        finish_bundle_kernel(trb.tgt_masks.to("meta"),
                             trb.tgt_len.to("meta"),
                             trb.tgt_qual.to("meta"), QV_MAX, 21, meta, **kw)


def test_pack_unpack_roundtrip():
    codes = np.random.default_rng(5).integers(0, 4, (3, 37)).astype(np.uint8)
    packed = TFN.pack_codes(torch.tensor(codes))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(JFN.pack_codes(jnp.asarray(codes))))
    np.testing.assert_array_equal(TFN.unpack_codes(packed.numpy(), 37), codes)
