"""Port's finish bundle (ratatosk_tpu_torch/correct/finish.py) against the
JAX package's finish_bundle, both fed the same JAX BeamResult. The decision
scalars and the packed winner paths must be identical (tolerance 0)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratatosk_tpu.correct import finish as JFN
from ratatosk_tpu_torch.correct import beam as TBM
from ratatosk_tpu_torch.correct import finish as TFN
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


def test_pack_unpack_roundtrip():
    codes = np.random.default_rng(5).integers(0, 4, (3, 37)).astype(np.uint8)
    packed = TFN.pack_codes(torch.tensor(codes))
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(JFN.pack_codes(jnp.asarray(codes))))
    np.testing.assert_array_equal(TFN.unpack_codes(packed.numpy(), 37), codes)
