"""Sprint band update of the beam search: the plain PyTorch version
(ops/sprint.py:sprint_rows_ref of the port), frozen.

It advances every region's band rows by up to smax-1 masked row updates of
the E-transformed banded edit DP and returns (rwin', btgt').
"""

from __future__ import annotations

import torch

BIG = 1 << 20


def sprint_rows_ref(rwin, btgt, nb_all, newcols, wsall, m_reg, live, plen, *,
                    smax: int):
    """Plain PyTorch sprint: the XLA fori-loop of beam._sprint_advance
    (ratatosk_tpu/correct/beam.py:282-322) over explicit substep masks."""
    R, B, W = rwin.shape
    cols0 = torch.arange(W, dtype=torch.int32, device=rwin.device)
    big = torch.full_like(rwin[..., :1], BIG)
    livem = live != 0
    for j in range(smax - 1):
        adv_r = j < m_reg                                        # [R]
        ws_n = wsall[:, j + 1]
        shift = (ws_n - wsall[:, j]) == 1                        # [R]
        shifted = torch.cat([btgt[:, 1:], newcols[:, j:j + 1]], dim=1)
        btgt = torch.where((shift & adv_r)[:, None], shifted, btgt)
        s3 = shift[:, None, None]
        shift_l = torch.cat([rwin[..., 1:], big], dim=-1)
        shift_r = torch.cat([big, rwin[..., :-1]], dim=-1)
        prev_j = torch.where(s3, shift_l, rwin)
        prev_jm1 = torch.where(s3, rwin, shift_r)
        bm = 1 << nb_all[:, :, j]
        sub = ((bm[..., None] & btgt[:, None, :]) == 0).to(torch.int32)
        cols = (ws_n[:, None] + cols0)[:, None, :]               # [R, 1, W]
        dd = torch.minimum(prev_jm1 + sub, prev_j + 1)
        dd = torch.where(cols == 0, (plen + (j + 1))[..., None], dd)
        dd = dd.clamp_max(BIG)
        ee = (cols + torch.cummin(dd - cols, dim=2).values).clamp_max(BIG)
        adv = livem & adv_r[:, None]
        rwin = torch.where(adv[..., None], ee, rwin)
    return rwin, btgt
