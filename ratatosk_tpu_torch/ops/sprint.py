"""Sprint band update of the beam search: the hand-written CUDA kernel
(csrc/sprint.cu) and its plain PyTorch version.

Counterpart of ratatosk_tpu/ops/sprint_pallas.py. `sprint_rows` keeps the JAX
signature: it advances every region's band rows by up to smax-1 masked
row updates of the E-transformed banded edit DP and returns (rwin', btgt').

A CPU tensor goes to `sprint_rows_ref`, the plain version. A CUDA tensor
launches the kernel, or raises: nothing falls back from the card. The kernel
library is built and loaded by ops/cuda_lib.py. The beam search launches this
kernel on its `impl="steps"` route, once per branch step.
"""

from __future__ import annotations

import torch

from ratatosk_tpu_torch.ops import cuda_lib

# the widest band the kernel takes, 32 columns a lane (csrc/sprint.cu:
# sprint_rows_max_width; cuda_lib checks the library's export against it
# once, at load): the beam kernel's cap, so the "steps" route takes every
# band the "auto" route takes
MAX_WIDTH = 1024

BIG = 1 << 20


def refuses(W: int):
    """Why the kernel cannot take a W-column band, or None: the one test of
    its width, which the wrapper and engine.check_kernel_widths make."""
    return None if 1 <= W <= MAX_WIDTH else \
        f"a {W}-column band (at most {MAX_WIDTH})"


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


@cuda_lib.counted
def sprint_rows(rwin, btgt, nb_all, newcols, wsall, m_reg, live, plen, *,
                smax: int):
    """Run the smax-1 masked band-row updates of one sprint.

    rwin [R,B,W] int32; btgt [R,W] int32 4-bit masks; nb_all [R,B,smax-1]
    int32 bases; newcols [R,smax-1] int32; wsall [R,smax] int32 window starts
    at path lengths pcount+j; m_reg [R] int32 sprint emissions per region;
    live [R,B] int32; plen [R,B] int32. Returns (rwin', btgt').
    """
    dev = rwin.device
    if dev.type == "cpu":
        return sprint_rows_ref(rwin, btgt, nb_all, newcols, wsall, m_reg,
                               live, plen, smax=smax)
    if dev.type != "cuda":
        raise ValueError(f"sprint_rows: no kernel for device {dev}")
    R, B, W = rwin.shape
    S1 = smax - 1
    for name, t, shape in (
            ("rwin", rwin, (R, B, W)), ("btgt", btgt, (R, W)),
            ("nb_all", nb_all, (R, B, S1)), ("newcols", newcols, (R, S1)),
            ("wsall", wsall, (R, smax)), ("m_reg", m_reg, (R,)),
            ("live", live, (R, B)), ("plen", plen, (R, B))):
        cuda_lib.check_tensor("sprint_rows", name, t, torch.int32, shape, dev)
    lib = cuda_lib.library()
    if refuses(W) or S1 < 1 or B < 1:
        raise ValueError(f"sprint_rows: unsupported shape R={R} B={B} W={W} "
                         f"smax={smax}")
    rwin_out = torch.empty_like(rwin)
    btgt_out = torch.empty_like(btgt)
    if R == 0:
        return rwin_out, btgt_out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.sprint_rows_launch(
        rwin.data_ptr(), btgt.data_ptr(), nb_all.data_ptr(),
        newcols.data_ptr(), wsall.data_ptr(), m_reg.data_ptr(),
        live.data_ptr(), plen.data_ptr(), rwin_out.data_ptr(),
        btgt_out.data_ptr(), R, B, W, S1,
        cuda_lib.device_index(dev), stream)
    if err != 0:
        raise RuntimeError(f"sprint_rows kernel launch failed: CUDA error "
                           f"{err} (R={R} B={B} W={W} smax={smax})")
    cuda_lib.add_launches(sprint_rows, stream)
    return rwin_out, btgt_out
