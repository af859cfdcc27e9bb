"""Device-side finish statistics: banded target×path DP + acceptance (PyTorch).

Counterpart of ratatosk_tpu/correct/finish.py (see its docstring): a banded
edit DP of the raw target (rows) against the winning path (cols) yields
per-target-prefix minima `dmin[i]` and max-tie end columns `endcol[i]`; the
open-region acceptance, the partial-path trims and the 2-bit packing of the
winner follow, so a launch ships back as two arrays. The reference's
`lax.scan` over target rows is a Python loop over device tensors here; the
float gates stay separate torch ops in the reference's order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

BIG = 1 << 20
_I32 = torch.int32


@dataclasses.dataclass
class FinishOut:
    """Per-region finish decisions; every field is [R] (one transfer)."""

    scalars: torch.Tensor     # int32 [R, 11]; see SCALAR_FIELDS
    seq_packed: torch.Tensor  # int32 [R, ceil(L/16)] 2-bit-packed best path


SCALAR_FIELDS = (
    "best_len", "best_dist", "best_end", "second_dist", "completed",
    "istar", "jend_open", "s1_open_m", "ok_open",
    "pdist", "pjend",
)
_M = 1_000_000  # fixed-point scale for fractional scalars


def pack_codes(seq: torch.Tensor) -> torch.Tensor:
    """uint8 2-bit codes [R, L] -> int32 [R, ceil(L/16)] (16 codes/word)."""
    R, L = seq.shape
    Lp = -(-L // 16) * 16
    s = torch.zeros((R, Lp), dtype=torch.int64, device=seq.device)
    s[:, :L] = seq
    sh = 2 * torch.arange(16, dtype=torch.int64, device=seq.device)
    # the sum fits in 32 bits; the cast keeps its bit pattern
    return (s.reshape(R, Lp // 16, 16) << sh).sum(dim=-1).to(_I32)


def unpack_codes(packed, L: int):
    """NumPy-side unpack: int32 [R, W] -> uint8 [R, L]."""
    p = np.asarray(packed).astype(np.uint32)
    R, Wn = p.shape
    sh = (2 * np.arange(16, dtype=np.uint32))[None, None, :]
    codes = ((p[:, :, None] >> sh) & 3).astype(np.uint8)
    return codes.reshape(R, Wn * 16)[:, :L]


def _window_start(i: int, seq_len, l1: int, w: int):
    """Band window start over path columns at target row i (per region)."""
    if w >= l1:
        return torch.zeros(seq_len.shape, dtype=_I32, device=seq_len.device)
    hi = (seq_len + 1 - w).clamp_min(0)
    return hi.clamp_max(max(i - w // 2, 0)).to(_I32)


def _banded_prefix_scan(tgt_masks, tgt_len, seq_codes, seq_len, w: int):
    """Banded DP rows of target (query) vs path (target-of-DP).

    Returns (dmin [R, NT+1], endcol [R, NT+1]): per-target-prefix minimum
    edit distance over path-prefix columns <= seq_len, and the max tie
    column. Row semantics match ops/cigar.dp_matrix(tgt, seq, NW).
    """
    R, NT = tgt_masks.shape
    L = seq_codes.shape[1]
    l1 = L + 1
    W = l1 if w <= 0 or w >= l1 else w
    dev = tgt_masks.device
    seq_masks = 1 << seq_codes.to(_I32).clamp(0, 3)
    # column j compares against seq[j-1]; pad col 0 with mask 0
    padded = torch.cat([torch.zeros((R, 1), dtype=_I32, device=dev),
                        seq_masks], dim=1)                     # [R, L+1]
    cols0 = torch.arange(W, dtype=_I32, device=dev)[None, :]   # window offsets
    big = torch.full((R, 1), BIG, dtype=_I32, device=dev)
    tmask = tgt_masks.to(_I32)

    def stats(row, cols):
        valid = cols <= seq_len[:, None]
        masked = torch.where(valid, row, BIG)
        dmin = masked.amin(dim=1)
        is_min = masked == dmin[:, None]
        endc = torch.where(is_min, cols, -1).amax(dim=1)
        return dmin, endc

    ws = _window_start(0, seq_len, l1, W)
    row = ws[:, None] + cols0                                  # E[0][j] = j
    btgt = padded.gather(1, (ws[:, None] + cols0).clamp_max(L).long())
    d0, e0 = stats(row, row)
    dmins, endcs = [d0], [e0]
    for i in range(1, NT + 1):
        ws_next = _window_start(i, seq_len, l1, W)
        adv = (ws_next - ws)[:, None] == 1
        # advance the carried seq-mask window by the newly-exposed column
        fetch = (ws_next + (W - 1)).clamp_max(L)[:, None]
        shifted = torch.cat([btgt[:, 1:], padded.gather(1, fetch.long())],
                            dim=1)
        btgt = torch.where(adv, shifted, btgt)
        prev_j = torch.where(adv, torch.cat([row[:, 1:], big], dim=1), row)
        prev_jm1 = torch.where(adv, row, torch.cat([big, row[:, :-1]], dim=1))
        amask = tmask[:, min(i - 1, NT - 1)]
        sub = ((amask[:, None] & btgt) == 0).to(_I32)
        cols = ws_next[:, None] + cols0
        d = torch.minimum(prev_jm1 + sub, prev_j + 1)
        d = torch.where(cols == 0, i, d)
        row = (cols + torch.cummin(d - cols, dim=1).values).clamp_max(BIG)
        dmin, endc = stats(row, cols)
        dmins.append(dmin)
        endcs.append(endc)
        ws = ws_next
    return (torch.stack(dmins, dim=1).to(_I32),
            torch.stack(endcs, dim=1).to(_I32))


def finish_bundle(tgt_masks, tgt_len, tgt_qual, qv_max: int, min_k: int,
                  res, *, w: int, min_score_open: float,
                  score_dtype=torch.float32) -> FinishOut:
    """Chain after beam_search: all finish decisions in one device pass.

    tgt_qual: int32 [R, NT] clipped linear qualities (q - 33, 0 when absent);
    res: BeamResult. score_dtype: the type of the float gates and scores
    (float32; lower for the benchmark's control).
    """
    R, NT = tgt_masks.shape
    dev = tgt_masks.device
    n = tgt_len
    blen = res.best_len
    dmin, endcol = _banded_prefix_scan(tgt_masks, n, res.best_seq, blen, w)

    i_ax = torch.arange(NT + 1, dtype=_I32, device=dev)[None, :]
    qv = torch.tensor(float(qv_max), dtype=score_dtype, device=dev)
    # mean certified quality of each target prefix (engine.gate_for)
    qc = torch.minimum(tgt_qual.to(score_dtype), qv)
    qcum = torch.cumsum(qc, dim=1)
    qcum = torch.cat([torch.zeros((R, 1), dtype=score_dtype, device=dev),
                      qcum], dim=1)
    qmean = qcum / i_ax.to(score_dtype).clamp_min(1.0)
    gate = torch.maximum(
        torch.tensor(min_score_open, dtype=score_dtype, device=dev),
        qmean / qv.clamp_min(1.0))

    def at(x, idx):
        return x.gather(1, idx[:, None].long())[:, 0]

    nn = n.clamp_min(1)
    s1_full = 1.0 - at(dmin, n).to(score_dtype) / nn.to(score_dtype)
    accept_full = s1_full >= at(gate, n)

    valid_i = i_ax <= n[:, None]
    pscore = torch.where(
        valid_i, i_ax.to(score_dtype) - 2.0 * dmin.to(score_dtype),
        float("-inf"))
    ibest = torch.argmax(pscore, dim=1).to(_I32)     # first index on ties
    istar = torch.where(accept_full, n, ibest)
    s1_open = (1.0 - at(dmin, istar).to(score_dtype)
               / istar.clamp_min(1).to(score_dtype))
    ok_open = (blen > 0) & (accept_full
                            | ((istar >= min_k) & (s1_open >= at(gate, istar))))
    jend_open = at(endcol, istar)
    ok_open = ok_open & (jend_open > 0)

    # partial trim for failed closed regions (engine._record_partial):
    # SHW(tgt[:end], seq) == row `end` of this DP
    end = res.best_end.clamp(0, NT)
    pdist = at(dmin, end)
    pjend = at(endcol, end)

    scalars = torch.stack([
        blen, res.best_dist, res.best_end, res.second_dist,
        res.completed.to(_I32),
        istar, jend_open, (s1_open * _M).to(_I32),
        ok_open.to(_I32),
        pdist, pjend,
    ], dim=1).to(_I32)
    return FinishOut(scalars=scalars, seq_packed=pack_codes(res.best_seq))
