"""Batched edit-distance DP: the port of ratatosk_tpu/ops/align.py, the
replacement for edlib.

Semantics follow edlib (reference src/edlib.h:36-62):
  NW  — global: query and target fully aligned.
  SHW — prefix: query fully aligned to a *prefix* of the target (gaps after
        the query's end are free); distance = min over the last row.
  HW  — infix: target prefix and suffix free; row 0 is all zeros.

The plain version keeps the JAX package's formulation: the within-row
dependence of
  E[i][j] = min(E[i-1][j]+1, E[i][j-1]+1, E[i-1][j-1]+sub)
dissolves into a prefix-min scan:
  D[j]    = min(E[i-1][j-1]+sub_j, E[i-1][j]+1),  D[0] = i
  E[i][j] = j + cummin_{l<=j}(D[l] - l)
one torch.cummin per query base, batched over pairs. IUPAC ambiguity costs
one AND: sequences are 4-bit base masks (dna.py) and sub_j = ((mask_a &
mask_b) == 0); a zero mask matches nothing.

`edit_distance(impl="auto")` calls the kernel's wrapper
(ops/align_kernel.py), which launches the hand-written CUDA kernel
(csrc/align.cu) on a CUDA tensor and runs the plain version on a CPU
tensor; impl="torch" runs the plain version anywhere.
Every result is int32.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NW, SHW, HW = 0, 1, 2
_BIG = 1 << 20
_I32_MIN = -(1 << 31)
IMPLS = ("auto", "torch")
_I32 = torch.int32


class AlignResult(NamedTuple):
    dist: torch.Tensor       # int32 [B]
    end: torch.Tensor        # int32 [B]: target end column (max among ties)
    end_min: torch.Tensor    # int32 [B]: min tie end column
    last_row: torch.Tensor   # int32 [B, N+1]: E[a_len][:] (masked cols = BIG)


def row_init(batch: int, n: int, mode: int, device=None) -> torch.Tensor:
    """E[0][:] — zeros for HW (free target prefix), 0..n otherwise."""
    if mode == HW:
        return torch.zeros((batch, n + 1), dtype=_I32, device=device)
    j = torch.arange(n + 1, dtype=_I32, device=device)
    return j[None, :].expand(batch, n + 1).contiguous()


def extend_rows(prev: torch.Tensor, a_mask: torch.Tensor,
                b_masks: torch.Tensor, row_number: torch.Tensor
                ) -> torch.Tensor:
    """One DP row step: append query base `a_mask` ([B] 4-bit masks).

    prev: [B, N+1] row E[i-1][:]; row_number: [B] the new row index i
    (1-based). Returns E[i][:].
    """
    sub = ((a_mask[:, None] & b_masks) == 0).to(_I32)           # [B, N]
    d = torch.minimum(prev[:, :-1] + sub, prev[:, 1:] + 1)        # D[1..N]
    d = torch.cat([row_number[:, None].to(_I32), d], dim=1)
    j = torch.arange(d.shape[1], dtype=_I32, device=d.device)[None, :]
    return j + torch.cummin(d - j, dim=1).values


def _masked_best(masked: torch.Tensor):
    """(min, last column of the min, first column of the min) per row."""
    j = torch.arange(masked.shape[1], dtype=_I32,
                     device=masked.device)[None, :]
    dist = masked.min(dim=1).values
    is_min = masked == dist[:, None]
    end_max = torch.where(is_min, j, -1).max(dim=1).values
    end_min = torch.where(is_min, j, _BIG).min(dim=1).values
    return dist, end_max.to(_I32), end_min.to(_I32)


def edit_distance_ref(a_masks: torch.Tensor, a_len: torch.Tensor,
                      b_masks: torch.Tensor, b_len: torch.Tensor,
                      mode: int = NW) -> AlignResult:
    """The plain version: one extend_rows per query column, the row at
    a_len captured (a pair whose a_len is 0 takes row 0; one whose a_len
    lies outside [0, M] is never captured and keeps BIG)."""
    bsz, m = a_masks.shape
    n = b_masks.shape[1]
    dev = a_masks.device
    a_len = a_len.to(_I32)
    b_len = b_len.to(_I32)
    row = row_init(bsz, n, mode, dev)
    captured = torch.where(a_len[:, None] == 0, row, _BIG)
    for i in range(m):
        row = extend_rows(row, a_masks[:, i], b_masks,
                          torch.full((bsz,), i + 1, dtype=_I32, device=dev))
        captured = torch.where(((i + 1) == a_len)[:, None], row, captured)
    j = torch.arange(n + 1, dtype=_I32, device=dev)[None, :]
    masked = torch.where(j <= b_len[:, None], captured, _BIG)
    if mode == NW:
        # the reference's take_along_axis: a negative b_len counts from the
        # row's end (once), and a column outside the row reads INT32_MIN
        at = torch.where(b_len < 0, b_len + (n + 1), b_len)
        dist = torch.gather(captured, 1, at.clamp(0, n).long()[:, None])[:, 0]
        dist = torch.where((at >= 0) & (at <= n), dist, _I32_MIN)
        return AlignResult(dist, b_len.clone(), b_len.clone(), masked)
    return AlignResult(*_masked_best(masked), masked)


def edit_distance(a_masks: torch.Tensor, a_len: torch.Tensor,
                  b_masks: torch.Tensor, b_len: torch.Tensor,
                  mode: int = NW, *, impl: str = "auto") -> AlignResult:
    """Batched edit distance.

    a_masks: [B, M] query 4-bit base masks (padding arbitrary)
    b_masks: [B, N] target masks; a_len/b_len: [B] true lengths.
    impl="auto": the CUDA kernel on a CUDA tensor (or a raise), the plain
    version on a CPU tensor; impl="torch": the plain version.
    """
    if impl not in IMPLS:
        raise ValueError(f"edit_distance: impl is one of {IMPLS}, not "
                         f"{impl!r}")
    if mode not in (NW, SHW, HW):
        raise ValueError(f"edit_distance: mode is NW, SHW or HW, not {mode}")
    if impl == "auto":
        # the wrapper decides: the plain version on a CPU tensor
        from ratatosk_tpu_torch.ops.align_kernel import edit_distance_kernel
        return edit_distance_kernel(a_masks, a_len, b_masks, b_len, mode)
    return edit_distance_ref(a_masks, a_len, b_masks, b_len, mode)


def best_prefix_from_row(last_row: torch.Tensor, b_len: torch.Tensor):
    """SHW answer from a carried row: (dist, end_max, end_min)."""
    n1 = last_row.shape[-1]
    j = torch.arange(n1, dtype=_I32, device=last_row.device)[None, :]
    masked = torch.where(j <= b_len[:, None], last_row, _BIG)
    return _masked_best(masked.to(_I32))
