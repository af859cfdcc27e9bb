"""128-bit (two-word) helpers for device k-mer surgery, on int64 tensors.

Port of ratatosk_tpu/ops/u128.py. A value is a (hi, lo) pair of int64
tensors holding the bit patterns of two uint64 words: hi * 2^64 + lo. torch's
uint64 support is partial (no shifts or comparisons on the CPU), so the
words live in int64 and every right shift is made logical by masking off the
sign fill. Left shifts wrap, as uint64 shifts do.

The reference scans the edit position with `lax.scan`, so its shift amounts
are traced scalars. The port's probe loops over edit positions in Python
(ops/plan_device.py), so here every shift amount, position and base is a
Python int in [0, 128], and each out-of-range case is decided on the host.
"""

from __future__ import annotations

import torch

_U64 = (1 << 64) - 1


def shr64(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical x >> s of int64-held uint64 words; 0 when s >= 64."""
    if s >= 64:
        return torch.zeros_like(x)
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def shl64(x: torch.Tensor, s: int) -> torch.Tensor:
    """x << s, truncated to 64 bits; 0 when s >= 64."""
    if s >= 64:
        return torch.zeros_like(x)
    return x << s


def shr128(hi, lo, s: int):
    """(hi, lo) >> s."""
    if s >= 64:
        return torch.zeros_like(hi), shr64(hi, s - 64)
    return shr64(hi, s), shr64(lo, s) | shl64(hi, 64 - s)


def shl128(hi, lo, s: int):
    """(hi, lo) << s (result truncated to 128 bits)."""
    if s >= 64:
        return shl64(lo, s - 64), torch.zeros_like(lo)
    return shl64(hi, s) | shr64(lo, 64 - s), shl64(lo, s)


def _split(v: int):
    """A 128-bit Python int -> (hi, lo): the int64 of each word's bits."""
    hi, lo = (v >> 64) & _U64, v & _U64
    return tuple(w - (1 << 64) if w >> 63 else w for w in (hi, lo))


def mask128(n: int):
    """Low-n-bits mask as (hi, lo) int64 constants; n in [0, 128]."""
    return _split((1 << n) - 1)


def set_base(hi, lo, m: int, p: int, b: int):
    """Base p (leftmost = 0) of m-base windows set to b."""
    s = 2 * (m - 1) - 2 * p
    mh, ml = _split(3 << s)
    bh, bl = _split(b << s)
    return (hi & ~mh) | bh, (lo & ~ml) | bl


def get_base(hi, lo, m: int, p: int):
    _, low = shr128(hi, lo, 2 * (m - 1) - 2 * p)
    return low & 3


def drop_base(hi, lo, m: int, p: int):
    """Drop base p of m-base windows -> (m-1)-base windows."""
    uh, ul = shr128(hi, lo, 2 * m - 2 * p)
    mh, ml = mask128(2 * (m - 1) - 2 * p)
    sh, sl = shl128(uh, ul, 2 * (m - 1) - 2 * p)
    return sh | (hi & mh), sl | (lo & ml)


def insert_base(hi, lo, m: int, p: int, b: int):
    """Insert base b before index p of m-base windows -> (m+1)-base windows."""
    uh, ul = shr128(hi, lo, 2 * m - 2 * p)
    mh, ml = mask128(2 * m - 2 * p)
    sh, sl = shl128(uh, ul, 2 * m - 2 * p + 2)
    bh, bl = _split(b << (2 * m - 2 * p))     # truncated to 128 bits
    return sh | bh | (hi & mh), sl | bl | (lo & ml)
