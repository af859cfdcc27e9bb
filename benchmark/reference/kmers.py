"""k-mer packing, canonicalization and hashing on uint64 words: the port's
ops/kmers.py, frozen, with the packing of a 1-D array's windows done by
doubling (the same words in fewer passes).

Layout:
  k <= 32 : one uint64 per k-mer; base j (leftmost) sits at bits 2*(k-1-j).
  k <= 64 : two uint64 (hi, lo); conceptual value = hi * 2^64 + lo, where `lo`
            packs the rightmost 32 bases and `hi` the remaining leftmost k-32.
            Lexicographic order on (hi, lo) == numeric order of the 2k-bit value.
"""

from __future__ import annotations

import numpy as np

_M2 = np.uint64(0x3333333333333333)
_M4 = np.uint64(0x0F0F0F0F0F0F0F0F)
_M8 = np.uint64(0x00FF00FF00FF00FF)
_M16 = np.uint64(0x0000FFFF0000FFFF)
_M32 = np.uint64(0x00000000FFFFFFFF)
_FULL = np.uint64(0xFFFFFFFFFFFFFFFF)


def kmer_mask(k: int) -> np.uint64:
    """Mask of the low 2k bits (k<=32)."""
    if k >= 32:
        return _FULL
    return np.uint64((1 << (2 * k)) - 1)


def reverse2bit64(x, xp):
    """Reverse the 32 2-bit groups of each uint64."""
    x = ((x >> np.uint64(2)) & _M2) | ((x & _M2) << np.uint64(2))
    x = ((x >> np.uint64(4)) & _M4) | ((x & _M4) << np.uint64(4))
    x = ((x >> np.uint64(8)) & _M8) | ((x & _M8) << np.uint64(8))
    x = ((x >> np.uint64(16)) & _M16) | ((x & _M16) << np.uint64(16))
    x = ((x >> np.uint64(32)) & _M32) | ((x & _M32) << np.uint64(32))
    return x


def revcomp_kmer(kmer, k: int, xp):
    """Reverse complement of packed k-mers, k<=32 (Bifrost Kmer::twin)."""
    x = (~kmer) & _FULL
    x = reverse2bit64(x, xp)
    s = 64 - 2 * k
    if s:
        x = x >> np.uint64(s)
    return x


def revcomp_kmer2(hi, lo, k: int, xp):
    """Reverse complement of two-word packed k-mers, 32 < k <= 64."""
    rlo = reverse2bit64((~lo) & _FULL, xp)   # reversed last-32 bases -> leftmost
    rhi = reverse2bit64((~hi) & _FULL, xp)   # reversed first k-32 bases -> rightmost
    # 128-bit value (rlo:rhi) >> (128 - 2k); 2k > 64 so shift s = 128-2k < 64.
    s = 128 - 2 * k
    if s == 0:
        return rlo, rhi
    new_hi = rlo >> np.uint64(s)
    new_lo = (rhi >> np.uint64(s)) | ((rlo << np.uint64(64 - s)) & _FULL)
    mask_hi = np.uint64((1 << (2 * k - 64)) - 1)
    return new_hi & mask_hi, new_lo


def canonical_kmer(kmer, k: int, xp):
    """(canonical, is_fw) where canonical = min(kmer, revcomp) (Kmer::rep)."""
    rc = revcomp_kmer(kmer, k, xp)
    is_fw = kmer <= rc
    return xp.where(is_fw, kmer, rc), is_fw


def canonical_kmer2(hi, lo, k: int, xp):
    rc_hi, rc_lo = revcomp_kmer2(hi, lo, k, xp)
    is_fw = (hi < rc_hi) | ((hi == rc_hi) & (lo <= rc_lo))
    return xp.where(is_fw, hi, rc_hi), xp.where(is_fw, lo, rc_lo), is_fw


def pack_kmers(codes, k: int, xp):
    """All k-mers of a code array, plus validity.

    codes: uint8/int32 [L] base codes (0-3 valid, >=4 invalid).
    Returns (kmers uint64 [L-k+1], valid bool [L-k+1]) for k<=32,
    or (hi, lo, valid) for 32<k<=64. Windows containing any invalid base are
    marked invalid (their packed bits are garbage — callers must mask).
    """
    L = codes.shape[-1]
    P = L - k + 1
    if P <= 0:
        raise ValueError(f"sequence length {L} < k={k}")
    c = codes.astype(xp.uint64) & np.uint64(3)
    inv = (codes >= 4)
    # valid[i] = no invalid base in codes[i:i+k]
    inv_i32 = inv.astype(xp.int32)
    cs = xp.cumsum(inv_i32, axis=-1)
    total = cs[..., k - 1:]            # inv count in first window shifted
    head = xp.concatenate([xp.zeros_like(cs[..., :1]), cs[..., :-1]], axis=-1)[..., :P]
    valid = (total - head) == 0
    if codes.ndim == 1:
        if k <= 32:
            return _pack_windows(c, k, P), valid
        return (_pack_windows(c, k - 32, P), _pack_windows(c[k - 32:], 32, P),
                valid)
    if k <= 32:
        acc = xp.zeros(codes.shape[:-1] + (P,), dtype=xp.uint64)
        for j in range(k):
            acc = acc | (c[..., j:j + P] << np.uint64(2 * (k - 1 - j)))
        return acc, valid
    # two-word: hi gets bases 0..k-33, lo gets bases k-32..k-1
    hi = xp.zeros(codes.shape[:-1] + (P,), dtype=xp.uint64)
    lo = xp.zeros(codes.shape[:-1] + (P,), dtype=xp.uint64)
    for j in range(k - 32):
        hi = hi | (c[..., j:j + P] << np.uint64(2 * (k - 33 - j)))
    for j in range(k - 32, k):
        lo = lo | (c[..., j:j + P] << np.uint64(2 * (k - 1 - j)))
    return hi, lo, valid


def _pack_windows(c: np.ndarray, n: int, P: int) -> np.ndarray:
    """words[i] = the n (<= 32) 2-bit codes c[i:i+n] packed, leftmost
    highest, for i < P: windows of 1, 2, 4, ... bases by doubling, then n's
    binary parts joined left to right."""
    pows = {1: c}
    m = 1
    while 2 * m <= n:
        x = pows[m]
        pows[2 * m] = (x[:-m] << np.uint64(2 * m)) | x[m:]
        m *= 2
    acc, off = None, 0
    for m in sorted(pows, reverse=True):
        if n & m:
            part = pows[m][off:off + P]
            acc = part if acc is None else (acc << np.uint64(2 * m)) | part
            off += m
    return acc


def unpack_kmer(kmer: int, k: int) -> np.ndarray:
    """Single packed k-mer (python int) -> uint8 code array (host/debug)."""
    out = np.empty(k, dtype=np.uint8)
    for j in range(k):
        out[j] = (int(kmer) >> (2 * (k - 1 - j))) & 3
    return out


def splitmix64(x, xp):
    """Invertible 64-bit mixer (splitmix64 finalizer) for table hashing."""
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & _FULL
    x = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & _FULL
    x = ((x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & _FULL
    return x ^ (x >> np.uint64(31))


def hash_kmer(kmer, xp):
    return splitmix64(kmer, xp)


def hash_kmer2(hi, lo, xp):
    return splitmix64(hi ^ splitmix64(lo, xp), xp)
