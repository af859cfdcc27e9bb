"""Color-set primitives: padded sorted-ID rows + intersection cardinality.

Replaces the reference's PairID/SharedPairID adaptive representations
(PairID.hpp:256-268: tiny bitmap / inline / single / roaring) and its
strategy-switching intersections (Common.cpp:51-364). On TPU one padded sorted
[., C] layout with masked vectorized binary search beats branchy adaptivity:
every unitig's color row has the same shape, so edge filtering and path
scoring batch over the whole beam at once.

Rows are int32, sorted ascending, padded with PAD (int32 max).
"""

from __future__ import annotations

import numpy as np

PAD = np.int32(np.iinfo(np.int32).max)


def make_rows(ids_per_row, cap: int) -> tuple[np.ndarray, np.ndarray]:
    """List of 1-D id arrays -> ([R, cap] sorted padded rows, [R] true card)."""
    rows = np.full((len(ids_per_row), cap), PAD, dtype=np.int32)
    card = np.zeros(len(ids_per_row), dtype=np.int32)
    for r, ids in enumerate(ids_per_row):
        ids = np.unique(np.asarray(ids, dtype=np.int32))
        card[r] = len(ids)
        rows[r, :min(len(ids), cap)] = ids[:cap]
    return rows, card


def _searchsorted_rows(b, q, xp):
    """Row-wise lower_bound: b [..., C] sorted, q [..., Q] -> int32 [..., Q]."""
    c = b.shape[-1]
    steps = max(1, int(np.ceil(np.log2(c + 1))))
    lo = xp.zeros(q.shape, dtype=xp.int32)
    hi = xp.full(q.shape, c, dtype=xp.int32)
    for _ in range(steps):
        mid = (lo + hi) >> 1
        bv = xp.take_along_axis(b, xp.minimum(mid, c - 1), axis=-1)
        go = bv < q
        lo = xp.where(go, mid + 1, lo)
        hi = xp.where(go, hi, mid)
    return lo


def contains_rows(b, q, xp):
    """Membership of each q in its row of b: bool [..., Q]. PAD never matches."""
    c = b.shape[-1]
    pos = _searchsorted_rows(b, q, xp)
    bv = xp.take_along_axis(b, xp.minimum(pos, c - 1), axis=-1)
    return (pos < c) & (bv == q) & (q != PAD)


def intersect_count(a, b, xp):
    """|A ∩ B| per row pair: a [..., Ca], b [..., Cb] sorted padded rows."""
    return contains_rows(b, a, xp).sum(axis=-1).astype(xp.int32)


SIG_BINS = 512


def color_signature(rows: np.ndarray, bins: int = SIG_BINS,
                    weights: np.ndarray | None = None) -> np.ndarray:
    """Hashed indicator signature of padded color rows: int8 [..., bins].

    sig[..., splitmix64(id) % bins] = 1 for each non-PAD id. Intersection
    cardinality is then a dot product of signatures — MXU work instead of
    per-lane searches in the beam inner loop. Counts are approximate upper
    bounds (ids colliding into one bin count once; unrelated sets overlap a
    bin with ~|A||B|/bins expectation), which is accurate enough for the
    >= min_cov edge filter (GraphTraversal.cpp:485-489).

    weights (optional, same shape as rows): per-id weight written into the
    id's bin (max on collision) — the WeightsPairID analog
    (Correction.cpp:417-427): dotting a unitig's 0/1 signature against a
    weighted region signature yields the weighted shared-read count.
    """
    from .kmers import splitmix64
    flat = rows.reshape(-1, rows.shape[-1])
    sig = np.zeros((flat.shape[0], bins), dtype=np.int8)
    valid = flat != PAD
    h = (splitmix64(flat.astype(np.uint64), np) % np.uint64(bins)).astype(np.int64)
    rid = np.broadcast_to(np.arange(flat.shape[0])[:, None], flat.shape)
    if weights is None:
        sig[rid[valid], h[valid]] = 1
    else:
        w = np.clip(weights.reshape(flat.shape), 0, 127).astype(np.int8)
        np.maximum.at(sig, (rid[valid], h[valid]), w[valid])
    return sig.reshape(rows.shape[:-1] + (bins,))


def intersect_count_sig(sig_a, sig_b, xp):
    """~|A ∩ B| from signatures: batched int8 dot -> int32 (MXU-friendly).

    sig_a [..., H], sig_b broadcastable [..., H].
    """
    return xp.sum(sig_a.astype(xp.int32) * sig_b.astype(xp.int32), axis=-1)


def intersect_count_dense(a, b, xp):
    """|A ∩ B| via the full equality matrix — the TPU inner-loop variant.

    Row-wise binary search (`contains_rows`) needs take_along_axis with
    per-lane indices, which lowers to cross-lane dynamic shuffles (~40ms for
    4k x 128 rows on v5e); the dense [., Ca, Cb] compare-and-reduce is pure
    VPU work and ~20x faster. a [..., Ca] and b [..., Cb] must broadcast on
    their prefix dims; b may be unsorted.
    """
    eq = a[..., :, None] == b[..., None, :]
    present = eq.any(-1) & (a != PAD)
    return present.sum(-1).astype(xp.int32)


def intersect_rows(a, b, xp):
    """A ∩ B as a padded sorted row set ([..., Ca])."""
    hit = contains_rows(b, a, xp)
    vals = xp.where(hit, a, PAD)
    return xp.sort(vals, axis=-1)


def union_rows(a, b, xp, cap: int):
    """A ∪ B truncated to cap ids ([..., cap])."""
    allv = xp.concatenate([a, b], axis=-1)
    s = xp.sort(allv, axis=-1)
    # drop duplicates: an element equal to its left neighbor becomes PAD
    dup = xp.concatenate(
        [xp.zeros_like(s[..., :1], dtype=bool), s[..., 1:] == s[..., :-1]], axis=-1)
    s = xp.where(dup, PAD, s)
    return xp.sort(s, axis=-1)[..., :cap]
