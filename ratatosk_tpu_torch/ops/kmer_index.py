"""Sorted canonical-k-mer -> unitig index (host arrays).

Replaces Bifrost's minimizer-indexed hash table (`CompactedDBG::find`,
`findUnitig`, `searchSequence(exact)` — SURVEY.md §2.3) with a sorted canonical
key array. Lookup = ceil(log2(N+1)) branchless gathers over all query
k-mers at once, on the device the index was copied to (`to_device`); the
engine's planner looks k-mers up on the host (native/kmers.cpp) or through
the device planner's hash index (ops/hash_index.py).

torch has no unsigned 64-bit comparisons, so a device copy holds each
uint64 word as int64 with bit 63 flipped, whose signed order is the keys'
unsigned order; queries are flipped the same way before any comparison,
which leaves equality as it was. parallel/sharded_index.py searches each of
its shards with the same `search`.

Keys are canonical k-mers: one uint64 word for k<=32, two (hi, lo) for k<=64.
Payload per key: (unitig_id, pos, strand) — position of the k-mer on its unitig
and whether the canonical form equals the unitig-forward k-mer at that position.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

_FLIP = np.uint64(1 << 63)


@dataclasses.dataclass
class KmerIndex:
    """Sorted canonical-k-mer index: NumPy arrays on the host, or torch
    tensors on a device (`to_device`: keys as flipped int64), which
    `lookup` searches."""

    k: int
    keys_lo: np.ndarray            # [N] uint64 (the only word when k<=32)
    keys_hi: Optional[np.ndarray]  # [N] uint64 or None
    unitig_id: np.ndarray          # [N] int32
    pos: np.ndarray                # [N] int32, k-mer offset on the unitig
    strand: np.ndarray             # [N] bool, canonical == forward k-mer at pos

    @property
    def n(self) -> int:
        return int(self.keys_lo.shape[0])

    @property
    def two_word(self) -> bool:
        return self.keys_hi is not None

    @staticmethod
    def build(k: int, keys_lo: np.ndarray, keys_hi: Optional[np.ndarray],
              unitig_id: np.ndarray, pos: np.ndarray, strand: np.ndarray) -> "KmerIndex":
        """Sort (host-side numpy) and wrap. Keys must be unique."""
        if keys_hi is None:
            order = np.argsort(keys_lo, kind="stable")
        else:
            order = np.lexsort((keys_lo, keys_hi))
        idx = KmerIndex(
            k=k,
            keys_lo=keys_lo[order],
            keys_hi=None if keys_hi is None else keys_hi[order],
            unitig_id=unitig_id[order].astype(np.int32),
            pos=pos[order].astype(np.int32),
            strand=strand[order].astype(bool),
        )
        return idx

    def to_device(self, device) -> "KmerIndex":
        """A copy on `device` (torch tensors): keys as int64 with bit 63
        flipped, unitig_id and pos int32, strand bool."""
        def put(x, dtype=None):
            return torch.from_numpy(np.ascontiguousarray(
                x if dtype is None else x.astype(dtype))).to(device)
        return KmerIndex(
            k=self.k,
            keys_lo=put(signed(self.keys_lo)),
            keys_hi=None if self.keys_hi is None else put(
                signed(self.keys_hi)),
            unitig_id=put(np.asarray(self.unitig_id), np.int32),
            pos=put(np.asarray(self.pos), np.int32),
            strand=put(np.asarray(self.strand), bool))


def signed(keys) -> np.ndarray:
    """uint64 keys -> int64 whose signed order is the keys' unsigned order."""
    return (np.asarray(keys, dtype=np.uint64) ^ _FLIP).view(np.int64)


def _steps(n: int) -> int:
    return max(1, int(np.ceil(np.log2(n + 1))))


def _lower_bound_1w(keys: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Branchless lower_bound of q in sorted keys (both flipped int64),
    ceil(log2(n+1)) steps; int32 positions."""
    n = keys.shape[0]
    lo = torch.zeros(q.shape, dtype=torch.int32, device=q.device)
    hi = torch.full(q.shape, n, dtype=torch.int32, device=q.device)
    for _ in range(_steps(n)):
        mid = (lo + hi) >> 1
        go_right = keys[mid.clamp(max=n - 1).long()] < q
        lo, hi = torch.where(go_right, mid + 1, lo), torch.where(go_right, hi,
                                                                 mid)
    return lo


def _lower_bound_2w(keys_hi, keys_lo, q_hi, q_lo) -> torch.Tensor:
    """The same for two-word keys ordered by (hi, lo)."""
    n = keys_lo.shape[0]
    lo = torch.zeros(q_lo.shape, dtype=torch.int32, device=q_lo.device)
    hi = torch.full(q_lo.shape, n, dtype=torch.int32, device=q_lo.device)
    for _ in range(_steps(n)):
        mid = (lo + hi) >> 1
        m = mid.clamp(max=n - 1).long()
        khi, klo = keys_hi[m], keys_lo[m]
        go_right = (khi < q_hi) | ((khi == q_hi) & (klo < q_lo))
        lo, hi = torch.where(go_right, mid + 1, lo), torch.where(go_right, hi,
                                                                 mid)
    return lo


def search(keys_lo: torch.Tensor, keys_hi: Optional[torch.Tensor],
           q_lo: torch.Tensor, q_hi: Optional[torch.Tensor]):
    """(row, found) of each query in sorted flipped-int64 keys (two words
    when keys_hi is given): the lower bound clamped to the last row (int32),
    and whether the key there is the query. The keys must not be empty."""
    n = keys_lo.shape[0]
    if keys_hi is None:
        pos = _lower_bound_1w(keys_lo, q_lo)
    else:
        pos = _lower_bound_2w(keys_hi, keys_lo, q_hi, q_lo)
    safe = pos.clamp(max=n - 1)
    sl = safe.long()
    found = (pos < n) & (keys_lo[sl] == q_lo)
    if keys_hi is not None:
        found = found & (keys_hi[sl] == q_hi)
    return safe, found


def lookup(index: KmerIndex, q_lo, q_hi=None, valid=None) -> torch.Tensor:
    """Find canonical-k-mer queries in a device copy of the index
    (`to_device`), on its device.

    q_lo / q_hi: NumPy uint64; valid: optional bool mask. Returns int32 row
    indices into the index arrays, -1 where absent (or where `valid` is
    False); shapes follow q_lo.
    """
    if not isinstance(index.keys_lo, torch.Tensor):
        raise TypeError("lookup takes a device copy of the index "
                        "(KmerIndex.to_device)")
    dev = index.keys_lo.device
    ql = torch.from_numpy(signed(q_lo)).to(dev)
    if index.n == 0:
        return torch.full(ql.shape, -1, dtype=torch.int32, device=dev)
    qh = None
    if index.two_word:
        if q_hi is None:
            raise ValueError("two-word index lookup requires q_hi")
        qh = torch.from_numpy(signed(q_hi)).to(dev)
    safe, found = search(index.keys_lo, index.keys_hi, ql, qh)
    if valid is not None:
        found = found & torch.as_tensor(valid, dtype=torch.bool, device=dev)
    return torch.where(found, safe, -1)
