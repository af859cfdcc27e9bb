"""Host-side canonical-k-mer key sets, generic over 1-word (k<=32) and
2-word (k<=64) packed representations.

Used by graph construction (graph/build.py); mirrors the device-side compare
logic in ops/kmer_index.py.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ratatosk_tpu_torch.ops import kmers as K

_U2 = np.uint64(2)
_U62 = np.uint64(62)
_U3 = np.uint64(3)


@dataclasses.dataclass
class KeyArray:
    """Array of packed k-mers (not necessarily canonical or sorted)."""

    k: int
    lo: np.ndarray                 # uint64 [N]
    hi: Optional[np.ndarray]       # uint64 [N] or None

    @property
    def two_word(self) -> bool:
        return self.hi is not None

    def __len__(self) -> int:
        return int(self.lo.shape[0])

    @staticmethod
    def from_codes(codes: np.ndarray, k: int) -> tuple["KeyArray", np.ndarray]:
        """All k-mers of a base-code array. Returns (keys, valid)."""
        if k <= 32:
            lo, valid = K.pack_kmers(codes, k, np)
            return KeyArray(k, lo, None), valid
        hi, lo, valid = K.pack_kmers(codes, k, np)
        return KeyArray(k, lo, hi), valid

    def take(self, idx) -> "KeyArray":
        return KeyArray(self.k, self.lo[idx], None if self.hi is None else self.hi[idx])

    def concat(self, other: "KeyArray") -> "KeyArray":
        return KeyArray(
            self.k,
            np.concatenate([self.lo, other.lo]),
            None if self.hi is None else np.concatenate([self.hi, other.hi]),
        )

    def canonical(self) -> tuple["KeyArray", np.ndarray]:
        """Returns (canonical keys, is_fw)."""
        if self.hi is None:
            can, is_fw = K.canonical_kmer(self.lo, self.k, np)
            return KeyArray(self.k, can, None), is_fw
        chi, clo, is_fw = K.canonical_kmer2(self.hi, self.lo, self.k, np)
        return KeyArray(self.k, clo, chi), is_fw

    def revcomp(self) -> "KeyArray":
        if self.hi is None:
            return KeyArray(self.k, K.revcomp_kmer(self.lo, self.k, np), None)
        rhi, rlo = K.revcomp_kmer2(self.hi, self.lo, self.k, np)
        return KeyArray(self.k, rlo, rhi)

    def shift_append(self, c) -> "KeyArray":
        """Append base c on the right, dropping the leftmost base."""
        c = np.uint64(c) if np.isscalar(c) else c.astype(np.uint64)
        if self.hi is None:
            lo = ((self.lo << _U2) | c) & K.kmer_mask(self.k)
            return KeyArray(self.k, lo, None)
        hi = ((self.hi << _U2) | (self.lo >> _U62)) & np.uint64((1 << (2 * self.k - 64)) - 1)
        lo = (self.lo << _U2) | c
        return KeyArray(self.k, lo, hi)

    def last_base(self) -> np.ndarray:
        return (self.lo & _U3).astype(np.uint8)

    def unpack(self) -> np.ndarray:
        """[N, k] uint8 code matrix (host/debug + unitig materialization)."""
        k = self.k
        out = np.empty((len(self), k), dtype=np.uint8)
        if self.hi is None:
            for j in range(k):
                out[:, j] = ((self.lo >> np.uint64(2 * (k - 1 - j))) & _U3).astype(np.uint8)
            return out
        for j in range(k - 32):
            out[:, j] = ((self.hi >> np.uint64(2 * (k - 33 - j))) & _U3).astype(np.uint8)
        for j in range(k - 32, k):
            out[:, j] = ((self.lo >> np.uint64(2 * (k - 1 - j))) & _U3).astype(np.uint8)
        return out

    def sort_order(self) -> np.ndarray:
        if self.hi is None:
            return np.argsort(self.lo, kind="stable")
        return np.lexsort((self.lo, self.hi))

    def dedupe_sorted(self) -> tuple["KeyArray", np.ndarray]:
        """On a sorted KeyArray: (unique keys, counts)."""
        if len(self) == 0:
            return self, np.zeros(0, dtype=np.int64)
        if self.hi is None:
            new = np.empty(len(self), dtype=bool)
            new[0] = True
            np.not_equal(self.lo[1:], self.lo[:-1], out=new[1:])
        else:
            new = np.empty(len(self), dtype=bool)
            new[0] = True
            new[1:] = (self.lo[1:] != self.lo[:-1]) | (self.hi[1:] != self.hi[:-1])
        starts = np.flatnonzero(new)
        counts = np.diff(np.append(starts, len(self)))
        return self.take(starts), counts

    def lower_bound(self, q: "KeyArray") -> np.ndarray:
        """Vectorized lower_bound of q in self (self must be sorted). int64 [Nq]."""
        if self.hi is None:
            return np.searchsorted(self.lo, q.lo, side="left")
        n = len(self)
        lo = np.zeros(len(q), dtype=np.int64)
        hi = np.full(len(q), n, dtype=np.int64)
        steps = max(1, int(np.ceil(np.log2(n + 1))))
        for _ in range(steps):
            mid = (lo + hi) >> 1
            m = np.minimum(mid, n - 1)
            khi, klo = self.hi[m], self.lo[m]
            go_right = (khi < q.hi) | ((khi == q.hi) & (klo < q.lo))
            lo = np.where(go_right, mid + 1, lo)
            hi = np.where(go_right, hi, mid)
        return lo

    def find(self, q: "KeyArray") -> np.ndarray:
        """Index of each q in sorted self, or -1. int64 [Nq]."""
        pos = self.lower_bound(q)
        n = len(self)
        safe = np.minimum(pos, max(n - 1, 0))
        if n == 0:
            return np.full(len(q), -1, dtype=np.int64)
        ok = (pos < n) & (self.lo[safe] == q.lo)
        if self.hi is not None:
            ok &= self.hi[safe] == q.hi
        return np.where(ok, safe, -1)
