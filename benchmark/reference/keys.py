"""Canonical-k-mer key sets, generic over 1-word (k<=32) and 2-word
(k<=64) packed representations: the port's graph/keys.py, frozen, with its
two bulk steps (the stable sort and the binary search) run by torch on the
card when there is one, on the host otherwise. torch has no unsigned 64-bit
order, so each uint64 word goes in as int64 with bit 63 flipped, whose
signed order is the words' unsigned order; a stable sort is the same
permutation on either side.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import kmers as K

_FLIP = np.uint64(1 << 63)


def _device() -> torch.device:
    return torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")


def _signed(words: np.ndarray) -> torch.Tensor:
    """uint64 words as order-preserving int64 on _device()."""
    return torch.from_numpy(
        np.ascontiguousarray(words ^ _FLIP).view(np.int64)).to(_device())


def stable_argsort(lo: np.ndarray, hi: Optional[np.ndarray]) -> np.ndarray:
    """np.argsort(lo, kind="stable") for one word, np.lexsort((lo, hi)) for
    two."""
    idx = torch.sort(_signed(lo), stable=True).indices
    if hi is not None:
        idx = idx[torch.sort(_signed(hi)[idx], stable=True).indices]
    return idx.cpu().numpy()

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
        return stable_argsort(self.lo, self.hi)

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
            return torch.searchsorted(_signed(self.lo), _signed(q.lo),
                                      side="left").cpu().numpy()
        n = len(self)
        if n == 0:
            return np.zeros(len(q), dtype=np.int64)
        s_hi, s_lo = _signed(self.hi), _signed(self.lo)
        q_hi, q_lo = _signed(q.hi), _signed(q.lo)
        lo = torch.zeros(len(q), dtype=torch.int64, device=q_lo.device)
        hi = torch.full((len(q),), n, dtype=torch.int64, device=q_lo.device)
        steps = max(1, int(np.ceil(np.log2(n + 1))))
        for _ in range(steps):
            mid = (lo + hi) >> 1
            m = mid.clamp_max(n - 1)
            khi, klo = s_hi[m], s_lo[m]
            go_right = (khi < q_hi) | ((khi == q_hi) & (klo < q_lo))
            lo = torch.where(go_right, mid + 1, lo)
            hi = torch.where(go_right, hi, mid)
        return lo.cpu().numpy()

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
