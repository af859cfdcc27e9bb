"""Sorted canonical-k-mer -> unitig index on the host: the port's
ops/kmer_index.py KmerIndex and its build, frozen (the device copy and its
search left out).

Keys are canonical k-mers: one uint64 word for k<=32, two (hi, lo) for k<=64.
Payload per key: (unitig_id, pos, strand) — position of the k-mer on its unitig
and whether the canonical form equals the unitig-forward k-mer at that position.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .keys import stable_argsort


@dataclasses.dataclass
class KmerIndex:
    """Sorted canonical-k-mer index: NumPy arrays on the host."""

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
        order = stable_argsort(keys_lo, keys_hi)
        idx = KmerIndex(
            k=k,
            keys_lo=keys_lo[order],
            keys_hi=None if keys_hi is None else keys_hi[order],
            unitig_id=unitig_id[order].astype(np.int32),
            pos=pos[order].astype(np.int32),
            strand=strand[order].astype(bool),
        )
        return idx
