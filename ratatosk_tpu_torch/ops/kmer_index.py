"""Sorted canonical-k-mer -> unitig index (host arrays).

Replaces Bifrost's minimizer-indexed hash table (`CompactedDBG::find`,
`findUnitig`, `searchSequence(exact)` — SURVEY.md §2.3) with a sorted canonical
key array. The port keeps only the host dataclass and `build`: planning
looks k-mers up on the host (native/kmers.cpp), and the JAX package's device
lookup is a test oracle there.

Keys are canonical k-mers: one uint64 word for k<=32, two (hi, lo) for k<=64.
Payload per key: (unitig_id, pos, strand) — position of the k-mer on its unitig
and whether the canonical form equals the unitig-forward k-mer at that position.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class KmerIndex:
    """Sorted canonical-k-mer index (NumPy arrays)."""

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
