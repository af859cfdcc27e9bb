"""Unmapped short-read rescue (`-u`).

Reference retrieveMissingReads (Graph.cpp:3857-4131): build a Bloom filter of
the mapped short reads' k-mers and a k31 DBG of the long reads; an unmapped
short read is "missing" if >= min_nb_km_unmapped (=31) of its k-mers occur in
the long-read graph but not in the short-read set — i.e. the locus exists in
the long reads but short-read mapping dropped it. Missing reads are appended
to the short-read input before index construction (Ratatosk.cpp:1040-1056).

TPU-native: both memberships are sorted-key lookups (ops/kmer_index.py-style
arrays) instead of Bloom filters — exact, vectorized, and reusing the
counting pipeline.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np

from ratatosk_tpu_torch.graph import build as B
from ratatosk_tpu_torch.graph.keys import KeyArray


def find_missing_reads(short_reads: Sequence[np.ndarray],
                       long_reads: Iterable[np.ndarray],
                       unmapped_reads: Sequence[np.ndarray],
                       k: int = 31,
                       min_count_lr: int = 2,
                       min_nb_km_unmapped: int = 31) -> List[int]:
    """Indices of unmapped reads worth rescuing."""
    sr_keys, _ = B.count_kmers(short_reads, k, min_count=1)
    lr_keys, _ = B.count_kmers(long_reads, k, min_count=min_count_lr)
    out: List[int] = []
    for i, codes in enumerate(unmapped_reads):
        if codes.shape[-1] < k:
            continue
        ka, valid = KeyArray.from_codes(codes, k)
        sel = np.flatnonzero(valid)
        if sel.size == 0:
            continue
        can, _ = ka.take(sel).canonical()
        in_lr = lr_keys.find(can) >= 0
        in_sr = sr_keys.find(can) >= 0
        if int((in_lr & ~in_sr).sum()) >= min_nb_km_unmapped:
            out.append(i)
    return out
