"""Pass-2 rephasing: detect phase-inconsistent corrected segments and splice
the raw read back over them.

Re-expresses the reference's `phasing()` (Graph.cpp:869-1097, called per read
in pass 2 at Ratatosk.cpp:832) with the raw mates supplied via `-L`
(Ratatosk.cpp:774-802): pass-1 correction can splice the OTHER haplotype's
sequence through a het region; such a segment's unitig colors are shared with
a different read population than its flanks. The reference compares unitig
color sets >= insert_sz apart with TinyBloomFilter bit-sharing (t=0.85 of
bits); here the padded color rows are intersected directly (exact, vectorized)
— no Bloom filter needed, its only role was making that comparison cheap.

Inconsistent segments are mapped back to raw-read coordinates through the
NW alignment CIGAR and replaced by the raw bases, with quality demoted to the
raw floor (Graph.cpp:991-1094).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ratatosk_tpu_torch import dna
from ratatosk_tpu_torch.correct.seeds import find_runs
from ratatosk_tpu_torch.ops import cigar as CG
from ratatosk_tpu_torch.ops import colorset as CS


def phase_inconsistent_segments(cdbg, colors, codes: np.ndarray,
                                insert_sz: int = 500, t: float = 0.25,
                                min_card: int = 2) -> List[Tuple[int, int]]:
    """Read spans [a, b) whose mapped unitigs conflict with some mapped
    unitig >= insert_sz away.

    ALL far pairs are compared (Graph.cpp:936-986 compares every mapped pair
    >= insert-size apart): shared flank unitigs are colored by both
    haplotypes and agree with everything, so only block-vs-block comparisons
    carry phase signal — a chimeric read's two haplotype blocks mutually
    conflict, and splicing raw over every conflicted segment restores the
    read's own phase (the raw read is the arbiter). Similarity is one
    signature matmul over the mapped unitigs, not per-pair set intersections.
    """
    runs = find_runs(cdbg, codes)
    n = len(runs)
    if n < 3:
        return []
    uids = np.array([r.uid for r in runs])
    s = np.array([r.s for r in runs])
    e = np.array([r.e for r in runs])
    card = colors.card[uids].astype(np.int64)
    sig = CS.color_signature(colors.rows[uids]).astype(np.int32)
    inter = sig @ sig.T                                  # [n, n] ~|A∩B|
    denom = np.maximum(np.minimum(card[:, None], card[None, :]), 1)
    sim = inter / denom
    # compare pairs in the [insert_sz, 3*insert_sz] window: closer pairs are
    # trivially consistent, farther pairs share no colors even on a pure read
    # (coloring reads are finite-length)
    dist = np.abs(s[:, None] - s[None, :])
    far = (dist >= insert_sz) & (dist <= 3 * insert_sz)
    informative = (card >= min_card)
    valid = far & informative[:, None] & informative[None, :]
    low = valid & (sim < t)
    bad = low.any(axis=1) & informative
    segs: List[Tuple[int, int]] = []
    k = cdbg.k
    i = 0
    while i < n:
        if not bad[i]:
            i += 1
            continue
        j = i
        while j + 1 < n and bad[j + 1]:
            j += 1
        segs.append((int(s[i]), int(e[j] + k)))
        i = j + 1
    # coalesce segments separated by short consistent stretches (unitigs
    # shared by both haplotypes are blind to phase and interleave with the
    # informative ones inside one biological phase block)
    merged: List[Tuple[int, int]] = []
    for a, b in segs:
        if merged and a - merged[-1][1] <= insert_sz // 2:
            merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def rephase_read(cdbg, colors, raw: np.ndarray, corrected: np.ndarray,
                 qual: Optional[np.ndarray], insert_sz: int = 500,
                 t: float = 0.5, raw_qual_floor: int = 33):
    """Splice raw bases over phase-inconsistent corrected segments.

    Returns (codes, qual, n_spliced_segments)."""
    segs = phase_inconsistent_segments(cdbg, colors, corrected,
                                       insert_sz=insert_sz, t=t)
    if not segs:
        return corrected, qual, 0
    _, cig, b0, _ = CG.aln_cigar(dna.codes_to_masks(corrected),
                                 dna.codes_to_masks(raw), CG.NW)
    c2r = CG.query_target_map(cig, len(corrected), b0)
    out_parts: List[np.ndarray] = []
    q_parts: List[np.ndarray] = []
    cur = 0
    q = qual if qual is not None else np.full(len(corrected), raw_qual_floor,
                                              np.uint8)
    for a, b in segs:
        b = min(b, len(corrected))
        if a >= b or a < cur:
            continue
        # map corrected [a, b) to raw coords through the alignment
        seg_map = c2r[a:b]
        mapped = seg_map[seg_map >= 0]
        if mapped.size == 0:
            continue
        ra, rb = int(mapped.min()), int(mapped.max()) + 1
        out_parts.append(corrected[cur:a])
        q_parts.append(q[cur:a])
        out_parts.append(raw[ra:rb])
        q_parts.append(np.full(rb - ra, raw_qual_floor, np.uint8))
        cur = b
    out_parts.append(corrected[cur:])
    q_parts.append(q[cur:])
    codes = np.concatenate(out_parts)
    new_q = np.concatenate(q_parts)
    return codes, new_q, len(segs)
