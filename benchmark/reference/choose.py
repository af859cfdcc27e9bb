"""Priority-class color selection for weak regions — the chooseColors analog.

Re-expresses the reference's `chooseColors` lambda + flank-anchor collection
(Correction.cpp:215-429, 476-585): instead of unioning just the two anchor
rows, a weak region is colored by the reads of the solid anchors within
±insert_sz of it, partitioned into priority classes and filled into one
capped row:

  1. reads of the region's own two anchors           (in-region)
  2. reads seen on BOTH flanks                       (strongest context)
  3. one-side reads from NON-branching flank unitigs
  4. one-side reads from branching flank unitigs

Per-unitig contributions are capped at FLANK_COV ids (the reference's
`cov=30` union cap, Correction.cpp:278-286) and flank collection stops after
MAX_BRANCHING branching unitigs per side (Correction.cpp:476-585). Reads from
non-branching unitigs get weight 2*max(n_unweighted/n_weighted, 1) — the
WeightsPairID weighting (Correction.cpp:417-427) — which flows into the
beam's color score through the weighted hashed signature
(ops/colorset.color_signature(weights=...)).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from . import colorset as CS

FLANK_COV = 30      # ids contributed per flank unitig (Correction.cpp:278-286)
MAX_BRANCHING = 5   # branching unitigs collected per side (Correction.cpp:476+)


def branching_mask(edge_support: np.ndarray) -> np.ndarray:
    """bool [N]: unitig has >=2 read-supported successors or predecessors
    (the UnitigData branching flag, Graph.cpp:1986-2021)."""
    per_dir = edge_support.sum(axis=2)
    return (per_dir >= 2).any(axis=1)


def _flank_uids(runs, start: int, step: int, pos_lo: int, pos_hi: int,
                branching: np.ndarray) -> List[int]:
    """Unitigs of runs walking from `start` by `step` while the run lies
    inside [pos_lo, pos_hi]; stops after MAX_BRANCHING branching unitigs."""
    out: List[int] = []
    n_branch = 0
    j = start
    while 0 <= j < len(runs):
        r = runs[j]
        if r.e < pos_lo or r.s > pos_hi:
            break
        out.append(r.uid)
        if branching[r.uid]:
            n_branch += 1
            if n_branch >= MAX_BRANCHING:
                break
        j += step
    return out


def _u30(colors, u: int) -> frozenset:
    """First FLANK_COV ids of a unitig's row, cached (static per run)."""
    cache = getattr(colors, "_u30_cache", None)
    if cache is None:
        cache = {}
        colors._u30_cache = cache
    got = cache.get(u)
    if got is None:
        r = colors.rows[u][:FLANK_COV]
        got = frozenset(int(x) for x in r[r != CS.PAD])
        cache[u] = got
    return got


def choose_region_colors(runs, li: Optional[int], ri: Optional[int],
                         raw_a: int, raw_b: int, colors, branching: np.ndarray,
                         insert_sz: int, cap: Optional[int] = None,
                         km_cov: Optional[np.ndarray] = None,
                         max_km_cov: float = float("inf")
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Color row + per-id weights for the weak region [raw_a, raw_b).

    runs: the read's position-sorted SolidRun list; li/ri: indices of the
    left/right anchor runs (None when the region is open on that side).
    Unitigs at repeat coverage (km_cov >= max_km_cov) contribute no colors
    (Correction.cpp:487,509,532,554 gate on getKmerCoverage < max_km_cov).
    Returns (row [cap] sorted PAD-padded, weights [cap] int8).

    Hot planner path: set algebra over cached <=FLANK_COV-id frozensets —
    Python set ops on small sets are ~5x cheaper than the many tiny
    np.unique/isin/intersect1d calls they replace.
    """
    cap = cap or colors.cap

    def uni(uids) -> set:
        out: set = set()
        for u in set(uids):
            if km_cov is None or km_cov[u] < max_km_cov:
                out |= _u30(colors, u)
        return out

    anchor_uids = [runs[i].uid for i in (li, ri) if i is not None]
    in_region = uni(anchor_uids)
    if not in_region and anchor_uids:
        # both anchors at repeat coverage: keep their colors anyway — an
        # empty region color set would kill every beam branch
        for u in set(anchor_uids):
            in_region |= _u30(colors, u)

    left_uids = (_flank_uids(runs, li - 1, -1, raw_a - insert_sz, raw_a,
                             branching) if li is not None and li > 0 else [])
    right_uids = (_flank_uids(runs, ri + 1, +1, raw_b, raw_b + insert_sz,
                              branching)
                  if ri is not None and ri + 1 < len(runs) else [])
    left_ids = uni(left_uids)
    right_ids = uni(right_uids)
    nb_ids = uni([u for u in left_uids + right_uids if not branching[u]])

    # weighted class: reads of non-branching unitigs (incl. non-branching
    # anchors); weight = 2 * max(n_unweighted / n_weighted, 1), saturated
    weighted_ids = nb_ids | uni([u for u in anchor_uids if not branching[u]])

    all_ids = in_region | left_ids | right_ids
    if len(all_ids) <= cap:
        # every candidate fits: the priority classes only order the
        # truncation, and the row is value-sorted anyway
        taken = sorted(all_ids)
    else:
        both = left_ids & right_ids
        one_side = (left_ids | right_ids) - both
        one_nb = one_side & nb_ids
        one_br = one_side - one_nb
        taken = []
        seen: set = set()
        for ids in (in_region, both, one_nb, one_br):
            for x in sorted(ids):
                if x not in seen:
                    seen.add(x)
                    taken.append(x)
                    if len(taken) >= cap:
                        break
            if len(taken) >= cap:
                break
    n = len(taken)
    n_w = sum(1 for x in taken if x in weighted_ids)
    n_u = n - n_w
    w_hi = min(2 * max(n_u // max(n_w, 1), 1), 8)
    taken.sort()
    row = np.full(cap, CS.PAD, dtype=np.int32)
    wts = np.zeros(cap, dtype=np.int8)
    row[:n] = taken
    wts[:n] = [w_hi if x in weighted_ids else 1 for x in taken]
    return row, wts
