"""Short-repeat cycle detection.

Reference detectShortCycles (Graph.cpp:4659-4855): per-unitig BFS over
read-supported edges, total path <= 2k bp, must return to the start unitig on
the same strand with >= min_cov supporting reads on every inner unitig. The
reference stores materialized cycle strings and splices copies into candidate
paths when that lowers edit distance (fixRepeats, GraphTraversal.cpp:1149-1334).

Our beam search traverses cycles natively (no visited-set), so the annotation's
role here is (a) component parity, (b) letting the engine widen a region's
path-length budget when its anchors touch a cyclic unitig — tandem repeats can
legitimately need paths longer than the raw gap suggests.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .build import Cdbg
from .colors import GraphColors


def unitig_on_cycle(cdbg: Cdbg, u: int,
                    colors: Optional[GraphColors] = None,
                    max_len_factor: int = 2, min_cov: int = 2) -> bool:
    """True when unitig u lies on a read-supported cycle of <= 2k appended bp
    (single-unitig BFS; the engine queries anchors lazily and caches)."""
    k = cdbg.k
    max_bp = max_len_factor * k
    nk = cdbg.nkmers
    edges = cdbg.edges
    support = colors.edge_support if colors is not None else None
    card = colors.card if colors is not None else None
    start = (u << 1) | 0
    frontier = [(start, 0)]
    seen = set()
    while frontier:
        nxt = []
        for tip, dist in frontier:
            v, d = tip >> 1, tip & 1
            for c in range(4):
                e = edges[v, d, c]
                if e < 0:
                    continue
                if support is not None and not support[v, d, c]:
                    continue
                w = e >> 1
                if card is not None and w != u and card[w] < min_cov:
                    continue
                nd = dist + int(nk[w])
                if e == start:
                    return True
                if nd >= max_bp:
                    continue
                if e not in seen:
                    seen.add(e)
                    nxt.append((e, nd))
        frontier = nxt
    return False


def detect_short_cycles(cdbg: Cdbg, colors: Optional[GraphColors] = None,
                        max_len_factor: int = 2, min_cov: int = 2) -> np.ndarray:
    """bool [N]: unitig lies on a read-supported cycle of <= 2k appended bp.

    Matches the reference's bound (total path <= 2k bp, Graph.cpp:4723) and
    inner-coverage requirement (>= 2 reads per inner unitig, 4716-4720).
    """
    n = cdbg.n_unitigs
    on_cycle = np.zeros(n, dtype=bool)
    for u in range(n):
        on_cycle[u] = unitig_on_cycle(cdbg, u, colors,
                                      max_len_factor=max_len_factor,
                                      min_cov=min_cov)
    return on_cycle
