"""Pass-1 low-coverage edge rescue from the large-k graph.

Re-expresses the reference's addCoverage phase 7 (Graph.cpp:3085-3363): a
k31-graph edge whose endpoints share fewer than `min_cov` read colors — so
the edge-support filter would forbid the beam from crossing it — is rescued
when the two k-mers it joins are CONSECUTIVE inside one unitig of the k63
graph: long-k context proves the junction is genuine genome sequence. The
reference adds two fresh pseudo-read IDs to both endpoints
(Graph.cpp:3254-3270); we do the same (so the run-pair color filter and the
beam's >= min_cov checks see the junction as supported) and flip the edge's
support bit directly.

Vectorized: every k63 unitig sequence is looked up against the k31 index in
one batched pass (the same probe as read anchoring); junctions are positions
whose adjacent k-mers map to different k31 unitigs.
"""

from __future__ import annotations

import numpy as np

from ratatosk_tpu_torch.graph.build import Cdbg
from ratatosk_tpu_torch.graph.colors import GraphColors
from ratatosk_tpu_torch.ops import colorset as CS


def rescue_pass1_edges(cdbg: Cdbg, colors: GraphColors, cdbg_k2: Cdbg,
                       min_cov: int = 2) -> int:
    """Add pseudo-read support to low-color k31 edges proven by k63 unitigs.

    Mutates `colors` (edge_support, rows, card, n_colors). Returns the
    number of rescued edge slots.
    """
    from ratatosk_tpu_torch.graph.keys import KeyArray
    from ratatosk_tpu_torch.ops import native_kmers as NK

    k = cdbg.k
    parts = []
    sep = np.array([4], np.uint8)
    for u in range(cdbg_k2.n_unitigs):
        parts.append(cdbg_k2.unitig_codes(u))
        parts.append(sep)
    if not parts:
        return 0
    concat = np.concatenate(parts)

    if NK.available():
        rows, is_fw = NK.index_lookup(concat, k, cdbg.index)
    else:
        ka, valid = KeyArray.from_codes(concat, k)
        can, is_fw = ka.canonical()
        keys = KeyArray(k, np.asarray(cdbg.index.keys_lo),
                        np.asarray(cdbg.index.keys_hi)
                        if cdbg.index.two_word else None)
        rows = keys.find(can)
        rows[~valid] = -1
    hit = rows >= 0
    iuid = np.asarray(cdbg.index.unitig_id)
    ipos = np.asarray(cdbg.index.pos)
    istr = np.asarray(cdbg.index.strand)
    safe = np.maximum(rows, 0)
    uid = np.where(hit, iuid[safe], -1)
    direction = np.where(hit & (np.asarray(is_fw, bool) == istr[safe]), 0, 1)
    nk = cdbg.nkmers[np.maximum(uid, 0)]
    o = np.where(direction == 0, ipos[safe], nk - 1 - ipos[safe])

    # junctions: adjacent positions both hit, different unitigs, and the left
    # k-mer sits at its unitig's oriented end while the right sits at a start
    ju = (hit[:-1] & hit[1:] & (uid[:-1] != uid[1:])
          & (o[:-1] == nk[:-1] - 1) & (o[1:] == 0))
    j_idx = np.flatnonzero(ju)
    if j_idx.size == 0:
        return 0
    u1, d1 = uid[j_idx], direction[j_idx]
    u2, d2 = uid[j_idx + 1], direction[j_idx + 1]
    tips = (u2.astype(np.int64) << 1) | d2
    # resolve the edge slot c: edges[u1, d1, c] == tip(u2, d2)
    e_tbl = cdbg.edges[u1, d1]                       # [M, 4]
    cslot = np.argmax(e_tbl == tips[:, None], axis=1)
    ok = e_tbl[np.arange(len(u1)), cslot] == tips
    u1, d1, u2, d2, cslot = u1[ok], d1[ok], u2[ok], d2[ok], cslot[ok]
    if u1.size == 0:
        return 0

    # low-color edges only (the reference rescues < min_cov sharing)
    cnt = CS.intersect_count(colors.rows[u1], colors.rows[u2], np)
    low = cnt < min_cov
    u1, d1, u2, d2, cslot = (x[low] for x in (u1, d1, u2, d2, cslot))
    if u1.size == 0:
        return 0

    # dedupe (u1, d1, cslot)
    key = (u1.astype(np.int64) << 6) | (d1.astype(np.int64) << 2) | cslot
    _, first = np.unique(key, return_index=True)
    u1, d1, u2, d2, cslot = (x[first] for x in (u1, d1, u2, d2, cslot))

    if colors.edge_rescued is None:
        colors.edge_rescued = np.zeros_like(colors.edge_support)
    n_rescued = 0
    next_id = colors.n_colors
    for a, da, b, db, c in zip(u1, d1, u2, d2, cslot):
        colors.edge_support[a, da, c] = True
        colors.edge_rescued[a, da, c] = True
        # the mirror slot (b, db^1) -> (a, da^1)
        tip_back = (int(a) << 1) | (int(da) ^ 1)
        back = cdbg.edges[b, db ^ 1]
        cb = int(np.argmax(back == tip_back))
        if back[cb] == tip_back:
            colors.edge_support[b, db ^ 1, cb] = True
            colors.edge_rescued[b, db ^ 1, cb] = True
        # two fresh pseudo-read ids on BOTH endpoints (Graph.cpp:3254-3270);
        # full rows overwrite their largest sampled ids (pseudo ids are the
        # global maximum, so sorted order holds either way)
        ids = np.array([next_id, next_id + 1], dtype=np.int32)
        next_id += 2
        for u in (int(a), int(b)):
            row = colors.rows[u]
            vals = row[row != CS.PAD]
            if len(vals) > len(row) - 2:
                vals = vals[:len(row) - 2]
            row[:] = CS.PAD
            row[:len(vals)] = vals
            row[len(vals):len(vals) + 2] = ids
            colors.card[u] += 2
        n_rescued += 1
    colors.n_colors = next_id
    return n_rescued
