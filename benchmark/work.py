"""The least time the card could take for a launch of the port's two main
kernels: the work each launch's own data needs (chip_smoke.py's
finish_work and beam_work, frozen; beam_work steps through the reference's
plain beam search, reference/beam.py) over the H100's published peaks.

Peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet): HBM3 at
3.35 TB/s; int32 at 132 SMs x 64 lanes x 1.98 GHz (one int op a lane a
clock), as chip_smoke.py reckons it. A card set below 700 W runs under them:
the run reports the card's power limit beside every share.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import beam as BM
from benchmark.reference.sprint import sprint_rows_ref

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9

# int32 operations per band cell: the edit recurrence (substitution test,
# two adds, a min), the band stats a candidate's score reads (a compare and
# a min), the prefix-min scan of a row that is kept (subtract, min, add)
DP_OPS, STATS_OPS, SCAN_OPS = 5, 2, 3
# int32 operations per 32-column word of a bit-parallel DP row (Myers /
# Hyyro): the update, the row's match word, the word's share of the row
# minimum
MYERS_OPS, EQ_OPS, ROWMIN_OPS = 17, 1, 12


def bound_s(work: dict) -> float:
    """The larger of operations over the int32 peak and bytes over the HBM
    peak, in seconds."""
    return max(work["ops"] / INT32_OPS_PER_S, work["bytes"] / HBM_BYTES_PER_S)


def finish_work(tgt_len, scalars, *, lmax: int, nt: int, band: int,
                n_real: int) -> dict:
    """The work the finish bundle needs, from its inputs' target lengths and
    its own scalars (best_len in column 0, best_end in column 2): for each
    planned row, the DP rows 0..max(tgt_len, best_end) at min(W, best_len +
    1) columns each (no decision reads a column past best_len),
    bit-parallel: each row's ceil(columns / 32) words at MYERS_OPS + EQ_OPS
    + ROWMIN_OPS int32 operations each; bytes: the target masks and
    qualities those rows read, the path, the scalars in and out, the packed
    path out."""
    L = lmax
    Wf = L + 1 if band <= 0 or band >= L + 1 else band
    n = tgt_len[:n_real].long()
    last = torch.maximum(n, scalars[:n_real, 2].long().clamp(0, nt))
    blen = scalars[:n_real, 0].long()
    cols = (blen + 1).clamp_max(Wf)
    words = int(((last + 1) * ((cols + 31) // 32)).sum())
    nbytes = (int(last.sum()) + 4 * int(n.sum()) + int(blen.sum())
              + n_real * (21 + 11 * 4 + 4 * -(-L // 16)))
    return dict(ops=(MYERS_OPS + EQ_OPS + ROWMIN_OPS) * words, bytes=nbytes)


def beam_work(g, rb, *, beam: int, lmax: int, band: int, min_cov: int,
              n_real: int, smax: int = 8) -> dict:
    """The work the beam search needs on this batch, counted from a plain
    run step by step (untimed). Only the n_real planned rows count: padding
    rows are inert. A band row of region r costs its min(W, tgt_len+1)
    columns. While region r has a live unfrozen entry (its steps before f_r)
    it needs each live entry's sprint substep rows (recurrence and scan),
    the DP row and band stats of each valid candidate, the scan of each
    winner that emitted, the score of each valid candidate and a top-B
    selection of its 4B candidates (C log2 C compares), and the two color
    dot products and the popcount of each winner that took a branch; from
    the graph, each active entry's successor record and bases and each
    branching winner's color signature. Past f_r it needs at most one step,
    a re-rank of its kept entries (B log2 B compares), and only where T >
    f_r. Then one walk of min(T, f_r+1) steps back through the history."""
    R, NT = rb.tgt_masks.shape
    W, B, H = BM.band_width(NT, band), beam, g.color_sig.shape[1]
    dev = rb.tgt_masks.device
    real = torch.arange(R, device=dev) < n_real
    st, pt = BM._init_state(rb, B, lmax, W)
    f = torch.zeros(R, dtype=torch.int64, device=dev)
    n = torch.zeros((6, R), dtype=torch.int64, device=dev)
    t = 0
    while t < lmax and bool((st.live & ~st.frozen).any()):
        act = st.live & ~st.frozen & real[:, None]
        act_r = act.any(dim=1)
        uid = (st.tip >> 1).clamp(0, g.utbl.shape[0] - 1).long()
        rec = g.utbl[uid, (st.tip & 1).long()]
        s1, sbits, scnt = BM._sprint_advance(g, rb, pt, st, rec, smax,
                                             sprint_rows_ref)
        at_bound = act & (s1.off >= rec[..., 4])
        nsucc = (rec[..., :4] >= 0).sum(dim=-1)
        ncand = torch.where(at_bound, nsucc, act.long())
        s2 = BM._beam_step(g, rb, pt, s1, t, min_cov, rec, sbits, scnt)
        h = s2.hist[t]
        par = ((h >> 3) & 127).long()
        branch_w = act_r[:, None] & (s2.nvis > s1.nvis.gather(1, par))
        emit_w = act_r[:, None] & s2.live & (((h >> 2) & 1) == 1)
        sprint_n = torch.where(act, scnt, 0).sum(dim=1)
        n += torch.stack([
            sprint_n, ncand.sum(dim=1), emit_w.sum(dim=1),
            (at_bound & (nsucc == 0)).sum(dim=1), branch_w.sum(dim=1),
            24 * act.sum(dim=1) + sprint_n + (act & ~at_bound).sum(dim=1)
            + H * branch_w.sum(dim=1)])
        f += act_r
        st, t = s2, t + 1
    T = t
    cols = (rb.tgt_len.long() + 1).clamp(max=W)
    cand_rows = int(n[1].sum())
    sprint_cells, cand_cells, emit_cells, keep_cells = (
        (n[:4] * cols).sum(dim=1).tolist())
    n_branch, graph_bytes = (int(x) for x in n[4:].sum(dim=1).tolist())
    f_real = f[:n_real]
    active_steps = int(f_real.sum())
    keep_steps = int((f_real < T).sum())
    walk_steps = int((f_real + 1).clamp(max=T).sum())
    C = 4 * B
    ops = (sprint_cells * (DP_OPS + SCAN_OPS)
           + cand_cells * (DP_OPS + STATS_OPS)
           + emit_cells * SCAN_OPS + keep_cells * STATS_OPS
           + 8 * cand_rows + active_steps * C * math.ceil(math.log2(C))
           + 5 * H * n_branch
           + keep_steps * B * max(1, math.ceil(math.log2(B)))
           + walk_steps * smax)
    in_bytes = sum(getattr(rb, fl)[:n_real].numel()
                   * getattr(rb, fl).element_size()
                   for fl in ("tgt_masks", "tgt_len", "start_tip",
                              "start_off", "end_tip", "end_off",
                              "colors_sig", "colors_wsig", "max_plen",
                              "end_cyclic"))
    nbytes = in_bytes + graph_bytes + n_real * (lmax + 6 * 4 + 1)
    return dict(T=T, ops=ops, bytes=nbytes)
