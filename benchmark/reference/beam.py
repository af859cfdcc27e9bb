"""Beam search over the unitig graph with banded, carried DP rows: the
plain PyTorch route (impl="torch") of the port's correct/beam.py, frozen.

The reference's explorePathsBFS/exploreSubGraph re-expressed as a
fixed-width beam that advances one base per branch step, each entry carrying
a band of its edit-distance row against the raw region. Integer state widths
int32, int8, uint8; float32 scores, computed as separate torch ops in the
reference's order. `score_dtype` is the type the candidate scores are
ranked in: float32 as the configuration states, or a lower precision for
the benchmark's control (the same arithmetic, rounded to bfloat16).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .graphdev import DeviceGraph
from .sprint import sprint_rows_ref

NEG = -1e9                 # float32 score of an invalid candidate
BIG = 1 << 20
_CAPC = 16  # color-count saturation for the color score
_I32 = torch.int32


@dataclasses.dataclass
class RegionBatch:
    """[R]-leading device tensors describing weak regions (one bucket); the
    fields of ratatosk_tpu.correct.beam.RegionBatch, in its order."""

    tgt_masks: torch.Tensor   # uint8 [R, NT] 4-bit IUPAC masks of the raw region
    tgt_len: torch.Tensor     # int32 [R]
    start_tip: torch.Tensor   # int32 [R] packed (uid<<1|dir) of the left anchor
    start_off: torch.Tensor   # int32 [R] next oriented base to emit
    end_tip: torch.Tensor     # int32 [R] right anchor tip, -1 = open region
    end_off: torch.Tensor     # int32 [R] `off` value that completes the region
    colors_sig: torch.Tensor  # int8 [R, SIG_BINS] region color signature
    colors_wsig: torch.Tensor  # int8 [R, SIG_BINS] weighted signature
    max_plen: torch.Tensor    # int32 [R] path length budget
    tgt_qual: torch.Tensor    # int32 [R, NT] clipped linear quality (q-33)
    end_cyclic: torch.Tensor  # bool [R] right anchor lies on a short cycle

    _DTYPES = dict(tgt_masks=np.uint8, tgt_len=np.int32, start_tip=np.int32,
                   start_off=np.int32, end_tip=np.int32, end_off=np.int32,
                   colors_sig=np.int8, colors_wsig=np.int8,
                   max_plen=np.int32, tgt_qual=np.int32, end_cyclic=np.bool_)

    @staticmethod
    def from_numpy(arrays, device: torch.device) -> "RegionBatch":
        """Upload one host array per field (a dict, or np.asarray of each
        field of a JAX RegionBatch), one transfer each."""
        return RegionBatch(**{
            f: torch.tensor(np.asarray(arrays[f], dtype=dt), device=device)
            for f, dt in RegionBatch._DTYPES.items()})


@dataclasses.dataclass
class BeamState:
    """Per-step state; the fields and meanings of the reference's BeamState."""

    tip: torch.Tensor     # int32 [R, B]
    off: torch.Tensor     # int32 [R, B]
    plen: torch.Tensor    # int32 [R, B]
    pcount: torch.Tensor  # int32 [R] path length of the region's live entries
    cbest: torch.Tensor   # int32 [R] best completed NW distance (BIG = none)
    cstep: torch.Tensor   # int32 [R] step index of the best arrival
    ccand: torch.Tensor   # int32 [R] candidate index (b*4+c) of that arrival
    cplen: torch.Tensor   # int32 [R] path length of that arrival
    csecond: torch.Tensor  # int32 [R] runner-up completed distance
    cnum: torch.Tensor    # int32 [R] number of arrivals captured
    csbits: torch.Tensor  # int32 [R] sprint bases of the arrival's parent
    cscnt: torch.Tensor   # int32 [R] and their count
    hist: torch.Tensor    # int32 [LMAX, R, B]: bits0-1 branch base,
                          # bit2 emitted, bits3-9 parent slot,
                          # bits10-12 sprint count, bits13-26 sprint bases
    rwin: torch.Tensor    # int32 [R, B, W] DP-row band at window ws(step)
    btgt: torch.Tensor    # uint8 [R, W] target masks at window ws(step)
    live: torch.Tensor    # bool [R, B] slot holds a real path
    cmin: torch.Tensor    # int32 [R, B] weakest-link shared-read count
    frozen: torch.Tensor  # bool [R, B] stopped (completed/dead end/budget)
    compl_: torch.Tensor  # bool [R, B] reached the right anchor
    fdist: torch.Tensor   # int32 [R, B] distance captured at freeze time
    fend: torch.Tensor    # int32 [R, B] target end column captured at freeze
    ccsum: torch.Tensor   # float32 [R, B] accumulated color score
    nvis: torch.Tensor    # int32 [R, B] unitigs entered


@dataclasses.dataclass
class BeamResult:
    best_seq: torch.Tensor     # uint8 [R, L] 2-bit codes of the winning path
    best_len: torch.Tensor     # int32 [R]
    best_dist: torch.Tensor    # int32 [R] NW distance (closed) / prefix distance
    best_end: torch.Tensor     # int32 [R] target prefix consumed
    second_dist: torch.Tensor  # int32 [R] runner-up distance (quality margin)
    completed: torch.Tensor    # bool [R] a path reached the right anchor
    n_done: torch.Tensor       # int32 [R]


FIELDS = tuple(f.name for f in dataclasses.fields(BeamResult))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] along dim 0 with JAX's gather semantics for non-negative
    indices: out-of-range indices clamp to the last row."""
    return x[idx.clamp(0, x.shape[0] - 1).long()]


def _window_start(i, tgt_len, nt1: int, w: int):
    """Band start column at path length i ([R] or [R, S]), shared by a
    region's entries; the upper clip is per region (tl+1-w)."""
    if w >= nt1:
        shape = torch.broadcast_shapes(i.shape, tgt_len.shape)
        return torch.zeros(shape, dtype=_I32, device=tgt_len.device)
    hi = (tgt_len + 1 - w).clamp_min(0)
    return torch.minimum((i - w // 2).clamp_min(0), hi).to(_I32)


def _band_dists(row, cols, tgt_len):
    """(dist_pref, end_max, dist_nw) over a band. row [..., W], cols [..., W]
    absolute columns, tgt_len broadcastable to row[..., 0]."""
    tl = tgt_len[..., None]
    valid = cols <= tl
    masked = torch.where(valid, row, BIG)
    dist_pref = masked.amin(-1)
    is_min = masked == dist_pref[..., None]
    end_max = torch.where(is_min, cols, -1).amax(-1)
    dist_nw = torch.where(cols == tl, row, BIG).amin(-1)
    return dist_pref, end_max, dist_nw


def _band_dists_from_d(dmat, cols, tgt_len):
    """Same stats from the D column minima before the prefix-min scan (see
    the reference's _band_dists_from_d for the identities)."""
    tl = tgt_len[..., None]
    valid = cols <= tl
    masked = torch.where(valid, dmat, BIG)
    dist_pref = masked.amin(-1)
    is_min = masked == dist_pref[..., None]
    end_max = torch.where(is_min, cols, -1).amax(-1)
    in_win = (cols[..., :1] <= tl[..., 0:1]) & (tl[..., 0:1] <= cols[..., -1:])
    dist_nw = torch.where(valid, dmat - cols, BIG).amin(-1) + tl[..., 0]
    dist_nw = torch.where(in_win[..., 0], dist_nw, BIG)
    return dist_pref, end_max, dist_nw.clamp_max(BIG)


def _shift_pair(rwin, delta):
    """(prev_j, prev_jm1): the previous row read at the new window, whose
    start moved by delta in {0, 1}; beyond the band reads BIG."""
    big = torch.full_like(rwin[..., :1], BIG)
    shift_l = torch.cat([rwin[..., 1:], big], dim=-1)
    shift_r = torch.cat([big, rwin[..., :-1]], dim=-1)
    adv = delta == 1
    return (torch.where(adv, shift_l, rwin), torch.where(adv, rwin, shift_r))


def _sprint_advance(g: DeviceGraph, rb: RegionBatch, padded_tgt,
                    st: BeamState, rec, smax: int, sprint_fn):
    """Advance each region by up to smax-1 deterministic mid-unitig bases
    (the reference's _sprint_advance, Pallas branch) through sprint_fn
    (ops.sprint.sprint_rows or sprint_rows_ref). Returns (state',
    sbits [R,B], scnt [R,B])."""
    R, B = st.tip.shape
    W = st.rwin.shape[-1]
    nt1 = rb.tgt_masks.shape[-1] + 1
    dev = st.tip.device
    zero_bits = torch.zeros((R, B), dtype=_I32, device=dev)
    if smax <= 1:
        return st, zero_bits, zero_bits
    d = st.tip & 1
    ul = rec[..., 4]
    uo = rec[..., 5]
    live = st.live & ~st.frozen

    # per-entry sprint cap: stay strictly before the boundary branch, the
    # anchor arrival and the budget freeze (INF for non-live entries)
    inf = 1 << 28
    d_bound = ul - st.off + 1
    on_end = ((rb.end_tip[:, None] >= 0)
              & (st.tip == rb.end_tip[:, None])
              & (st.off < rb.end_off[:, None]))
    d_arr = torch.where(on_end, rb.end_off[:, None] - st.off, inf)
    d_budget = rb.max_plen[:, None] - st.plen
    s_ent = torch.minimum(torch.minimum(d_bound, d_arr), d_budget)
    s_ent = torch.where(live, s_ent, inf)
    has_live = live.any(dim=1)
    m_reg = torch.where(has_live, s_ent.amin(dim=1) - 1, 0).clamp(0, smax - 1)

    # the next smax-1 oriented bases per entry (a contiguous run on the
    # unitig) and the target-mask columns the windows will expose
    j_i = torch.arange(smax - 1, dtype=_I32, device=dev)
    pos = torch.where(d[..., None] == 0, st.off[..., None] + j_i,
                      ul[..., None] - 1 - (st.off[..., None] + j_i))
    pos = torch.minimum(pos.clamp_min(0), (ul[..., None] - 1).clamp_min(0))
    nb_all = _take(g.useq, uo[..., None] + pos).to(_I32)
    nb_all = torch.where(d[..., None] == 0, nb_all, 3 - nb_all)  # [R,B,smax-1]
    wsall = _window_start(
        st.pcount[:, None] + torch.arange(smax, dtype=_I32, device=dev),
        rb.tgt_len[:, None], nt1, W)                             # [R, smax]
    fetch_j = (wsall[:, 1:] + (W - 1)).clamp_max(nt1 - 1)
    newcols = padded_tgt.gather(1, fetch_j.long()).to(_I32)      # [R, smax-1]

    livem = live.to(_I32)
    rwin_n, btgt_n = sprint_fn(st.rwin, st.btgt.to(_I32), nb_all.contiguous(),
                        newcols, wsall.contiguous(), m_reg.contiguous(), livem,
                        st.plen.contiguous(), smax=smax)
    adv_n = livem * m_reg[:, None]
    jmask = (j_i[None, None, :] < m_reg[:, None, None]) & live[..., None]
    sbits = torch.where(jmask, nb_all << (2 * j_i), 0).sum(dim=-1).to(_I32)
    scnt = torch.where(live, m_reg[:, None], 0).to(_I32)
    return (dataclasses.replace(st, rwin=rwin_n, btgt=btgt_n.to(torch.uint8),
                                off=st.off + adv_n, plen=st.plen + adv_n,
                                pcount=st.pcount + m_reg),
            sbits, scnt)


def _beam_step(g: DeviceGraph, rb: RegionBatch, padded_tgt, st: BeamState,
               i: int, min_cov: int, rec, sbits, scnt, score_dtype=torch.float32) -> BeamState:
    """One branch step: score the <=4 successors of every entry, keep the
    top B, apply the color filter and rebuild the winners' rows."""
    R, B = st.tip.shape
    W = st.rwin.shape[-1]
    nt1 = rb.tgt_masks.shape[-1] + 1
    k = g.k
    dev = st.tip.device

    d = st.tip & 1
    e_raw = rec[..., :4]                   # -1 = absent OR not read-supported
    e_resc = (e_raw >= 0) & (((e_raw >> 30) & 1) == 1)
    e = torch.where(e_raw >= 0, e_raw & ((1 << 30) - 1), e_raw)
    ul = rec[..., 4]
    uo = rec[..., 5]
    active = st.live & ~st.frozen
    at_bound = active & (st.off >= ul)
    mid = active & (st.off < ul)

    # mid-unitig next base (oriented)
    pos = torch.where(d == 0, st.off, ul - 1 - st.off)
    pos = torch.minimum(pos.clamp_min(0), (ul - 1).clamp_min(0))
    nb = _take(g.useq, uo + pos).to(_I32)
    nb = torch.where(d == 0, nb, 3 - nb)

    branch_ok = (e >= 0) & at_bound[..., None]
    cidx = torch.arange(4, dtype=_I32, device=dev)[None, None, :]
    valid = torch.where(at_bound[..., None], branch_ok,
                        mid[..., None] & (cidx == nb[..., None]))
    cand_tip = torch.where(at_bound[..., None], e, st.tip[..., None])
    cand_off = torch.where(at_bound[..., None], k, st.off[..., None] + 1)
    no_succ = at_bound & ~branch_ok.any(dim=-1)
    keep = ((st.live & ~active) | no_succ)[..., None] & (cidx == 0)
    valid = valid | keep
    emits = valid & ~keep

    cand_tip = torch.where(keep, st.tip[..., None], cand_tip)
    cand_off = torch.where(keep, st.off[..., None], cand_off)
    cand_plen = torch.where(emits, st.plen[..., None] + 1, st.plen[..., None])
    cand_branch = at_bound[..., None] & emits
    cand_ccsum = st.ccsum[..., None].expand(R, B, 4)
    cand_nvis = torch.where(cand_branch, st.nvis[..., None] + 1,
                            st.nvis[..., None])
    arrive = (emits & (rb.end_tip[:, None, None] >= 0)
              & (cand_tip == rb.end_tip[:, None, None])
              & (cand_off == rb.end_off[:, None, None]))
    cand_compl = st.compl_[..., None] | (
        arrive & ~rb.end_cyclic[:, None, None])

    # --- banded DP candidate scoring (no prefix-min scan here) ---
    ws = _window_start(st.pcount, rb.tgt_len, nt1, W)            # [R]
    ws_next = _window_start(st.pcount + 1, rb.tgt_len, nt1, W)   # [R]
    delta = (ws_next - ws)[:, None, None]                    # [R,1,1]
    arw = torch.arange(W, dtype=_I32, device=dev)
    cols = ws_next[:, None] + arw[None, :]                   # [R,W]
    fetch = (ws_next + (W - 1)).clamp_max(nt1 - 1)
    newcol = padded_tgt.gather(1, fetch[:, None].long())     # uint8 [R,1]
    shifted = torch.cat([st.btgt[:, 1:], newcol], dim=1)
    bslice = torch.where(delta[..., 0] == 1, shifted, st.btgt)  # [R, W]
    prev_j, prev_jm1 = _shift_pair(st.rwin, delta)

    base_mask = 1 << cidx                                    # [1,1,4]
    sub = ((base_mask[..., None] & bslice[:, None, None, :].to(_I32))
           == 0).to(_I32)                                    # [R,1,4,W]
    dmat = torch.minimum(prev_jm1[:, :, None, :] + sub,
                         prev_j[:, :, None, :] + 1)
    dmat = torch.where(cols[:, None, None, :] == 0, cand_plen[..., None], dmat)
    dmat = dmat.clamp_max(BIG)

    # newly-frozen: completed, dead end, or path length budget exhausted
    over = cand_plen >= rb.max_plen[:, None, None]
    cand_frozen = (st.frozen[..., None] | cand_compl | over
                   | (no_succ[..., None] & keep))

    tl = rb.tgt_len[:, None, None].expand(R, B, 4)
    cols4 = cols[:, None, None, :].expand(R, B, 4, W)
    dist_pref, end_max, dist_nw = _band_dists_from_d(dmat, cols4, tl)

    # --- completion scoreboard update (pre-selection) ---
    C = B * 4
    ar_r = torch.arange(R, device=dev)
    arr_d = torch.where(arrive & valid, dist_nw, BIG).reshape(R, C)
    m1 = arr_d.amin(dim=1)
    a1 = torch.argmin(arr_d, dim=1)                 # first index on ties
    plen_at = cand_plen.reshape(R, C)[ar_r, a1]
    multi = (arr_d == m1[:, None]).sum(dim=1) >= 2
    m2 = torch.where(multi, m1,
                     torch.where(arr_d > m1[:, None], arr_d, BIG).amin(dim=1))
    vals = torch.sort(torch.stack([st.cbest, st.csecond, m1, m2], dim=1),
                      dim=1).values
    take_new = m1 < st.cbest
    new_cbest = vals[:, 0]
    new_csecond = vals[:, 1]
    new_cstep = torch.where(take_new, i, st.cstep)
    new_ccand = torch.where(take_new, a1.to(_I32), st.ccand)
    new_cplen = torch.where(take_new, plen_at, st.cplen)
    new_cnum = st.cnum + (arr_d < BIG).sum(dim=1).to(_I32)
    new_csbits = torch.where(take_new, sbits[ar_r, a1 >> 2], st.csbits)
    new_cscnt = torch.where(take_new, scnt[ar_r, a1 >> 2], st.cscnt)
    # non-emitting (keep) slots: stats of the parent's current row, which
    # lives at window ws(i)
    cols_prev = ws[:, None] + arw[None, :]
    colsB = cols_prev[:, None, :].expand(R, B, W)
    dist_pref_k, end_max_k, dist_nw_k = _band_dists(
        st.rwin, colsB, rb.tgt_len[:, None])
    dist_pref = torch.where(emits, dist_pref, dist_pref_k[..., None])
    end_max = torch.where(emits, end_max, end_max_k[..., None])
    dist_nw = torch.where(emits, dist_nw, dist_nw_k[..., None])

    newly = cand_frozen & ~st.frozen[..., None]
    cand_fdist = torch.where(newly,
                             torch.where(cand_compl, dist_nw, dist_pref),
                             st.fdist[..., None])
    cand_fend = torch.where(newly, torch.where(cand_compl, tl, end_max),
                            st.fend[..., None])

    # scores: frozen entries use their captured distance; live use the prefix
    eff_dist = torch.where(cand_frozen, cand_fdist, dist_pref)
    denom = torch.where(cand_compl, tl, cand_plen.clamp_min(1))
    align = 1.0 - eff_dist.float() / denom.clamp_min(1).float()
    color = cand_ccsum / cand_nvis.clamp_min(1).float()
    score = _score(align, color, score_dtype)
    score = torch.where(valid, score, NEG)

    # --- top-`beam` selection: stable sort = rank by score, ties to the
    # lower slot; the first B candidates win ---
    fscore = score.reshape(R, C)
    sel = torch.sort(fscore, dim=1, descending=True, stable=True).indices[:, :B]
    par = sel >> 2                                           # parent slot

    def pick(x):
        return x.reshape(R, C).gather(1, sel)

    new_tip = pick(cand_tip)
    new_off = pick(cand_off)
    new_plen = pick(cand_plen)
    new_frozen = pick(cand_frozen)
    new_compl = pick(cand_compl)
    new_ccsum = pick(cand_ccsum)
    new_nvis = pick(cand_nvis)
    sel_emit = pick(emits)
    new_fdist = pick(cand_fdist)
    new_fend = pick(cand_fend)
    sel_branch = pick(cand_branch)
    new_live = pick(valid)
    sel_rescued = pick(cand_branch & e_resc)
    sel_cmin = st.cmin.gather(1, par)
    sel_sbits = sbits.gather(1, par)
    sel_scnt = scnt.gather(1, par)
    sel_score = fscore.gather(1, sel)
    new_live = new_live & (sel_score > NEG / 2)

    # post-selection color filter + color score on the B winners only
    sel_sig = _take(g.color_sig, (new_tip >> 1).clamp_min(0))    # [R, B, H]
    shared_raw = (sel_sig.to(_I32) * rb.colors_sig[:, None, :].to(_I32)).sum(-1)
    wshared_raw = (sel_sig.to(_I32)
                   * rb.colors_wsig[:, None, :].to(_I32)).sum(-1)
    # collision-bias correction: subtract the expected overlap of unrelated
    # sets, pop(u) * mass(region) / bins
    H = sel_sig.shape[-1]
    pop_u = sel_sig.float().sum(-1)                          # [R, B]
    mass = rb.colors_sig.float().sum(-1)                     # [R]
    wmass = rb.colors_wsig.float().sum(-1)
    shared = shared_raw.float() - pop_u * mass[:, None] / H
    wshared = torch.clamp_min(
        wshared_raw.float() - pop_u * wmass[:, None] / H, 0.0)
    # k2-rescued edges bypass the color filter and score at least min_cov
    new_live = new_live & (~sel_branch | new_compl | sel_rescued
                           | (shared >= min_cov))
    wsh_eff = torch.where(sel_rescued, wshared.clamp_min(float(min_cov)),
                          wshared)
    new_ccsum = torch.where(
        sel_branch, new_ccsum + wsh_eff.clamp_max(float(_CAPC)) / _CAPC,
        new_ccsum)
    sh_eff = torch.where(sel_rescued, shared.clamp_min(float(min_cov)), shared)
    new_cmin = torch.where(sel_branch,
                           torch.minimum(sel_cmin.float(), sh_eff),
                           sel_cmin.float()).to(_I32)

    # path history: layout base(2) | emitted(1) | parent(7) | sprint
    # count(3) | bases(14). Written in place (the reference returns a new
    # array from dynamic_update_slice; nothing else holds this one)
    hrec = ((sel & 3).to(_I32) | (sel_emit.to(_I32) << 2)
            | (par.to(_I32) << 3) | (sel_scnt << 10) | (sel_sbits << 13))
    st.hist[i] = hrec

    # --- rebuild the winners' DP rows (prefix-min scan on B rows only) ---
    rwin_par = st.rwin.gather(1, par[..., None].expand(R, B, W))
    prev_j_s, prev_jm1_s = _shift_pair(rwin_par, delta)
    sub_s = (((1 << (sel & 3).to(_I32))[..., None]
              & bslice[:, None, :].to(_I32)) == 0).to(_I32)
    colsr = cols[:, None, :]
    d_sel = torch.minimum(prev_jm1_s + sub_s, prev_j_s + 1)
    d_sel = torch.where(colsr == 0, new_plen[..., None], d_sel)
    d_sel = d_sel.clamp_max(BIG)
    e_sel = colsr + torch.cummin(d_sel - colsr, dim=2).values
    e_sel = e_sel.clamp_max(BIG)
    new_rwin_sel = torch.where(sel_emit[..., None], e_sel, rwin_par)

    # regions advance one base whenever anything emitted this step
    new_pcount = st.pcount + emits.reshape(R, C).any(dim=1).to(_I32)
    return BeamState(
        tip=new_tip, off=new_off, plen=new_plen, pcount=new_pcount,
        cbest=new_cbest, cstep=new_cstep, ccand=new_ccand,
        cplen=new_cplen, csecond=new_csecond, cnum=new_cnum,
        csbits=new_csbits, cscnt=new_cscnt,
        hist=st.hist, rwin=new_rwin_sel, btgt=bslice,
        live=new_live, cmin=new_cmin, frozen=new_frozen, compl_=new_compl,
        fdist=new_fdist, fend=new_fend,
        ccsum=new_ccsum, nvis=new_nvis,
    )




def _check_widths(beam: int, sprint: int) -> None:
    if not 1 <= sprint <= 8:
        raise ValueError("sprint bases must fit the 14-bit hist field")
    if beam > 128:
        raise ValueError("beam must fit the 7-bit hist parent field")


def band_width(nt: int, band: int) -> int:
    """The beam's DP band W: the full row (NT+1) when band is 0 or covers
    it, else band."""
    return nt + 1 if band <= 0 or band >= nt + 1 else band


def _init_state(rb: RegionBatch, beam: int, lmax: int, W: int):
    """(step-0 state, padded target masks [R, NT+1])."""
    R = rb.tgt_masks.shape[0]
    dev = rb.tgt_masks.device
    slot0 = (torch.arange(beam, device=dev) == 0)[None, :].expand(R, beam)
    # initial window at ws(0)=0: row 0 is E[0][j] = j (NW boundary)
    rwin0 = torch.arange(W, dtype=_I32, device=dev)[None, None, :].expand(
        R, beam, W).contiguous()
    # target mask for column j lives at tgt_masks[j-1]; pad col 0 with 0
    padded_tgt = torch.cat([torch.zeros((R, 1), dtype=torch.uint8, device=dev),
                            rb.tgt_masks], dim=1)

    def full(shape, v, dtype=_I32):
        return torch.full(shape, v, dtype=dtype, device=dev)

    st = BeamState(
        tip=torch.where(slot0, rb.start_tip[:, None], -1).to(_I32),
        off=rb.start_off[:, None].expand(R, beam).to(_I32).contiguous(),
        plen=full((R, beam), 0),
        pcount=full((R,), 0),
        cbest=full((R,), BIG),
        cstep=full((R,), 0),
        ccand=full((R,), 0),
        cplen=full((R,), 0),
        csecond=full((R,), BIG),
        cnum=full((R,), 0),
        csbits=full((R,), 0),
        cscnt=full((R,), 0),
        hist=full((lmax, R, beam), 0),
        rwin=rwin0,
        btgt=padded_tgt[:, :W].contiguous(),
        live=slot0.contiguous(),
        cmin=full((R, beam), BIG),
        frozen=full((R, beam), False, torch.bool),
        compl_=full((R, beam), False, torch.bool),
        fdist=full((R, beam), BIG),
        fend=full((R, beam), 0),
        ccsum=full((R, beam), 0.0, torch.float32),
        nvis=full((R, beam), 0),
    )
    return st, padded_tgt


def _step(g: DeviceGraph, rb: RegionBatch, padded_tgt, st: BeamState, i: int,
          *, min_cov: int, smax: int, score_dtype) -> BeamState:
    """Branch step i: the sprint substeps, then the branch step."""
    uid = (st.tip >> 1).clamp(0, g.utbl.shape[0] - 1).long()
    rec = g.utbl[uid, (st.tip & 1).long()]     # [R, B, 6]
    st, sbits, scnt = _sprint_advance(g, rb, padded_tgt, st, rec, smax,
                                      sprint_rows_ref)
    return _beam_step(g, rb, padded_tgt, st, i, min_cov, rec, sbits, scnt,
                      score_dtype)


def _run_steps(g: DeviceGraph, rb: RegionBatch, padded_tgt, st: BeamState,
               t0: int, t_stop: int, *, until_frozen: bool, **kw):
    """Steps t0, t0+1, ... before t_stop; with until_frozen, also stop
    before a step once no entry of the batch is live and unfrozen (the
    reference's while_loop test: one host sync per step). Returns (state,
    the step index reached)."""
    t = t0
    while t < t_stop:
        if until_frozen and not bool((st.live & ~st.frozen).any()):
            break
        st = _step(g, rb, padded_tgt, st, t, **kw)
        t += 1
    return st, t


def _pick_and_reconstruct(rb: RegionBatch, st: BeamState, T: int, *,
                          lmax: int, smax: int,
                          score_dtype=torch.float32) -> BeamResult:
    """The final pick after T steps, and the winner's path from the
    backpointer history. Regions without a completed path walk back from
    step T-1, so the result depends on the launch-wide T."""
    R, beam = st.tip.shape
    dev = st.tip.device
    # completed regions read the scoreboard; the others fall back to the
    # best partial entry
    has_c = st.cnum > 0
    eligible = st.live
    denom = torch.where(st.compl_, rb.tgt_len[:, None], st.plen.clamp_min(1))
    align = 1.0 - st.fdist.float() / denom.clamp_min(1).float()
    color = st.ccsum / st.nvis.clamp_min(1).float()
    score = _score(align, color, score_dtype)
    escore = torch.where(eligible, score, NEG)
    order = torch.argsort(-escore, dim=1, stable=True)
    # selectMostContiguous tie-break: among entries within float tolerance
    # of the best score, the highest weakest-link junction support wins
    mx = escore.amax(dim=1, keepdim=True)
    tied = eligible & (escore >= mx - 1e-6)
    b0 = torch.argmax(torch.where(tied, st.cmin + 1, 0), dim=1)
    b1 = torch.where(order[:, 0] == b0, order[:, min(1, beam - 1)],
                     order[:, 0])
    ar = torch.arange(R, device=dev)
    any_ok = eligible[ar, b0] & (st.fdist[ar, b0] < BIG)
    second_fb = torch.where(eligible[ar, b1] & (b1 != b0), st.fdist[ar, b1],
                            BIG)

    # --- winner path reconstruction from the backpointer history ---
    blen_fb = torch.where(any_ok, st.plen[ar, b0], 0)
    blen = torch.where(has_c, st.cplen, blen_fb)
    start_idx = torch.where(has_c, st.cstep - 1, T - 1)
    cur = torch.where(has_c, st.ccand >> 2, b0.to(_I32)).to(_I32)
    rem = torch.where(has_c, st.cplen - 1 - st.cscnt, blen_fb).to(_I32)
    seq = torch.zeros((R, lmax), dtype=torch.uint8, device=dev)

    def put(pos, mask, val):
        # JAX drops scatter writes past the end; pos is never negative here
        pc = pos.clamp_max(lmax - 1).long()
        seq[ar, pc] = torch.where(mask & (pos < lmax), val, seq[ar, pc])

    seed_pos = (st.cplen - 1).clamp(0, lmax - 1)
    put(seed_pos, has_c & (st.cplen > 0), (st.ccand & 3).to(torch.uint8))
    for jj in range(smax - 1):
        p = (st.cplen - 1 - st.cscnt + jj).clamp(0, lmax - 1)
        put(p, has_c & (jj < st.cscnt),
            ((st.csbits >> (2 * jj)) & 3).to(torch.uint8))

    idx = int(start_idx.max()) if R else -1
    while idx >= 0:
        h = st.hist[min(idx, lmax - 1)]                     # [R, beam]
        act = idx <= start_idx
        ok_cur = (cur >= 0) & (cur < beam)
        hsel = torch.where(
            ok_cur, h.gather(1, cur.clamp(0, beam - 1).long()[:, None])[:, 0],
            0)
        emit = act & (((hsel >> 2) & 1) == 1) & (rem > 0)
        put((rem - 1).clamp_min(0), emit, (hsel & 3).to(torch.uint8))
        rem = rem - emit.to(_I32)
        # sprint bases precede the branch base: written backward
        hscnt = torch.where(act, (hsel >> 10) & 7, 0)
        hsbits = (hsel >> 13) & 0x3FFF
        for jj in range(smax - 1):
            m = (jj < hscnt) & (rem > 0)
            sh = (2 * (hscnt - 1 - jj)).clamp_min(0)
            put((rem - 1).clamp_min(0), m,
                ((hsbits >> sh) & 3).to(torch.uint8))
            rem = rem - m.to(_I32)
        cur = torch.where(act, (hsel >> 3) & 127, cur)
        idx -= 1

    return BeamResult(
        best_seq=seq,
        best_len=blen,
        best_dist=torch.where(has_c, st.cbest,
                              torch.where(any_ok, st.fdist[ar, b0], BIG)),
        best_end=torch.where(has_c, rb.tgt_len,
                             torch.where(any_ok, st.fend[ar, b0], 0)),
        second_dist=torch.where(has_c, st.csecond, second_fb),
        completed=has_c,
        n_done=st.cnum,
    )


@dataclasses.dataclass
class Phase1:
    """A batch after phase 1 of the search (beam_phase1)."""

    st: BeamState
    padded_tgt: torch.Tensor
    f: int  # steps run: until no row holds a live, unfrozen entry, or lmax


def beam_phase1(g: DeviceGraph, rb: RegionBatch, *, beam: int, lmax: int,
                min_cov: int = 2, band: int = 0, sprint: int = 8,
                score_dtype=torch.float32) -> Phase1:
    """Init, then steps until no entry of the batch is live and unfrozen,
    or lmax: the batch's own step count f, the largest f_r of its rows."""
    W = band_width(rb.tgt_masks.shape[1], band)
    st, padded_tgt = _init_state(rb, beam, lmax, W)
    st, f = _run_steps(g, rb, padded_tgt, st, 0, lmax, until_frozen=True,
                       min_cov=min_cov, smax=sprint, score_dtype=score_dtype)
    return Phase1(st, padded_tgt, f)


def beam_phase2(g: DeviceGraph, rb: RegionBatch, p1: Phase1, T: int, *,
                lmax: int, min_cov: int = 2, sprint: int = 8,
                score_dtype=torch.float32) -> BeamResult:
    """The launch-wide step count T (>= p1.f: the largest f over every batch
    of the launch) applied to a batch after phase 1: it runs on to
    min(T, p1.f + 1) steps, then picks and reconstructs as after that many.
    The same result as running on to T: past its own step count f no
    entry is active, so every later re-rank is the identity."""
    if T < p1.f:
        raise ValueError(f"launch-wide step count {T} below the batch's own "
                         f"{p1.f}")
    t = min(T, p1.f + 1)
    st, _ = _run_steps(g, rb, p1.padded_tgt, p1.st, p1.f, t,
                       until_frozen=False, min_cov=min_cov, smax=sprint,
                       score_dtype=score_dtype)
    return _pick_and_reconstruct(rb, st, t, lmax=lmax, smax=sprint,
                                 score_dtype=score_dtype)


def beam_search(g: DeviceGraph, rb: RegionBatch, *, beam: int, lmax: int,
                min_cov: int = 2, band: int = 0, sprint: int = 8,
                score_dtype=torch.float32) -> BeamResult:
    """band=0 (or >= NT+1) means exact full-row DP; otherwise a W-wide band.

    sprint: max bases an outer step advances per region (1 branch step plus
    up to sprint-1 mid-unitig bases). Steps run until no entry of the batch
    is live and unfrozen, or lmax (phase 1), then one step more at most
    (phase 2 with the batch's own step count)."""
    _check_widths(beam, sprint)
    kw = dict(min_cov=min_cov, sprint=sprint, score_dtype=score_dtype)
    p1 = beam_phase1(g, rb, beam=beam, lmax=lmax, band=band, **kw)
    return beam_phase2(g, rb, p1, p1.f, lmax=lmax, **kw)


def _score(align, color, score_dtype):
    """0.5 * align + 0.5 * color, ranked in score_dtype (float32 result)."""
    if score_dtype == torch.float32:
        return 0.5 * align.clamp(-1.0, 1.0) + 0.5 * color
    a = align.to(score_dtype).clamp(-1.0, 1.0)
    return (0.5 * a + 0.5 * color.to(score_dtype)).float()
