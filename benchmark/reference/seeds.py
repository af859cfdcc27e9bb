"""Solid-anchor detection: map a long read's k-mers onto the graph and chain
exact hits into runs.

Mirrors the reference's `getSeeds` (Graph.cpp:3-482, SURVEY.md §3.2): exact
full-k-mer matches become solid anchors; maximal colinear stretches (same
unitig, same direction, consecutive oriented offsets) form runs; adjacent runs
that share < min_cov read colors across the junction are both dropped
(Graph.cpp:325-372). Weak (inexact) seeds and pass-1 gap rescue are later-round
work.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .build import Cdbg
from .colors import GraphColors
from .keys import KeyArray
from . import colorset as CS


@dataclasses.dataclass
class SolidRun:
    """A maximal colinear stretch of exact k-mer anchors on one unitig.

    s/e: first/last read k-mer position (inclusive); uid/direction: unitig and
    traversal direction; o_s: oriented k-mer offset on the unitig at read
    position s (oriented offset increments by 1 per read position).

    weak=True marks a 1-edit (inexact) seed used as a waypoint: its bases come
    from the GRAPH k-mer (the read copy carries the error); rspan is how many
    read bases the anchor window consumes (k for exact and substitution seeds,
    k+1 when the read has an extra base, k-1 when it lacks one).
    """

    s: int
    e: int
    uid: int
    direction: int
    o_s: int
    weak: bool = False
    rspan: int = 0   # 0 = default (k); engine fills the real span

    @property
    def o_e(self) -> int:
        return self.o_s + (self.e - self.s)


def find_runs(cdbg: Cdbg, codes: np.ndarray, probe=None) -> List[SolidRun]:
    """probe (optional): (canonical KeyArray, valid) -> (uid, pos, strand)
    int arrays with uid=-1 at misses — lets a sharded device index serve the
    lookups instead of the replicated host array."""
    k = cdbg.k
    if codes.shape[-1] < k:
        return []
    if probe is not None:
        ka, valid = KeyArray.from_codes(codes, k)
        can, is_fw = ka.canonical()
        uid, pos, strand = probe(can, valid)
        hit = uid >= 0
        if not hit.any():
            return []
    else:
        ka, valid = KeyArray.from_codes(codes, k)
        can, is_fw = ka.canonical()
        keys = KeyArray(k, np.asarray(cdbg.index.keys_lo),
                        np.asarray(cdbg.index.keys_hi) if cdbg.index.two_word else None)
        rows = keys.find(can)
        rows[~valid] = -1
        hit = rows >= 0
        if not hit.any():
            return []
        uid = np.where(hit, np.asarray(cdbg.index.unitig_id)[np.maximum(rows, 0)], -1)
        pos = np.where(hit, np.asarray(cdbg.index.pos)[np.maximum(rows, 0)], 0)
        strand = np.asarray(cdbg.index.strand)[np.maximum(rows, 0)]
    # read k-mer maps forward on the unitig iff its canonical orientation
    # agrees with the stored canonical-vs-forward flag
    direction = np.where(hit & (is_fw == strand), 0, 1)
    nk = cdbg.nkmers[np.maximum(uid, 0)]
    o = np.where(direction == 0, pos, nk - 1 - pos)

    # chain: t..t+1 colinear iff same unitig+direction and oriented offset +1
    chain = (hit[:-1] & hit[1:] & (uid[:-1] == uid[1:])
             & (direction[:-1] == direction[1:]) & (o[1:] == o[:-1] + 1))
    # run starts: hit positions not chained from the left; ends: not chained
    # to the right (vectorized — the planner is host-side hot path)
    start_mask = hit.copy()
    start_mask[1:] &= ~chain
    end_mask = hit.copy()
    end_mask[:-1] &= ~chain
    starts = np.flatnonzero(start_mask)
    ends = np.flatnonzero(end_mask)
    return [SolidRun(s=int(s), e=int(e), uid=int(uid[s]),
                     direction=int(direction[s]), o_s=int(o[s]))
            for s, e in zip(starts, ends)]


# ---------------------------------------------------------------------------
# 128-bit packed-window surgery (vectorized over window positions).
#
# A window of m bases is the 2m-bit number N = hi * 2^64 + lo (ops/kmers.py
# layout). All 1-edit variants are produced by static-shift bit surgery on N,
# and each variant's reverse complement by the mirrored surgery on the
# (once-per-position) reverse-complemented window — so the expensive
# reverse2bit64 runs per position, not per variant.
# ---------------------------------------------------------------------------

_FULL64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _shl128(hi, lo, s: int):
    if s == 0:
        return hi, lo
    if s == 64:
        return lo, np.zeros_like(lo)
    if s > 64:
        return (lo << np.uint64(s - 64)) & _FULL64, np.zeros_like(lo)
    return (((hi << np.uint64(s)) & _FULL64) | (lo >> np.uint64(64 - s)),
            (lo << np.uint64(s)) & _FULL64)


def _shr128(hi, lo, s: int):
    if s == 0:
        return hi, lo
    if s == 64:
        return np.zeros_like(hi), hi
    if s > 64:
        return np.zeros_like(hi), hi >> np.uint64(s - 64)
    return (hi >> np.uint64(s),
            (lo >> np.uint64(s)) | ((hi << np.uint64(64 - s)) & _FULL64))


def _mask128(n: int):
    if n <= 0:
        return np.uint64(0), np.uint64(0)
    if n < 64:
        return np.uint64(0), np.uint64((1 << n) - 1)
    if n == 64:
        return np.uint64(0), _FULL64
    if n < 128:
        return np.uint64((1 << (n - 64)) - 1), _FULL64
    return _FULL64, _FULL64


def _set_base128(hi, lo, m: int, p: int, b: int):
    """Window base p (leftmost = 0) of m-base windows set to b."""
    s = 2 * (m - 1 - p)
    if s >= 64:
        return ((hi & ~(np.uint64(3) << np.uint64(s - 64)))
                | np.uint64(b << (s - 64)), lo)
    return hi, (lo & ~(np.uint64(3) << np.uint64(s))) | np.uint64(b << s)


def _get_base128(hi, lo, m: int, p: int):
    s = 2 * (m - 1 - p)
    if s >= 64:
        return (hi >> np.uint64(s - 64)) & np.uint64(3)
    return (lo >> np.uint64(s)) & np.uint64(3)


def _drop_base128(hi, lo, m: int, p: int):
    """Drop base p of m-base windows -> (m-1)-base windows."""
    uh, ul = _shr128(hi, lo, 2 * (m - p))
    mh, ml = _mask128(2 * (m - 1 - p))
    sh, sl = _shl128(uh, ul, 2 * (m - 1 - p))
    return sh | (hi & mh), sl | (lo & ml)


def _insert_base128(hi, lo, m: int, p: int, b: int):
    """Insert base b before index p of m-base windows -> (m+1)-base windows."""
    uh, ul = _shr128(hi, lo, 2 * (m - p))
    mh, ml = _mask128(2 * (m - p))
    sh, sl = _shl128(uh, ul, 2 * (m - p + 1))
    s = 2 * (m - p)
    if s >= 64:
        sh = sh | np.uint64(b << (s - 64))
    else:
        sl = sl | np.uint64(b << s)
    return sh | (hi & mh), sl | (lo & ml)


def _canonical_variants(codes: np.ndarray, k: int, kind: str,
                        span_starts: np.ndarray, stride: int = 1,
                        prefilter=None, pos_mask: Optional[np.ndarray] = None):
    """Canonical 1-edit variant keys of all m-base windows of `codes`.

    kind: 'sub' (m=k), 'del' (m=k+1: the read has an extra base), 'ins'
    (m=k-1: the read lost a base). Invalid windows (containing code >= 4,
    including span separators) are skipped; with stride > 1 only window
    positions aligned to stride within their span are probed.

    Returns (chi, clo, is_fw, wpos) — canonical two-word keys (chi all-zero
    when 2k <= 64), read-vs-canonical orientation, and window start positions.
    """
    from . import kmers as K
    m = k + (1 if kind == "del" else (-1 if kind == "ins" else 0))
    if kind == "exact":
        m = k
    empty = (np.zeros(0, np.uint64), np.zeros(0, np.uint64),
             np.zeros(0, bool), np.zeros(0, np.int64))
    if len(codes) < m:
        return empty
    packed = K.pack_kmers(codes, m, np)
    if m <= 32:
        wlo, valid = packed
        whi = np.zeros_like(wlo)
    else:
        whi, wlo, valid = packed
    pos = np.flatnonzero(valid)
    if pos_mask is not None and pos.size:
        pos = pos[pos_mask[np.minimum(pos, len(pos_mask) - 1)]]
    if stride > 1 and pos.size:
        sidx = np.searchsorted(span_starts, pos, side="right") - 1
        pos = pos[(pos - span_starts[sidx]) % stride == 0]
    if pos.size == 0:
        return empty
    whi, wlo = whi[pos], wlo[pos]
    if m <= 32:
        rlo = K.revcomp_kmer(wlo, m, np)
        rhi = np.zeros_like(rlo)
    else:
        rhi, rlo = K.revcomp_kmer2(whi, wlo, m, np)

    vh_l, vl_l, fw_l, p_l = [], [], [], []

    def emit(vh, vl, rvh, rvl, sel=None):
        if sel is not None:
            vh, vl, rvh, rvl = vh[sel], vl[sel], rvh[sel], rvl[sel]
            pp = pos[sel]
        else:
            pp = pos
        is_fw = (vh < rvh) | ((vh == rvh) & (vl <= rvl))
        ch = np.where(is_fw, vh, rvh)
        cl = np.where(is_fw, vl, rvl)
        if prefilter is not None:
            # reject absent keys NOW so per-variant arrays never accumulate
            from . import kmers as KM
            tbl, bits = prefilter
            qh = KM.hash_kmer2(ch, cl, np) if k > 32 else KM.hash_kmer(cl, np)
            keep = tbl[(qh >> np.uint64(64 - bits)).astype(np.int64)]
            if not keep.any():
                return
            ch, cl, is_fw, pp = ch[keep], cl[keep], is_fw[keep], pp[keep]
        vh_l.append(ch)
        vl_l.append(cl)
        fw_l.append(is_fw)
        p_l.append(pp)

    if kind == "exact":
        # the window itself: a probe span may contain exact graph k-mers
        # whose solid runs were killed by the color-consistency filter
        # (Graph.cpp:325-372); re-offering them as flank-color-checked
        # waypoints splits long clean spans into short certified legs
        emit(whi, wlo, rhi, rlo)
    elif kind == "sub":
        for p in range(k):
            orig = _get_base128(whi, wlo, m, p)
            for b in range(4):
                sel = orig != np.uint64(b)
                vh, vl = _set_base128(whi, wlo, m, p, b)
                rvh, rvl = _set_base128(rhi, rlo, m, m - 1 - p, 3 - b)
                emit(vh, vl, rvh, rvl, sel)
    elif kind == "del":
        # dropping window base 0 or k equals a shifted exact window
        for p in range(1, k):
            vh, vl = _drop_base128(whi, wlo, m, p)
            rvh, rvl = _drop_base128(rhi, rlo, m, m - 1 - p)
            emit(vh, vl, rvh, rvl)
    elif kind == "ins":
        for p in range(1, k):
            for b in range(4):
                vh, vl = _insert_base128(whi, wlo, m, p, b)
                rvh, rvl = _insert_base128(rhi, rlo, m, m - p, 3 - b)
                emit(vh, vl, rvh, rvl)
    else:
        raise ValueError(kind)
    return (np.concatenate(vh_l), np.concatenate(vl_l),
            np.concatenate(fw_l), np.concatenate(p_l))


def _probe_prefilter(index, bits: Optional[int] = None):
    """Hashed occupancy bitmap over the index keys (cached on the index).

    Random 1-edit variant k-mers almost never exist in the graph; one gather
    into this table rejects ~(1 - n/2^bits) of them before the exact sorted
    lookup — the searchsorted pass then runs on survivors only.
    """
    cached = getattr(index, "_probe_prefilter", None)
    if cached is not None:
        return cached
    from . import kmers as K
    n = max(int(index.n), 1)
    if bits is None:
        bits = min(28, max(20, int(np.ceil(np.log2(8 * n)))))
    lo = np.asarray(index.keys_lo)
    if index.two_word:
        h = K.hash_kmer2(np.asarray(index.keys_hi), lo, np)
    else:
        h = K.hash_kmer(lo, np)
    tbl = np.zeros(1 << bits, dtype=bool)
    tbl[(h >> np.uint64(64 - bits)).astype(np.int64)] = True
    cached = (tbl, bits)
    try:
        setattr(index, "_probe_prefilter", cached)
    except AttributeError:
        pass
    return cached


def _half_filter(index, bits: Optional[int] = None):
    """Pigeonhole half-k-mer occupancy table (cached on the index).

    Host analog of ops/hash_index.make_half_bitmap: h-prefixes and
    h-suffixes (h = (k-1)//2) of every index key in BOTH orientations,
    hashed with splitmix64 into a byte table. A 1-edit variant of a window
    keeps at least one half intact, so a window with both halves absent
    enumerates no variants at all (native/kmers.cpp side gating). Exact —
    false positives only cost probe work.
    """
    cached = getattr(index, "_half_filter", None)
    if cached is not None:
        return cached
    from . import kmers as K
    k = index.k
    h = (k - 1) // 2
    lo = np.asarray(index.keys_lo, np.uint64)
    m2h = np.uint64((1 << (2 * h)) - 1)
    sh = 2 * (k - h)
    if index.two_word:
        hi = np.asarray(index.keys_hi, np.uint64)
        rhi, rlo = K.revcomp_kmer2(hi, lo, k, np)
        alo = np.concatenate([lo, rlo])
        ahi = np.concatenate([hi, rhi])
        if sh >= 64:
            pre = ahi >> np.uint64(sh - 64)
        else:
            pre = ((ahi << np.uint64(64 - sh)) | (alo >> np.uint64(sh))) & m2h
    else:
        rlo = K.revcomp_kmer(lo, k, np)
        alo = np.concatenate([lo, rlo])
        pre = alo >> np.uint64(sh)
    suf = alo & m2h
    halves = np.concatenate([pre, suf])
    if bits is None:
        n = max(len(halves), 1)
        bits = min(28, max(20, int(np.ceil(np.log2(16 * n)))))
    hh = K.splitmix64(halves, np)
    tbl = np.zeros(1 << bits, dtype=np.uint8)
    tbl[(hh >> np.uint64(64 - bits)).astype(np.int64)] = 1
    cached = (tbl, bits, h)
    try:
        setattr(index, "_half_filter", cached)
    except AttributeError:
        pass
    return cached


def find_weak_seeds_batch(cdbg: Cdbg, reads, spans, *, subs: bool = True,
                          indels: bool = True, stride: int = 1,
                          near_exact_skip: int = 16,
                          max_hits_per_pos: int = 1) -> List[List[SolidRun]]:
    """Inexact (1-edit) seeds for many read spans in ONE index probe.

    TPU-native re-expression of the reference's masked inexact re-search
    (getSeeds, Graph.cpp:100-196 builds l_s and calls
    searchSequence(l_s, false, true, true, true, true)): all spans of a batch
    are concatenated (separated by an invalid base so no window crosses a
    boundary), every 1-edit variant key of every probed window is generated by
    vectorized bit surgery, canonicalized against a once-per-position
    reverse-complement, and resolved in ONE sorted-index lookup. Positions hit
    by more than `max_hits_per_pos` distinct unitig placements are dropped
    (the conflict-suppression role of keep_non_overlap,
    Alignment.cpp:1017-1199).

    spans: list of (read_idx, a, b). Returns, per span, single-k-mer
    SolidRuns with weak=True, absolute read positions, rspan in {k-1, k, k+1}.
    Substitutions and 1-bp indels are probed for every k <= 63 (two-word
    included — reference searchSequence probes indels too, Graph.cpp:100-196).
    """
    from . import kmers as K  # noqa: F401 (kept for parity with callers)
    k = cdbg.k
    out: List[List[SolidRun]] = [[] for _ in spans]
    if not spans:
        return out
    parts, starts = [], []
    off = 0
    sep = np.array([4], np.uint8)
    for ri, a, b in spans:
        seg = np.asarray(reads[ri][a:b], dtype=np.uint8)
        starts.append(off)
        parts.append(seg)
        parts.append(sep)
        off += len(seg) + 1
    concat = np.concatenate(parts)
    starts_arr = np.asarray(starts, np.int64)

    prefilter = _probe_prefilter(cdbg.index)
    index_keys = KeyArray(k, np.asarray(cdbg.index.keys_lo),
                          np.asarray(cdbg.index.keys_hi)
                          if cdbg.index.two_word else None)
    # exact windows first (1 key/position), VERIFIED against the index;
    # variant probing then skips positions close to a confirmed exact
    # hit — a waypoint only needs to exist every weak_seed_min_space
    # bases, so 1-edit probing near certain anchors is wasted work (and
    # in clean spans it vanishes entirely)
    ch0, cl0, fw0, wp0 = _canonical_variants(concat, k, "exact",
                                             starts_arr,
                                             prefilter=prefilter)
    pos_mask = None
    if wp0.size:
        rows0 = index_keys.find(KeyArray(k, cl0, ch0 if k > 32 else None))
        hit0 = rows0 >= 0
        ch0, cl0, fw0, wp0 = ch0[hit0], cl0[hit0], fw0[hit0], wp0[hit0]
    if wp0.size and near_exact_skip > 0:
        pos_mask = np.ones(len(concat), bool)
        for d in range(-near_exact_skip, near_exact_skip + 1):
            idx = np.clip(wp0 + d, 0, len(concat) - 1)
            pos_mask[idx] = False
    kinds = []
    if subs:
        kinds.append(("sub", k))
    if indels and k <= 63:
        kinds.append(("del", k + 1))
        kinds.append(("ins", k - 1))
    chs, cls, fws, poss, rsps, exs = [ch0], [cl0], [fw0], [wp0], \
        [np.full(len(wp0), k, np.int32)], [np.ones(len(wp0), bool)]
    for kind, rspan in kinds:
        ch, cl, fw, wp = _canonical_variants(concat, k, kind, starts_arr,
                                             stride=stride,
                                             prefilter=prefilter,
                                             pos_mask=pos_mask)
        chs.append(ch)
        cls.append(cl)
        fws.append(fw)
        poss.append(wp)
        rsps.append(np.full(len(wp), rspan, np.int32))
        exs.append(np.full(len(wp), False, bool))
    cl_cat = np.concatenate(cls)
    ch_cat = np.concatenate(chs)
    fw_cat = np.concatenate(fws)
    pos_cat = np.concatenate(poss)
    rsp_cat = np.concatenate(rsps)
    ex_cat = np.concatenate(exs)
    if cl_cat.size == 0:
        return out
    rows = index_keys.find(KeyArray(k, cl_cat, ch_cat if k > 32 else None))
    hit = rows >= 0
    if not hit.any():
        return out
    r = rows[hit]
    fwh = fw_cat[hit]
    gpos = pos_cat[hit]
    rsp = rsp_cat[hit]
    ex = ex_cat[hit]

    uid = np.asarray(cdbg.index.unitig_id)[r].astype(np.int64)
    direction = np.where(fwh == np.asarray(cdbg.index.strand)[r], 0, 1)
    o = np.where(direction == 0, np.asarray(cdbg.index.pos)[r],
                 cdbg.nkmers[uid] - 1 - np.asarray(cdbg.index.pos)[r])
    si = np.searchsorted(starts_arr, gpos, side="right") - 1
    rpos = gpos - starts_arr[si]

    # dedupe identical placements, then resolve per position: an exact
    # placement outranks 1-edit variant placements (it is the stronger
    # evidence, like the reference's exact-before-inexact search order);
    # conflicts only count within the strongest class present. The sort keys
    # pack into two int64 words (position id; placement id) so the lexsort
    # and dedupe run in two passes instead of seven (r5 host-plan profile).
    pk_pos = (si.astype(np.int64) << 32) | rpos
    pk_p1 = (uid << 1) | direction.astype(np.int64)
    pk_p2 = (o.astype(np.int64) << 2) | (rsp.astype(np.int64) - (k - 1))
    order = np.lexsort((pk_p2, pk_p1, pk_pos))
    pp, p1, p2, ex = pk_pos[order], pk_p1[order], pk_p2[order], ex[order]
    keep = np.concatenate([[True], (pp[1:] != pp[:-1]) | (p1[1:] != p1[:-1])
                           | (p2[1:] != p2[:-1])])
    # an exact hit and its identical sub-duplicate can't exist (sub excludes
    # the original base), so dedupe never merges across the exact flag
    order, pp, ex = order[keep], pp[keep], ex[keep]
    gnew = np.concatenate([[True], pp[1:] != pp[:-1]])
    gid = np.cumsum(gnew) - 1
    n_ex = np.bincount(gid, weights=ex.astype(np.float64)).astype(np.int64)
    n_all = np.bincount(gid)
    # exact rank within the group: 0 for the first exact member
    starts_idx = np.flatnonzero(gnew)
    cum_ex = np.cumsum(ex)
    grp_base = np.repeat(cum_ex[starts_idx] - ex[starts_idx],
                         np.diff(np.append(starts_idx, len(ex))))
    ex_rank = cum_ex - ex - grp_base
    first_exact = ex & (ex_rank == 0) & (n_ex[gid] <= max_hits_per_pos)
    first_plain = gnew & (n_ex[gid] == 0) & (n_all[gid] <= max_hits_per_pos)
    sel = order[first_exact | first_plain]
    span_a = [sp[1] for sp in spans]
    for s_i, p, u, d, oo, rs in zip(si[sel].tolist(), rpos[sel].tolist(),
                                    uid[sel].tolist(),
                                    direction[sel].tolist(), o[sel].tolist(),
                                    rsp[sel].tolist()):
        a = span_a[s_i]
        out[s_i].append(SolidRun(s=a + p, e=a + p, uid=u, direction=d,
                                 o_s=oo, weak=True, rspan=rs))
    return out


# ---------------------------------------------------------------------------
# Straight-line variant generators. Retained as independent oracles for the
# 128-bit surgery above (tests/test_weak_seeds.py cross-checks both against
# brute-force window edits); the production probe is find_weak_seeds_batch.
# ---------------------------------------------------------------------------

def _variant_keys_sub(lo: np.ndarray, k: int):
    """All 1-substitution variants of packed one-word k-mers.

    lo: uint64 [P]. Returns (keys uint64 [P*3k], pos_idx int32 [P*3k] original
    window index). The original base's variant is excluded.
    """
    P = len(lo)
    outs = []
    idxs = []
    base_idx = np.arange(P, dtype=np.int32)
    for p in range(k):
        s = np.uint64(2 * (k - 1 - p))
        orig = (lo >> s) & np.uint64(3)
        cleared = lo & ~(np.uint64(3) << s)
        for b in range(4):
            key = cleared | (np.uint64(b) << s)
            keep = orig != np.uint64(b)
            outs.append(key[keep])
            idxs.append(base_idx[keep])
    return np.concatenate(outs), np.concatenate(idxs)


def _variant_keys_sub2(hi: np.ndarray, lo: np.ndarray, k: int):
    """1-substitution variants of two-word k-mers (32 < k <= 64).

    hi packs bases 0..k-33, lo packs bases k-32..k-1 (ops/kmers.py layout).
    Returns (hi_keys, lo_keys, pos_idx)."""
    P = len(lo)
    out_hi, out_lo, idxs = [], [], []
    base_idx = np.arange(P, dtype=np.int32)
    for p in range(k):
        in_hi = p < k - 32
        s = np.uint64(2 * (k - 33 - p)) if in_hi else np.uint64(2 * (k - 1 - p))
        w = hi if in_hi else lo
        orig = (w >> s) & np.uint64(3)
        cleared = w & ~(np.uint64(3) << s)
        for b in range(4):
            key = cleared | (np.uint64(b) << s)
            keep = orig != np.uint64(b)
            out_hi.append((key if in_hi else hi)[keep])
            out_lo.append((lo if in_hi else key)[keep])
            idxs.append(base_idx[keep])
    return (np.concatenate(out_hi), np.concatenate(out_lo),
            np.concatenate(idxs))


def _variant_keys_del(w: np.ndarray, k: int):
    """k-mers formed by dropping one base of packed (k+1)-windows (the read
    carries one EXTRA base). w: uint64 [P] (k+1 bases, needs 2(k+1) <= 64).
    Returns (keys, pos_idx). Dropping base 0 or k equals a shifted exact
    window, so only interior positions 1..k-1 are emitted."""
    P = len(w)
    outs = []
    idxs = []
    base_idx = np.arange(P, dtype=np.int32)
    for p in range(1, k):
        hi = w >> np.uint64(2 * (k + 1 - p))
        lo_mask = np.uint64((1 << (2 * (k - p))) - 1)
        lo = w & lo_mask
        outs.append((hi << np.uint64(2 * (k - p))) | lo)
        idxs.append(base_idx)
    return np.concatenate(outs), np.concatenate(idxs)


def _variant_keys_ins(w: np.ndarray, k: int):
    """k-mers formed by inserting one base into packed (k-1)-windows (the read
    LOST one base). w: uint64 [P] of k-1 bases. Returns (keys, pos_idx);
    interior insert positions 1..k-1 only (edges equal shifted windows)."""
    P = len(w)
    outs = []
    idxs = []
    base_idx = np.arange(P, dtype=np.int32)
    for p in range(1, k):
        hi = w >> np.uint64(2 * (k - 1 - p))
        lo_mask = np.uint64((1 << (2 * (k - 1 - p))) - 1)
        lo = w & lo_mask
        stem = (hi << np.uint64(2 * (k - p))) | lo
        for b in range(4):
            outs.append(stem | (np.uint64(b) << np.uint64(2 * (k - 1 - p))))
            idxs.append(base_idx)
    return np.concatenate(outs), np.concatenate(idxs)


def find_weak_seeds(cdbg: Cdbg, codes: np.ndarray, a: int, b: int,
                    *, subs: bool = True, indels: bool = True,
                    stride: int = 1,
                    max_hits_per_pos: int = 1) -> List[SolidRun]:
    """Inexact (1-edit) seeds inside read span [a, b) — single-span wrapper
    over `find_weak_seeds_batch` (the batched probe is the production path)."""
    if b - a < cdbg.k:
        return []
    return find_weak_seeds_batch(cdbg, [codes], [(0, a, b)], subs=subs,
                                 indels=indels, stride=stride,
                                 max_hits_per_pos=max_hits_per_pos)[0]


def select_waypoints(seeds: List[SolidRun], colors: GraphColors,
                     flank_rows: np.ndarray, *, min_cov: int = 2,
                     min_space: int = 64, lo: int = 0, hi: int = 1 << 30
                     ) -> List[SolidRun]:
    """Greedy left-to-right waypoint chain: color-consistent with the flanking
    anchors (>= min_cov shared reads) and spaced >= min_space apart and from
    the span edges (so every leg gives the beam real work + certification)."""
    if not seeds:
        return []
    uids = np.array([s.uid for s in seeds])
    # one flat searchsorted against the (single) flank row beats the
    # generic row-wise binary search (hot planner path)
    fl = flank_rows[flank_rows != CS.PAD]
    rowsu = colors.rows[uids]
    if fl.size:
        pos = np.searchsorted(fl, rowsu.ravel())
        hit = (pos < fl.size) & (fl[np.minimum(pos, fl.size - 1)]
                                 == rowsu.ravel()) & (rowsu.ravel() != CS.PAD)
        shared = hit.reshape(rowsu.shape).sum(axis=1)
    else:
        shared = np.zeros(len(uids), dtype=np.int64)
    out = []
    last = lo
    for s, sh in zip(seeds, shared):
        if int(sh) < min_cov:
            continue
        if s.s - last < min_space or hi - s.s < min_space:
            continue
        out.append(s)
        last = s.s
    return out


def filter_runs_by_color(runs: List[SolidRun], colors: GraphColors,
                         min_cov: int = 2) -> List[SolidRun]:
    """Drop adjacent-run pairs whose unitigs share < min_cov read colors.

    The reference kills both runs of an inconsistent junction
    (Graph.cpp:325-372); single-k-mer repeat hits die here.
    """
    if len(runs) <= 1:
        return runs
    uids = np.array([r.uid for r in runs])
    lens = np.array([r.e - r.s for r in runs])
    diff = uids[:-1] != uids[1:]
    cnt = np.full(len(runs) - 1, min_cov, dtype=np.int32)
    sel = np.flatnonzero(diff)
    if sel.size:
        cnt[sel] = CS.intersect_count(colors.rows[uids[sel]],
                                      colors.rows[uids[sel + 1]], np)
    kill = np.zeros(len(runs), dtype=bool)
    bad = np.flatnonzero(diff & (cnt < min_cov))
    for i in bad:
        la, lb = lens[i], lens[i + 1]
        if la == 0 and lb > 2:
            kill[i] = True
        elif lb == 0 and la > 2:
            kill[i + 1] = True
        else:
            kill[i] = kill[i + 1] = True
    return [r for r, dead in zip(runs, kill) if not dead]
