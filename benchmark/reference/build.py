"""Compacted de Bruijn graph construction: k-mer counting + unitig compaction.

Host-side NumPy re-expression of the Bifrost contract the reference depends on
(`CompactedDBG<UnitigData>::build` — SURVEY.md §2.3; Ratatosk.cpp:1066,1081).
Construction is a one-time cost per dataset; correction (the throughput path)
runs on device. Every step is a vectorized sort/scan/scatter pass so the same
data-flow can later move onto device and shard across hosts.

Pipeline:
  1. count_kmers      — canonical k-mers of all reads, sort, run-length count,
                        keep count >= min_count (Bifrost: >=2 from reads, >=1 ref)
  2. compact_unitigs  — oriented-node DBG; "simple" edges (outdeg(u)==1 &&
                        indeg(v)==1) chain into unitigs via Wyllie pointer
                        doubling; twin chains deduplicated; cycles broken at
                        their minimum node
  3. Cdbg             — unitig catalog (concatenated 2-bit codes + offsets),
                        canonical k-mer -> (unitig,pos,strand) KmerIndex, and
                        successor table [N,2,4] of packed (vid<<1|dir) edges
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np

from .keys import KeyArray
from .kmer_index import KmerIndex


def _canonical_all(codes: np.ndarray, k: int):
    """Canonical keys of EVERY window of one code array (full length L-k+1).

    Returns (lo, hi|None, valid, is_fw); invalid windows carry garbage keys.
    """
    ka, valid = KeyArray.from_codes(codes, k)
    can, is_fw = ka.canonical()
    return can.lo, can.hi, valid, is_fw


def count_kmers(seqs: Iterable[np.ndarray], k: int, min_count: int = 2,
                max_count: Optional[int] = None) -> tuple[KeyArray, np.ndarray]:
    """Count canonical k-mers over base-code arrays.

    Returns (sorted unique solid keys, counts). Reads shorter than k and
    windows containing non-ACGT are skipped (Bifrost behavior). Reads are
    concatenated (separated by an invalid base) and packed in ~8 MB batches —
    one vectorized pass per batch, not one per read.
    """
    chunks_lo, chunks_hi = [], []
    parts: list = []
    bp = 0
    sep = np.array([4], np.uint8)

    def flush():
        nonlocal bp
        if not parts:
            return
        concat = np.concatenate(parts)
        parts.clear()
        bp = 0
        lo, hi, valid, _ = _canonical_all(concat, k)
        sel = np.flatnonzero(valid)
        chunks_lo.append(lo[sel])
        if hi is not None:
            chunks_hi.append(hi[sel])

    for codes in seqs:
        if codes.shape[-1] < k:
            continue
        parts.append(np.asarray(codes, np.uint8))
        parts.append(sep)
        bp += len(codes) + 1
        if bp >= (1 << 23):
            flush()
    flush()
    if not chunks_lo:
        empty = KeyArray(k, np.zeros(0, np.uint64), np.zeros(0, np.uint64) if k > 32 else None)
        return empty, np.zeros(0, np.int64)
    allk = KeyArray(k, np.concatenate(chunks_lo),
                    np.concatenate(chunks_hi) if chunks_hi else None)
    order = allk.sort_order()
    allk = allk.take(order)
    uniq, counts = allk.dedupe_sorted()
    keep = counts >= min_count
    if max_count is not None:
        keep &= counts <= max_count
    sel = np.flatnonzero(keep)
    return uniq.take(sel), counts[sel]


def _oriented_keys(solid: KeyArray) -> KeyArray:
    """Node u = 2*i + o: o=0 canonical(forward-as-stored), o=1 its revcomp."""
    rc = solid.revcomp()
    lo = np.empty(2 * len(solid), dtype=np.uint64)
    lo[0::2] = solid.lo
    lo[1::2] = rc.lo
    hi = None
    if solid.hi is not None:
        hi = np.empty(2 * len(solid), dtype=np.uint64)
        hi[0::2] = solid.hi
        hi[1::2] = rc.hi
    return KeyArray(solid.k, lo, hi)


def _successors(solid: KeyArray, oriented: KeyArray):
    """succ_node int64 [2M,4] (oriented target or -1) for each oriented
    node: each extension canonicalised and binary-searched in `solid`."""
    m2 = len(oriented)
    succ = np.full((m2, 4), -1, dtype=np.int64)
    for c in range(4):
        ext = oriented.shift_append(c)
        can, is_fw = ext.canonical()
        j = solid.find(can)
        hit = j >= 0
        succ[hit, c] = 2 * j[hit] + np.where(is_fw[hit], 0, 1)
    return succ


def compact_unitigs(solid: KeyArray):
    """Chain simple edges into unitigs.

    Returns (useq, uoff): concatenated unitig base codes + offsets [N+1].
    """
    k = solid.k
    m = len(solid)
    if m == 0:
        return np.zeros(0, np.uint8), np.zeros(1, np.int64)
    oriented = _oriented_keys(solid)
    succ = _successors(solid, oriented)
    exists = succ >= 0
    outdeg = exists.sum(axis=1)

    nodes = np.arange(2 * m, dtype=np.int64)
    twin = nodes ^ 1

    # next[u] = unique successor v when outdeg(u)==1 and indeg(v)==1
    # (indeg(v) == outdeg(twin(v)): predecessors of v are twins of succ(twin(v)))
    uniq_c = np.argmax(exists, axis=1)
    v = succ[nodes, uniq_c]
    v_safe = np.maximum(v, 0)
    simple = (outdeg == 1) & (outdeg[v_safe ^ 1] == 1) & (v != nodes) & (v != twin)
    nxt = np.where(simple, v, -1)

    # prev by scatter; twin symmetry (next[u]=v <=> next[twin v]=twin u) makes
    # each target unique, but guard against palindromic-edge double-hits anyway
    prv = np.full(2 * m, -1, dtype=np.int64)
    src = np.flatnonzero(nxt >= 0)
    prv[nxt[src]] = src

    # nxt/prv must agree (a v with indeg!=1 was never assigned via simple)
    bad = (nxt >= 0) & (prv[np.maximum(nxt, 0)] != nodes)
    if bad.any():  # defensive: break such edges symmetrically
        nxt[bad] = -1
        prv = np.full(2 * m, -1, dtype=np.int64)
        src = np.flatnonzero(nxt >= 0)
        prv[nxt[src]] = src

    log_steps = max(1, int(np.ceil(np.log2(2 * m + 1))))

    # cycle detection: min-doubling over prv; cycle nodes never reach a head.
    # Early exit once every pointer reaches a fixpoint (chains are much
    # shorter than 2m, so most of the log2(2m) budget is usually idle); one
    # settle pass keeps mn's min-merge idempotent-correct.
    p = np.where(prv >= 0, prv, nodes)
    mn = nodes.copy()
    for _ in range(log_steps):
        mn = np.minimum(mn, mn[p])
        pn = p[p]
        if np.array_equal(pn, p):
            mn = np.minimum(mn, mn[p])
            break
        p = pn
    in_cycle = prv[p] >= 0  # converged pointer still has a predecessor => cycle
    # cut each cycle at its minimum node b (edge prv[b] -> b), and cut the twin
    # cycle at the twin edge (twin(b) -> twin(prv[b])) so the two resulting
    # chains stay exact twins; trigger only from the lesser of the two cycle
    # minima (== handles self-twin cycles, which then get a single cut)
    trigger = in_cycle & (mn == nodes) & (nodes <= mn[twin])
    if trigger.any():
        b = np.flatnonzero(trigger)
        a = prv[b]
        nxt[a] = -1
        prv[b] = -1
        nxt[b ^ 1] = -1
        prv[a ^ 1] = -1

    # Wyllie doubling: head + rank for every node (early exit: once p is at
    # its head fixpoint, s additions pick up s[head] = 0)
    p = np.where(prv >= 0, prv, nodes)
    s = (prv >= 0).astype(np.int64)
    for _ in range(log_steps):
        s = s + s[p]
        pn = p[p]
        if np.array_equal(pn, p):
            break
        p = pn
    head, rank = p, s

    # chains: emit once per twin pair — chain c (head h, tail t) is the twin of
    # the chain headed by twin(t); emit iff h <= twin(t)
    heads = np.flatnonzero(prv < 0)
    tail_of = np.full(2 * m, -1, dtype=np.int64)
    is_tail = nxt < 0
    tail_nodes = np.flatnonzero(is_tail)
    tail_of[head[tail_nodes]] = tail_nodes
    # chain length = tail rank + 1 (tails are unique per chain, so a direct
    # scatter replaces the much slower np.maximum.at ufunc loop)
    chain_len = np.zeros(2 * m, dtype=np.int64)
    chain_len[head[tail_nodes]] = rank[tail_nodes] + 1
    emit_heads = heads[heads <= (tail_of[heads] ^ 1)]

    n_unitigs = emit_heads.shape[0]
    lens_kmers = chain_len[emit_heads]             # unitig length in k-mers
    lens_bp = lens_kmers + (k - 1)
    uoff = np.zeros(n_unitigs + 1, dtype=np.int64)
    np.cumsum(lens_bp, out=uoff[1:])
    useq = np.empty(uoff[-1], dtype=np.uint8)

    # materialize: head contributes k bases; rank-r node contributes 1 base
    unitig_of_head = np.full(2 * m, -1, dtype=np.int64)
    unitig_of_head[emit_heads] = np.arange(n_unitigs)
    uid = unitig_of_head[head]                     # -1 for non-emitted chains
    emitted = uid >= 0
    en = np.flatnonzero(emitted & (rank > 0))
    useq[uoff[uid[en]] + k - 1 + rank[en]] = oriented.take(en).last_base()
    head_codes = oriented.take(emit_heads).unpack()   # [n_unitigs, k]
    idx = uoff[:-1, None] + np.arange(k)[None, :]
    useq[idx] = head_codes
    return useq, uoff


@dataclasses.dataclass
class Cdbg:
    """Compacted DBG: catalog + index + successor table.

    Edge encoding: edges[u, s, c] = (v << 1) | dir, or -1. Leaving unitig u on
    strand s (0=forward end, 1=rc of the left end) with base c enters unitig v
    traversed in direction dir (0=forward, 1=reverse). Mirrors the reference's
    per-edge topology implied by `getSuccessors()` (SURVEY.md §2.3).
    """

    k: int
    useq: np.ndarray     # uint8 [total_bp], 2-bit codes, unitigs concatenated
    uoff: np.ndarray     # int64 [N+1]
    index: KmerIndex     # canonical k-mer -> (unitig, pos, strand)
    edges: np.ndarray    # int32 [N, 2, 4], packed (v<<1|dir) or -1

    @property
    def n_unitigs(self) -> int:
        return self.uoff.shape[0] - 1

    @property
    def ulen(self) -> np.ndarray:
        return np.diff(self.uoff)

    @property
    def nkmers(self) -> np.ndarray:
        return self.ulen - (self.k - 1)

    def unitig_codes(self, u: int) -> np.ndarray:
        return self.useq[self.uoff[u]:self.uoff[u + 1]]

    def total_kmers(self) -> int:
        return int(self.nkmers.sum())


def catalog_kmer_positions(useq: np.ndarray, uoff: np.ndarray, k: int):
    """Canonical keys + (unitig, pos, strand) for every k-mer in the catalog."""
    if useq.shape[0] == 0 or uoff.shape[0] <= 1:
        empty = KeyArray(k, np.zeros(0, np.uint64), np.zeros(0, np.uint64) if k > 32 else None)
        return empty, np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0, bool)
    lo, hi, valid, is_fw = _canonical_all(useq, k)
    npos = useq.shape[0] - k + 1
    # window starting at catalog position t belongs to unitig u iff
    # t + k <= uoff[u+1]; find u by searchsorted and keep in-bounds windows
    t = np.arange(npos, dtype=np.int64)
    u = np.searchsorted(uoff, t, side="right") - 1
    ok = ((t + k) <= uoff[u + 1]) & valid
    sel = np.flatnonzero(ok)
    can = KeyArray(k, lo[sel], hi[sel] if hi is not None else None)
    return can, u[sel], t[sel] - uoff[u[sel]], is_fw[sel]


def build_cdbg(seqs: Iterable[np.ndarray], k: int, min_count: int = 2,
               solid: Optional[KeyArray] = None) -> Cdbg:
    """Full cDBG build from reads (or from a precomputed solid k-mer set)."""
    if solid is None:
        solid, _ = count_kmers(seqs, k, min_count)
    useq, uoff = compact_unitigs(solid)
    can, uid, pos, is_fw = catalog_kmer_positions(useq, uoff, k)
    index = KmerIndex.build(
        k,
        keys_lo=can.lo, keys_hi=can.hi,
        unitig_id=uid, pos=pos, strand=is_fw,
    )
    edges = _build_edges(useq, uoff, index, k)
    return Cdbg(k=k, useq=useq, uoff=uoff, index=index, edges=edges)


def _end_kmers(useq: np.ndarray, uoff: np.ndarray, k: int) -> tuple[KeyArray, KeyArray]:
    """(forward end k-mer, rc of the first k-mer) per unitig."""
    n = uoff.shape[0] - 1
    idx_last = (uoff[1:] - k)[:, None] + np.arange(k)[None, :]
    idx_first = uoff[:-1, None] + np.arange(k)[None, :]

    def pack_rows(rows: np.ndarray) -> KeyArray:
        ka, _ = KeyArray.from_codes(rows.reshape(-1), k)
        # rows are contiguous length-k windows at stride k
        stride = np.arange(n, dtype=np.int64) * k
        return ka.take(stride)

    fw_end = pack_rows(useq[idx_last])
    first = pack_rows(useq[idx_first])
    return fw_end, first.revcomp()


def _build_edges(useq: np.ndarray, uoff: np.ndarray, index: KmerIndex, k: int) -> np.ndarray:
    n = uoff.shape[0] - 1
    edges = np.full((n, 2, 4), -1, dtype=np.int32)
    if n == 0:
        return edges
    nk = np.diff(uoff) - (k - 1)
    keys = KeyArray(k, np.asarray(index.keys_lo),
                    np.asarray(index.keys_hi) if index.two_word else None)
    iuid = np.asarray(index.unitig_id)
    ipos = np.asarray(index.pos)
    istr = np.asarray(index.strand)
    fw_end, bw_end = _end_kmers(useq, uoff, k)
    for s, end in ((0, fw_end), (1, bw_end)):
        for c in range(4):
            ext = end.shift_append(c)
            can, is_fw = ext.canonical()
            row = keys.find(can)
            hit = row >= 0
            r = row[hit]
            # ext oriented == unitig-forward k-mer at (uid, pos) iff
            # is_fw (ext canonical orientation) matches stored strand
            enter_fw = is_fw[hit] == istr[r]
            vu = iuid[r].astype(np.int64)
            vpos = ipos[r].astype(np.int64)
            ok = np.where(enter_fw, vpos == 0, vpos == nk[vu] - 1)
            val = np.where(ok, (vu << 1) | np.where(enter_fw, 0, 1), -1)
            edges[np.flatnonzero(hit), s, c] = val.astype(np.int32)
    return edges
