"""Graph coloring: map short reads onto unitigs, build color sets + coverage.

Re-expresses the reference's `addCoverage` anchoring/coloring phases
(Graph.cpp:1561-3366, SURVEY.md §2.2(3)) as sort/scatter passes — no
lock-striped graph writes (`LockGraph`, Graph.cpp:1599-1667): read->unitig
hits become (unitig, read_id) pairs, deduplicated and segment-reduced.

Scale properties (the disk-spill/merge role of Graph.cpp:803-867,1911-1958):
reads stream through in ~chunk_bp batches — each batch is ONE packed
canonicalization + ONE sorted-index probe for every k-mer of every read in
the batch — and the accumulated pair set is kept as a single sorted-unique
array that is merged once per batch, so peak memory is O(unique pairs +
batch), never O(all hits).

Coverage-stratified subsampling (Graph.cpp:2312-2871): when the estimated
per-haplotype coverage is high, read colors are downsampled by a
deterministic per-read-id hash with a keep rate derived from the coverage
decile of the read's canonical (first-hit) unitig, keeping >= keep_min reads
per unitig; surviving ids are compacted to a dense range.

Color sets are padded sorted rows (ops/colorset.py) capped at
max_cov_vertices=128 (Common.hpp:128 — the reference's disk-spill threshold);
true cardinality is kept separately. Edge support mirrors UnitigData's
shared_pids bits (UnitigData.hpp:577): edge (u,v) is read-supported iff
|colors(u) ∩ colors(v)| >= min_cov_vertices (Graph.cpp:2003,2015).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Sequence

import numpy as np

from .build import Cdbg
from .keys import KeyArray
from . import colorset as CS
from . import kmers as K


@dataclasses.dataclass
class GraphColors:
    cap: int
    rows: np.ndarray          # [N, cap] int32 sorted read ids, PAD padded.
                              # When card > cap the row is a FAIR deterministic
                              # sample (smallest splitmix64(id) hashes), not
                              # the lowest ids — lowest-id truncation is
                              # haplotype-biased when mates are file-ordered
    card: np.ndarray          # [N] int32 true color cardinality
    coverage: np.ndarray      # [N] int64 mapped k-mer count (unphased cov)
    edge_support: np.ndarray  # [N, 2, 4] bool
    n_colors: int             # number of distinct read ids
    # full pre-subsample pair CSR (SharedPairID's exact-set role): uid-major
    # sorted read ids; an np.memmap when the build spilled to disk. Used for
    # exact edge support and SNP-candidate neighborhood validation
    # (detectSNPs/isValidSNPcandidate intersect FULL sets). None after
    # loading a persisted index.
    csr_offsets: Optional[np.ndarray] = None   # int64 [N+1]
    csr_rids: Optional[np.ndarray] = None      # int32 [pairs]
    # edges rescued by the k2 graph (addCoverage phase 7): the beam exempts
    # them from the >= min_cov shared-color branch filter — the long-k
    # context is the certification (graph/rescue_edges.py)
    edge_rescued: Optional[np.ndarray] = None  # bool [N, 2, 4]

    def full_row(self, uid: int) -> np.ndarray:
        """Full sorted id set of a unitig (falls back to the capped row)."""
        if self.csr_offsets is not None:
            a, b = self.csr_offsets[uid], self.csr_offsets[uid + 1]
            return np.asarray(self.csr_rids[a:b])
        r = self.rows[uid]
        return r[r != CS.PAD]


def map_reads_to_unitigs(cdbg: Cdbg, reads: Sequence[np.ndarray]):
    """For each read, the unitig row hit per k-mer position (-1 = miss).

    Returns list of int64 arrays (index rows), one per read.
    """
    keys = KeyArray(cdbg.k, np.asarray(cdbg.index.keys_lo),
                    np.asarray(cdbg.index.keys_hi) if cdbg.index.two_word else None)
    out = []
    for codes in reads:
        if codes.shape[-1] < cdbg.k:
            out.append(np.full(0, -1, dtype=np.int64))
            continue
        ka, valid = KeyArray.from_codes(codes, cdbg.k)
        can, _ = ka.canonical()
        rows = keys.find(can)
        rows[~valid] = -1
        out.append(rows)
    return out


def _probe_chunk(cdbg: Cdbg, keys: KeyArray, chunk_reads, chunk_rids,
                 cov: np.ndarray):
    """One batched probe of a read chunk. Returns (pairs sorted-unique int64
    (uid<<32|rid), first-hit uid per read int64 [n], rids int64 [n])."""
    k = cdbg.k
    parts, starts = [], []
    off = 0
    sep = np.array([4], np.uint8)
    for codes in chunk_reads:
        starts.append(off)
        parts.append(np.asarray(codes, dtype=np.uint8))
        parts.append(sep)
        off += len(codes) + 1
    concat = np.concatenate(parts)
    starts_arr = np.asarray(starts, np.int64)
    first_uid = np.full(len(chunk_reads), -1, dtype=np.int64)
    ka, valid = KeyArray.from_codes(concat, k)
    sel = np.flatnonzero(valid)
    if sel.size == 0:
        return np.zeros(0, np.int64), first_uid
    can, _ = ka.take(sel).canonical()
    rows = keys.find(can)
    hit = rows >= 0
    if not hit.any():
        return np.zeros(0, np.int64), first_uid
    rowh = rows[hit]
    gpos = sel[hit]
    iuid = np.asarray(cdbg.index.unitig_id)
    uids = iuid[rowh].astype(np.int64)
    # coverage via bincount (np.add.at is orders slower at this volume)
    cov += np.bincount(uids, minlength=len(cov)).astype(cov.dtype)
    ridx = np.searchsorted(starts_arr, gpos, side="right") - 1
    # first hit per read = canonical unitig (anchoring phase pick,
    # Graph.cpp:1682-1691); gpos ascends, so ridx is non-decreasing and the
    # first entry of each ridx run is the read's first hit
    fnew = np.concatenate([[True], ridx[1:] != ridx[:-1]])
    first_uid[ridx[fnew]] = uids[fnew]
    rid_arr = np.asarray(chunk_rids, np.int64)[ridx]
    pairs = np.unique((uids << 32) | rid_arr)
    return pairs, first_uid


def _merge_unique(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if a.size == 0:
        return b
    if b.size == 0:
        return a
    out = np.empty(a.size + b.size, dtype=np.int64)
    np.concatenate([a, b], out=out)
    out.sort(kind="stable")
    keep = np.empty(out.size, bool)
    keep[0] = True
    np.not_equal(out[1:], out[:-1], out=keep[1:])
    return out[keep]


class PairStore:
    """Sorted-unique (uid<<32|rid) pair accumulator with disk spill.

    The memory-scaling role of the reference's PairID disk buffering
    (writeGraphPairID, Graph.cpp:803-823; flush at buffer_sz_read2disk,
    Graph.cpp:2164-2237; mergeDiskPairIDs, Graph.cpp:843-867,1911-1958): the
    in-memory sorted array spills to a .npy chunk whenever it exceeds
    `spill_bytes`, and `merged_blocks()` streams the global k-way merge in
    uid-aligned sorted-unique blocks, so peak memory is
    O(spill_bytes + block) regardless of total pair count.
    """

    def __init__(self, spill_bytes: int = 1 << 31,
                 spill_dir: Optional[str] = None):
        self._mem = np.zeros(0, dtype=np.int64)
        self.spill_bytes = spill_bytes
        self.spill_dir = spill_dir
        self.files: list = []
        self.max_live_bytes = 0
        self._pending: list = []
        self._pending_bytes = 0

    def add(self, pairs: np.ndarray) -> None:
        """Queue a sorted-unique chunk (consolidated lazily: a per-chunk
        merge into the full accumulator is quadratic at chromosome scale —
        chunks are instead concatenated and deduped in one sort when read
        or when the spill threshold trips)."""
        if pairs.size == 0:
            return
        self._pending.append(pairs)
        self._pending_bytes += int(pairs.nbytes)
        if self._mem.nbytes + self._pending_bytes >= self.spill_bytes:
            self._consolidate()
            if self._mem.nbytes >= self.spill_bytes:
                self._spill()

    def _consolidate(self) -> None:
        if not self._pending:
            return
        arrays = ([self._mem] if self._mem.size else []) + self._pending
        out = np.concatenate(arrays)
        self._pending.clear()
        self._pending_bytes = 0
        out.sort(kind="stable")
        keep = np.empty(out.size, bool)
        keep[0] = True
        np.not_equal(out[1:], out[:-1], out=keep[1:])
        self._mem = out[keep]
        self.max_live_bytes = max(self.max_live_bytes, int(out.nbytes))

    @property
    def mem(self) -> np.ndarray:
        self._consolidate()
        return self._mem

    def _spill(self) -> None:
        import tempfile
        self._consolidate()
        f = tempfile.NamedTemporaryFile(dir=self.spill_dir,
                                        suffix=".pairs.npy", delete=False)
        np.save(f, self._mem)
        f.close()
        self.files.append(f.name)
        self._mem = np.zeros(0, dtype=np.int64)

    def merged_blocks(self, block: int = 1 << 21):
        """Yield sorted-unique pair blocks covering WHOLE unitigs when
        possible (block cut points snap to uid boundaries so per-unitig group
        logic downstream never straddles blocks except for groups larger than
        `block` pairs)."""
        if not self.files:
            if self.mem.size:
                yield self.mem
            return
        sources = [np.load(p, mmap_mode="r") for p in self.files]
        if self.mem.size:
            sources.append(self.mem)
        # bound the merged block: each source contributes <= block/k pairs,
        # so live memory stays ~block regardless of spill-file count
        block = max(1 << 16, block // len(sources))
        pos = [0] * len(sources)
        while True:
            live = [i for i in range(len(sources))
                    if pos[i] < len(sources[i])]
            if not live:
                break
            # threshold: smallest per-source block-end value
            t = min(int(sources[i][min(pos[i] + block, len(sources[i])) - 1])
                    for i in live)
            # snap down to a uid boundary so groups stay whole
            t_snap = ((t >> 32) << 32) - 1
            if any(int(sources[i][pos[i]]) <= t_snap for i in live):
                t = t_snap
            parts = []
            for i in live:
                src = sources[i]
                hi = int(np.searchsorted(src[pos[i]:], t, side="right"))
                if hi:
                    parts.append(np.asarray(src[pos[i]:pos[i] + hi]))
                    pos[i] += hi
            merged = parts[0] if len(parts) == 1 else _merge_unique(
                parts[0], parts[1] if len(parts) > 1 else np.zeros(0, np.int64))
            for p in parts[2:]:
                merged = _merge_unique(merged, p)
            self.max_live_bytes = max(self.max_live_bytes, int(merged.nbytes))
            if merged.size:
                yield merged

    def cleanup(self) -> None:
        import os as _os
        for p in self.files:
            try:
                _os.remove(p)
            except OSError:
                pass
        self.files = []


def subsample_colors(combo: np.ndarray, first_uid_of_read: dict,
                     cov_per_kmer: np.ndarray, *, target_cov: float = 5.0,
                     min_est_cov: float = 10.0, keep_min: int = 2):
    """Coverage-stratified color subsampling (Graph.cpp:2312-2871).

    combo: sorted-unique (uid<<32|rid) pairs. Reads are kept with a
    deterministic hash test whose rate is derived from the coverage decile of
    their canonical (first-hit) unitig; unitigs left with < keep_min colors
    get their keep_min smallest-hash reads restored. Returns (combo',
    id_remap dict old->new, n_colors) — surviving ids compacted to a dense
    range (Graph.cpp:2583-2643).
    """
    if combo.size == 0:
        return combo, None, 0
    est = float(np.median(cov_per_kmer[cov_per_kmer > 0])) if \
        (cov_per_kmer > 0).any() else 0.0
    if est < min_est_cov:
        return combo, None, int(np.unique(combo & 0xFFFFFFFF).size)
    rids = (combo & 0xFFFFFFFF).astype(np.uint64)
    uids = (combo >> 32).astype(np.int64)
    # per-read keep rate from its canonical unitig's coverage decile
    all_rids = np.unique(rids).astype(np.int64)
    r_uid = np.array([first_uid_of_read.get(int(r), -1) for r in all_rids],
                     dtype=np.int64)
    r_cov = np.where(r_uid >= 0, cov_per_kmer[np.maximum(r_uid, 0)], est)
    rate = np.minimum(target_cov / np.maximum(r_cov, 1e-9), 1.0)
    h = K.splitmix64(all_rids.astype(np.uint64), np)
    keep_read = h < (rate * float(2**64 - 1)).astype(np.uint64)
    keep_set = np.zeros(int(all_rids.max()) + 1, bool)
    keep_set[all_rids[keep_read]] = True
    keep = keep_set[rids.astype(np.int64)]
    # restore >= keep_min reads per unitig (smallest hash wins — deterministic)
    hp = K.splitmix64(rids, np)
    order = np.lexsort((hp, uids))
    u_o, h_o, k_o = uids[order], hp[order], keep[order]
    gnew = np.concatenate([[True], u_o[1:] != u_o[:-1]])
    gid = np.cumsum(gnew) - 1
    kept_per_u = np.bincount(gid, weights=k_o.astype(np.float64))
    rank = np.arange(len(u_o)) - np.repeat(np.flatnonzero(gnew),
                                           np.diff(np.append(np.flatnonzero(gnew), len(u_o))))
    restore = (kept_per_u[gid] < keep_min) & (rank < keep_min)
    k_o = k_o | restore
    keep2 = np.zeros_like(keep)
    keep2[order] = k_o
    combo2 = combo[keep2]
    old_ids = np.unique(combo2 & 0xFFFFFFFF)
    remap = {int(o): i for i, o in enumerate(old_ids)}
    new_rid = np.searchsorted(old_ids, combo2 & 0xFFFFFFFF)
    combo2 = ((combo2 >> 32) << 32) | new_rid
    combo2 = np.unique(combo2)
    return combo2, remap, int(old_ids.size)


def color_graph(cdbg: Cdbg, reads: Iterable[np.ndarray],
                read_ids: Optional[Sequence[int]] = None,
                cap: int = 128, min_cov_edge: int = 2,
                sampling_rate: float = 1.0,
                chunk_bp: int = 1 << 22,
                auto_subsample: bool = False,
                target_cov: float = 5.0,
                spill_bytes: Optional[int] = None,
                spill_dir: Optional[str] = None) -> GraphColors:
    """Stream reads, build color rows + coverage + edge support.

    read_ids: color id per read (paired reads share one id, matching the
    reference's paired-read ID sets); defaults to the read's ordinal.
    sampling_rate < 1 drops color ids Bernoulli-style (reference `-S`,
    Graph.cpp:2117-2127) — deterministically by id hash, so distributed
    replicas agree. auto_subsample additionally applies coverage-stratified
    subsampling when estimated coverage >= 10 (addCoverage phase 5).
    Coverage still counts every read.

    spill_bytes: cap on in-memory pair bytes before spilling sorted chunks
    to disk (PairStore) — the reference's 4 GB PairID spill
    (Common.hpp:136, Graph.cpp:2164-2237). None = fully in memory.
    """
    n = cdbg.n_unitigs
    cov = np.zeros(n, dtype=np.int64)
    keys = KeyArray(cdbg.k, np.asarray(cdbg.index.keys_lo),
                    np.asarray(cdbg.index.keys_hi) if cdbg.index.two_word else None)
    store = PairStore(spill_bytes=spill_bytes or (1 << 62),
                      spill_dir=spill_dir)
    first_uid_of_read: dict = {}
    chunk_reads: list = []
    chunk_rids: list = []
    bp = 0
    rid_iter = iter(read_ids) if read_ids is not None else None
    max_rid = -1

    def flush():
        nonlocal bp
        if not chunk_reads:
            return
        pairs, first_uid = _probe_chunk(cdbg, keys, chunk_reads, chunk_rids, cov)
        for r, u in zip(chunk_rids, first_uid):
            if u >= 0 and r not in first_uid_of_read:
                first_uid_of_read[r] = int(u)
        if sampling_rate < 1.0 and pairs.size:
            # Bernoulli -S drop by deterministic id hash, applied pre-store
            rid_all = (pairs & np.int64(0xFFFFFFFF)).astype(np.uint64)
            keep_p = K.splitmix64(rid_all, np) < np.uint64(
                int(sampling_rate * float(2**64 - 1)))
            pairs = pairs[keep_p]
        store.add(pairs)
        chunk_reads.clear()
        chunk_rids.clear()
        bp = 0

    for i, codes in enumerate(reads):
        rid = next(rid_iter) if rid_iter is not None else i
        max_rid = max(max_rid, rid)
        if codes.shape[-1] < cdbg.k:
            continue
        chunk_reads.append(codes)
        chunk_rids.append(rid)
        bp += len(codes)
        if bp >= chunk_bp:
            flush()
    flush()

    n_colors = max_rid + 1
    if not store.files:
        # fully in-memory path (no spill happened)
        combo = store.mem
        uid_of = (combo >> 32).astype(np.int64)
        csr_rids = (combo & np.int64(0xFFFFFFFF)).astype(np.int32)
        csr_offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(uid_of, minlength=n), out=csr_offsets[1:])
        # edge support comes from the FULL color sets: the reference computes
        # the sharedPids edge bits (phase 4) BEFORE subsampling (phase 5) on
        # un-truncated SharedPairIDs (Graph.cpp:2003,2015)
        edge_support = _edge_support_exact(cdbg, csr_offsets, csr_rids,
                                           min_cov_edge)
        if auto_subsample and combo.size:
            cov_per_kmer = cov / np.maximum(cdbg.nkmers, 1)
            combo, remap, n_new = subsample_colors(
                combo, first_uid_of_read, cov_per_kmer, target_cov=target_cov)
            if remap is not None:
                n_colors = n_new
                # ids were remapped: the original-id CSR no longer matches
                csr_offsets = csr_rids = None
        rows, card = _rows_from_pairs(combo, n, cap)
        return GraphColors(cap=cap, rows=rows, card=card, coverage=cov,
                           edge_support=edge_support, n_colors=n_colors,
                           csr_offsets=csr_offsets, csr_rids=csr_rids)

    # ---- spilled path: one streaming pass over the global merge, with the
    # full pair CSR materialized to ONE disk file (memmap-backed) ----
    rows, card, n_colors2, csr_offsets, csr_rids = _rows_from_pair_blocks(
        store, n, cap, max_rid=max_rid, cov=cov, nkmers=cdbg.nkmers,
        first_uid_of_read=first_uid_of_read,
        auto_subsample=auto_subsample, target_cov=target_cov,
        spill_dir=spill_dir)
    store.cleanup()
    edge_support = _edge_support_exact(cdbg, csr_offsets, csr_rids,
                                       min_cov_edge)
    subsampled = n_colors2 is not None
    if subsampled:
        n_colors = n_colors2
    return GraphColors(cap=cap, rows=rows, card=card, coverage=cov,
                       edge_support=edge_support, n_colors=n_colors,
                       csr_offsets=None if subsampled else csr_offsets,
                       csr_rids=None if subsampled else csr_rids)


def _rows_from_pair_blocks(store: "PairStore", n: int, cap: int, *,
                           max_rid: int, cov: np.ndarray, nkmers: np.ndarray,
                           first_uid_of_read: dict, auto_subsample: bool,
                           target_cov: float, keep_min: int = 2,
                           min_est_cov: float = 10.0,
                           spill_dir: Optional[str] = None):
    """Streaming equivalent of `_rows_from_pairs` (+ optional coverage-
    stratified subsampling) over a PairStore's global merge, also
    materializing the full pair CSR to one disk-backed file.

    Returns (rows_colors, card_colors, n_colors_or_None, csr_offsets,
    csr_rids): the stored (possibly subsampled, id-compacted) rows plus the
    memmap-backed pre-subsample CSR used for exact edge support / SNP
    validation. Sampling is block-local; merged_blocks snaps cuts to uid
    boundaries, so only unitig groups larger than one merge block deviate
    from the in-memory sample.
    """
    import tempfile

    from . import kmers as K

    rows_full = np.full((n, cap), CS.PAD, dtype=np.int32)
    card_full = np.zeros(n, dtype=np.int32)
    csr_file = tempfile.NamedTemporaryFile(dir=spill_dir, suffix=".csr.bin",
                                           delete=False)

    do_sub = False
    cov_per_kmer = cov / np.maximum(nkmers, 1)
    if auto_subsample:
        pos = cov_per_kmer[cov_per_kmer > 0]
        est = float(np.median(pos)) if pos.size else 0.0
        do_sub = est >= min_est_cov
    if do_sub:
        all_rids = np.arange(max_rid + 1, dtype=np.int64)
        r_uid = np.full(max_rid + 1, -1, dtype=np.int64)
        for r, u in first_uid_of_read.items():
            if 0 <= r <= max_rid:
                r_uid[r] = u
        r_cov = np.where(r_uid >= 0, cov_per_kmer[np.maximum(r_uid, 0)], est)
        rate = np.minimum(target_cov / np.maximum(r_cov, 1e-9), 1.0)
        h_rid = K.splitmix64(all_rids.astype(np.uint64), np)
        keep_arr = h_rid < (rate * float(2**64 - 1)).astype(np.uint64)
        survivors = np.zeros(max_rid + 1, dtype=bool)
        rows_sub = np.full((n, cap), CS.PAD, dtype=np.int32)
        card_sub = np.zeros(n, dtype=np.int32)

    def fill_with_carry(rows, uid_of, rid_of, prev_last):
        """Block fill; a uid group straddling the previous block re-merges
        its top-cap-by-hash sample (k-smallest-hash selection is mergeable)."""
        u0 = int(uid_of[0])
        saved = rows[u0].copy() if u0 == prev_last else None
        if saved is not None:
            rows[u0] = CS.PAD   # else stale tail slots mix into the merge
        _sample_rows(uid_of, rid_of, n, cap, rows=rows)
        if saved is not None:
            cur = rows[u0]
            ids = np.concatenate([saved[saved != CS.PAD],
                                  cur[cur != CS.PAD]]).astype(np.int32)
            h = K.splitmix64(ids.astype(np.uint64), np)
            ids = ids[np.argsort(h, kind="stable")][:cap]
            ids.sort()
            rows[u0] = CS.PAD
            rows[u0, :len(ids)] = ids
        return int(uid_of[-1])

    if do_sub:
        # mergeable per-uid top-keep_min-by-hash restore candidates + global
        # kept counts (restores must be decided on GLOBAL counts — blocks can
        # split a unitig's group)
        top_h = np.full((n, keep_min), np.uint64(0xFFFFFFFFFFFFFFFF),
                        dtype=np.uint64)
        top_id = np.full((n, keep_min), -1, dtype=np.int64)
        kept_count = np.zeros(n, dtype=np.int64)

    present = np.zeros(max_rid + 1, dtype=bool) if do_sub else None
    prev_f = -1
    for blk in store.merged_blocks():
        uid_of = (blk >> 32).astype(np.int64)
        rid_of = (blk & np.int64(0xFFFFFFFF)).astype(np.int32)
        csr_file.write(rid_of.tobytes())
        card_full += np.bincount(uid_of, minlength=n).astype(np.int32)
        prev_f = fill_with_carry(rows_full, uid_of, rid_of, prev_f)
        if not do_sub:
            continue
        present[rid_of] = True
        kept_count += np.bincount(uid_of[keep_arr[rid_of]], minlength=n
                                  ).astype(np.int64)
        # merge this block's keep_min smallest-hash candidates per uid
        hp = K.splitmix64(rid_of.astype(np.uint64), np)
        order = np.lexsort((hp, uid_of))
        u_o, h_o, r_o = uid_of[order], hp[order], rid_of[order]
        first = _seg_rank(u_o) < keep_min
        u_c, h_c, r_c = u_o[first], h_o[first], r_o[first]
        uu = np.unique(u_c)
        su = np.concatenate([np.repeat(uu, keep_min), u_c])
        sh = np.concatenate([top_h[uu].ravel(), h_c])
        sid = np.concatenate([top_id[uu].ravel(), r_c.astype(np.int64)])
        o2 = np.lexsort((sh, su))
        su, sh, sid = su[o2], sh[o2], sid[o2]
        rk = _seg_rank(su)
        sel = rk < keep_min
        top_h[su[sel], rk[sel]] = sh[sel]
        top_id[su[sel], rk[sel]] = sid[sel]

    csr_file.close()
    csr_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(card_full, out=csr_offsets[1:])
    csr_rids = np.memmap(csr_file.name, dtype=np.int32, mode="r",
                         shape=(int(csr_offsets[-1]),))
    if not do_sub:
        return rows_full, card_full, None, csr_offsets, csr_rids

    # restores: uids whose GLOBAL kept count fell below keep_min get their
    # top candidates force-kept (Graph.cpp:2353-2367)
    need = np.flatnonzero((kept_count < keep_min) & (card_full > 0))
    restore_keep = np.zeros(max_rid + 1, dtype=bool)
    restore_by_uid: dict = {}
    for u in need:
        ids = top_id[u][top_id[u] >= 0]
        restore_by_uid[int(u)] = set(int(x) for x in ids)
        restore_keep[ids] = True

    # survivors + dense remap are fully determined before pass 2, so rows
    # are sampled by the hash of the REMAPPED id — identical to the
    # in-memory path (subsample first, sample rows after)
    survivors = present & (keep_arr | restore_keep)
    remap = np.cumsum(survivors) - 1     # dense ids, monotone in old id

    # pass 2 over the SAME merge: apply the final keep predicate
    prev_s = -1
    for blk in store.merged_blocks():
        uid_of = (blk >> 32).astype(np.int64)
        rid_of = (blk & np.int64(0xFFFFFFFF)).astype(np.int32)
        keep = keep_arr[rid_of]
        extra = restore_keep[rid_of] & ~keep
        if extra.any():
            for i in np.flatnonzero(extra):
                s = restore_by_uid.get(int(uid_of[i]))
                keep[i] = s is not None and int(rid_of[i]) in s
        u_s = uid_of[keep]
        r_s = remap[rid_of[keep]].astype(np.int32)
        if u_s.size:
            card_sub += np.bincount(u_s, minlength=n).astype(np.int32)
            prev_s = fill_with_carry(rows_sub, u_s, r_s, prev_s)

    return (rows_sub, card_sub, int(survivors.sum()), csr_offsets, csr_rids)


def _seg_rank(uid_of: np.ndarray) -> np.ndarray:
    """Rank within each uid run of a uid-sorted array."""
    m = uid_of.size
    starts_mask = np.empty(m, dtype=bool)
    starts_mask[0] = True
    starts_mask[1:] = uid_of[1:] != uid_of[:-1]
    seg_start = np.maximum.accumulate(np.where(starts_mask, np.arange(m), 0))
    return np.arange(m) - seg_start


def _sample_rows(uid_of: np.ndarray, rid_of: np.ndarray, n: int, cap: int,
                 rows: Optional[np.ndarray] = None) -> np.ndarray:
    """Fill capped rows with a FAIR deterministic per-unitig sample.

    Unitigs with more than `cap` colors keep the cap ids with the smallest
    splitmix64 hash (not the lowest ids: file-ordered mate ids would bias the
    sample toward one haplotype), stored sorted by id.
    """
    if rows is None:
        rows = np.full((n, cap), CS.PAD, dtype=np.int32)
    if uid_of.size == 0:
        return rows
    h = K.splitmix64(rid_of.astype(np.uint64), np)
    order = np.lexsort((h, uid_of))
    u_o, r_o = uid_of[order], rid_of[order]
    keep = _seg_rank(u_o) < cap
    u_k, r_k = u_o[keep], r_o[keep]
    order2 = np.lexsort((r_k, u_k))            # back to id-sorted rows
    u_k, r_k = u_k[order2], r_k[order2]
    rows[u_k, _seg_rank(u_k)] = r_k
    return rows


def _rows_from_pairs(combo: np.ndarray, n: int, cap: int):
    """Sorted-unique (uid<<32|rid) pairs -> padded sampled rows + cardinality."""
    uid_of = (combo >> 32).astype(np.int64)
    rid_of = (combo & np.int64(0xFFFFFFFF)).astype(np.int32)
    card = np.bincount(uid_of, minlength=n).astype(np.int32)
    rows = _sample_rows(uid_of, rid_of, n, cap)
    return rows, card


def _edge_support_exact(cdbg: Cdbg, offsets: np.ndarray, rids: np.ndarray,
                        min_cov: int, chunk: int = 1 << 13) -> np.ndarray:
    """Edge support from FULL color sets: |colors(u) ∩ colors(v)| >= min_cov
    per edge (Graph.cpp:2003,2015 computes it on the un-truncated
    SharedPairIDs). Each chunk of edge slots concatenates both endpoints'
    CSR segments tagged by slot and counts duplicate (slot, rid) records —
    exact, vectorized, and memmap-friendly (rids may be disk-backed)."""
    n = cdbg.n_unitigs
    support = np.zeros((n, 2, 4), dtype=bool)
    flat = cdbg.edges.reshape(-1)
    slots = np.flatnonzero(flat >= 0)
    if slots.size == 0 or offsets[-1] == 0:
        return support
    us = (slots // 8).astype(np.int64)
    vs = (flat[slots] >> 1).astype(np.int64)
    lens = (offsets[1:] - offsets[:-1])

    def gather(uids, tags):
        ln = lens[uids]
        tot = int(ln.sum())
        if tot == 0:
            return (np.zeros(0, np.int64),) * 2
        starts = offsets[uids]
        idx = np.repeat(starts, ln) + (np.arange(tot)
                                       - np.repeat(np.cumsum(ln) - ln, ln))
        return np.repeat(tags, ln), np.asarray(rids[idx], dtype=np.int64)

    for s in range(0, slots.size, chunk):
        sl = slice(s, min(s + chunk, slots.size))
        tags = np.arange(sl.stop - sl.start, dtype=np.int64)
        t1, r1 = gather(us[sl], tags)
        t2, r2 = gather(vs[sl], tags)
        rec = np.concatenate([(t1 << 32) | r1, (t2 << 32) | r2])
        rec.sort()
        dup = rec[1:] == rec[:-1]
        cnt = np.bincount((rec[1:][dup] >> 32).astype(np.int64),
                          minlength=sl.stop - sl.start)
        support.reshape(-1)[slots[sl]] = cnt >= min_cov
    return support


