"""SNP-candidate detection: annotate unitig positions with IUPAC ambiguity.

Full re-expression of the reference's detectSNPs (Graph.cpp:484-720): every
unitig k-mer is probed for 1-substitution matches on OTHER unitigs (the
searchSequence(sub-only) call, Graph.cpp:505,593), and each candidate pair is
validated by color-compatible neighborhoods in both directions
(isValidSNPcandidate, GraphTraversal.cpp:1057-1147) before the site is stored
as a (pos, IUPAC mask) annotation (UnitigData.hpp:448-451).

TPU-native shape: instead of a per-unitig searchSequence loop, ALL unitig
sequences are concatenated and probed in ONE batched 1-edit pass (the same
native/vectorized variant machinery as the weak-seed probe,
correct/seeds.py), and validation caches one read-supported, color-consistent
BFS neighborhood per (unitig, direction) with batched set intersections over
the padded color rows. Sites on the partner unitig annotate themselves when
the probe reaches that unitig as a source (the relation is symmetric).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ratatosk_tpu_torch import dna
from ratatosk_tpu_torch.graph.build import Cdbg
from ratatosk_tpu_torch.graph.colors import GraphColors
from ratatosk_tpu_torch.ops import colorset as CS


@dataclasses.dataclass
class SnpAnnotations:
    """CSR of per-unitig ambiguous sites: position + 4-bit IUPAC mask."""

    offsets: np.ndarray   # int64 [N+1]
    pos: np.ndarray       # int32 [M] position on the (forward) unitig
    mask: np.ndarray      # uint8 [M] IUPAC mask (union of both alleles)

    def sites_for(self, uid: int):
        a, b = self.offsets[uid], self.offsets[uid + 1]
        return self.pos[a:b], self.mask[a:b]

    @property
    def n_sites(self) -> int:
        return int(self.pos.shape[0])


def _probe_sub_hits(cdbg: Cdbg):
    """1-substitution hits of every unitig k-mer against the index.

    Returns (src_uid, src_pos, row) int64 arrays: window start src_pos on the
    forward frame of src_uid matched index row `row` after one substitution.
    """
    from ratatosk_tpu_torch.correct.seeds import _canonical_variants, _probe_prefilter
    from ratatosk_tpu_torch.graph.keys import KeyArray
    from ratatosk_tpu_torch.ops import native_kmers as NK

    k = cdbg.k
    n = cdbg.n_unitigs
    parts, starts = [], []
    off = 0
    sep = np.array([4], np.uint8)
    for u in range(n):
        seq = cdbg.unitig_codes(u)
        starts.append(off)
        parts.append(seq)
        parts.append(sep)
        off += len(seq) + 1
    concat = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    starts_arr = np.asarray(starts, np.int64)

    prefilter = _probe_prefilter(cdbg.index)
    if NK.available():
        tbl, bits = prefilter
        gpos, rows, fwh, kind = NK.seed_probe(
            concat, k, starts_arr,
            np.asarray(cdbg.index.keys_lo),
            np.asarray(cdbg.index.keys_hi) if cdbg.index.two_word else None,
            tbl.view(np.uint8), bits, stride=1, near_exact_skip=0,
            subs=True, indels=False, index=cdbg.index)
        sel = kind == 1          # substitution hits only
        gpos, rows, fwh = gpos[sel], rows[sel], fwh[sel]
    else:
        ch, cl, fw, wp = _canonical_variants(concat, k, "sub", starts_arr,
                                             prefilter=prefilter)
        if wp.size == 0:
            return (np.zeros(0, np.int64),) * 3 + (np.zeros(0, bool),)
        index_keys = KeyArray(k, np.asarray(cdbg.index.keys_lo),
                              np.asarray(cdbg.index.keys_hi)
                              if cdbg.index.two_word else None)
        r = index_keys.find(KeyArray(k, cl, ch if k > 32 else None))
        hit = r >= 0
        gpos, rows, fwh = wp[hit], r[hit], fw[hit]
    if gpos.size == 0:
        return (np.zeros(0, np.int64),) * 3 + (np.zeros(0, bool),)
    src = np.searchsorted(starts_arr, gpos, side="right") - 1
    return src, gpos - starts_arr[src], rows, np.asarray(fwh, bool)


def _full_intersect(colors: GraphColors, u: int, v: int) -> int:
    """|colors(u) ∩ colors(v)| on the FULL sets (getNumberSharedPairID):
    capped rows cannot certify a small set against a large one."""
    a = colors.full_row(u)
    b = colors.full_row(v)
    if len(a) > len(b):
        a, b = b, a
    if len(b) == 0 or len(a) == 0:
        return 0
    pos = np.searchsorted(b, a)
    pos = np.minimum(pos, len(b) - 1)
    return int((b[pos] == a).sum())


def _neighborhood(cdbg: Cdbg, colors: GraphColors, a: int, strand: int,
                  min_cov: int, max_frontier: int, max_hops: int):
    """Read-supported, color-consistent local neighborhood of (a, strand)
    (exploreLocalGraph, GraphTraversal.cpp:1062-1104): BFS over supported
    edges keeping unitigs that share >= min_cov reads with a."""
    out = [a]
    seen = {(a << 1) | strand}
    frontier = [(a, strand)]
    for _ in range(max_hops):
        nxt = []
        for v, d in frontier:
            for c in range(4):
                e = int(cdbg.edges[v, d, c])
                if e < 0 or e in seen or not colors.edge_support[v, d, c]:
                    continue
                seen.add(e)
                w = e >> 1
                if _full_intersect(colors, w, a) >= min_cov:
                    out.append(w)
                    nxt.append((w, e & 1))
            if len(out) >= max_frontier:
                return out
        frontier = nxt
    return out


def detect_snps(cdbg: Cdbg, colors: Optional[GraphColors] = None,
                min_cov: int = 2, max_frontier: int = 64,
                max_hops: int = 4) -> SnpAnnotations:
    n = cdbg.n_unitigs
    sites: dict = {}   # (uid, pos) -> mask

    src, spos, rows, fwh = _probe_sub_hits(cdbg)
    if src.size:
        k = cdbg.k
        iuid = np.asarray(cdbg.index.unitig_id)
        ipos = np.asarray(cdbg.index.pos)
        istr = np.asarray(cdbg.index.strand)
        b_uid = iuid[rows].astype(np.int64)
        direction = np.where(fwh == istr[rows], 0, 1)
        nk = cdbg.nkmers[b_uid]
        b_o = np.where(direction == 0, ipos[rows], nk - 1 - ipos[rows])
        keep = b_uid != src
        if colors is not None:
            keep &= (colors.card[src] >= min_cov) & \
                    (colors.card[b_uid] >= min_cov)
        src, spos, b_uid, direction, b_o = (x[keep] for x in
                                            (src, spos, b_uid, direction, b_o))
        # window bases of a (forward frame) vs b's oriented k-mer; exactly one
        # mismatch = the substituted position
        uoff = cdbg.uoff
        j = np.arange(k, dtype=np.int64)[None, :]
        a_idx = uoff[src][:, None] + spos[:, None] + j
        a_win = cdbg.useq[a_idx]
        fw_idx = uoff[b_uid][:, None] + b_o[:, None] + j
        rc_idx = uoff[b_uid + 1][:, None] - 1 - (b_o[:, None] + j)
        b_idx = np.where(direction[:, None] == 0, fw_idx, rc_idx)
        b_win = cdbg.useq[b_idx]
        b_win = np.where(direction[:, None] == 0, b_win, 3 - b_win)
        ndiff = (a_win != b_win).sum(axis=1)
        one = ndiff == 1
        src, spos, b_uid = src[one], spos[one], b_uid[one]
        off = np.argmax(a_win[one] != b_win[one], axis=1)
        a_base = a_win[one][np.arange(one.sum()), off]
        b_base = b_win[one][np.arange(one.sum()), off]
        site_pos = (spos + off).astype(np.int64)
        m = (dna._CODE_TO_MASK[a_base] | dna._CODE_TO_MASK[b_base]).astype(np.uint8)

        # dedupe candidate (a, pos, b, mask); validate once per (a, b) pair
        order = np.lexsort((site_pos, b_uid, src))
        src, site_pos, b_uid, m = (x[order] for x in
                                   (src, site_pos, b_uid, m))
        nb_cache: dict = {}

        def neigh(a, strand):
            key = (a, strand)
            got = nb_cache.get(key)
            if got is None:
                got = _neighborhood(cdbg, colors, a, strand, min_cov,
                                    max_frontier, max_hops) \
                    if colors is not None else [a]
                nb_cache[key] = got
            return got

        pair_valid: dict = {}
        for i in range(len(src)):
            a, b = int(src[i]), int(b_uid[i])
            ok = pair_valid.get((a, b))
            if ok is None:
                if colors is None:
                    ok = True
                else:
                    # a true het pair lies at the SAME locus on OPPOSITE
                    # haplotypes: no read can carry both alleles, so the two
                    # unitigs' read sets are disjoint. Same-haplotype
                    # near-repeats (adjacent unitigs sharing spanning reads)
                    # are not SNPs — the role of the reference's
                    # hasSharedPids gating (Graph.cpp:502)
                    ok = _full_intersect(colors, a, b) < min_cov
                    for strand in (0, 1) if ok else ():
                        xs = neigh(a, strand)
                        if not any(_full_intersect(colors, x, b) >= min_cov
                                   for x in xs):
                            ok = False
                            break
                pair_valid[(a, b)] = ok
            if ok:
                key = (int(src[i]), int(site_pos[i]))
                sites[key] = sites.get(key, 0) | int(m[i])

    offsets = np.zeros(n + 1, dtype=np.int64)
    ordered = sorted(sites.items())
    for (u, _), _m in ordered:
        offsets[u + 1] += 1
    np.cumsum(offsets, out=offsets)
    pos = np.fromiter((p for (_, p), _m in ordered), dtype=np.int32,
                      count=len(ordered))
    mask = np.fromiter((_m for (_, _p), _m in ordered), dtype=np.uint8,
                       count=len(ordered))
    return SnpAnnotations(offsets=offsets, pos=pos, mask=mask)
