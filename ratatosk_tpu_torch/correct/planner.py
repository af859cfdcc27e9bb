"""Host planner: a read batch's seeds, waypoints and region specs, the
planning half of the reference's `correctSequence` (Correction.cpp:159-958,
SURVEY.md §3.3); correct/engine.py launches, finishes and assembles them.
What one `plan_batch` call gathers lives in a `_Call` it hands down, so
several threads may plan on one Planner at once: a plan writes no field of
it but the short-cycle memo, whose values do not depend on the call.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from ratatosk_tpu_torch import dna
from ratatosk_tpu_torch import trace as TR
from ratatosk_tpu_torch.correct.choose import branching_mask, choose_region_colors
from ratatosk_tpu_torch.correct.runs_batch import find_runs_batch
from ratatosk_tpu_torch.correct.seeds import (SolidRun, filter_runs_by_color,
                                        find_runs, find_weak_seeds_batch,
                                        select_waypoints)
from ratatosk_tpu_torch.ops import cigar as CG
from ratatosk_tpu_torch.ops import colorset as CS
from ratatosk_tpu_torch.ops import native_kmers as NK

# windows within this distance of an exact hit skip the 1-edit probe (the
# reference's near-exact re-search mask, Graph.cpp:100-196); shared between
# the production probe call and warmup so they compile the same variant
_NEAR_EXACT_SKIP = 16


def _qual_for(opt, score: float) -> int:
    """The quality char of a correction scored `score`; out_qual is the
    reference's quality floor (getQual qv_min, Common.hpp:410-418)."""
    return dna.get_qual_char(max(score, 0.0), qv_min=opt.out_qual,
                             qv_max=opt.max_qual)


def _oriented_sites(snps, cdbg, run):
    """The annotated SNP sites of `run`'s unitig: (position, 4-bit allele
    mask) pairs, both in the run's orientation."""
    pos_f, masks = snps.sites_for(run.uid)
    ul = int(cdbg.uoff[run.uid + 1] - cdbg.uoff[run.uid])
    for p, m in zip(pos_f, masks):
        if run.direction == 0:
            yield int(p), int(m)
        else:
            yield ul - 1 - int(p), dna.revcomp_mask(int(m))


def _iupac_masks(seq: np.ndarray, sites) -> Optional[np.ndarray]:
    """fixAmbiguity's masks over `seq`: the mask of each site (j, raw base,
    mask) whose raw base is another allele than seq[j]; None if none."""
    iu = None
    for j, raw_b, mo in sites:
        if raw_b < 4 and raw_b != int(seq[j]) and dna._CODE_TO_MASK[raw_b] & mo:
            if iu is None:
                iu = np.zeros(len(seq), dtype=np.uint8)
            iu[j] = mo
    return iu


@dataclasses.dataclass
class RegionSpec:
    read_idx: int
    kind: str            # 'gap' | 'head' | 'tail'
    raw_a: int           # replaced raw span [raw_a, raw_b)
    raw_b: int
    tgt: np.ndarray      # raw target codes (head: already reverse-complemented)
    start_tip: int
    start_off: int
    end_tip: int         # -1 = open
    end_off: int
    colors_row: np.ndarray
    # per-id weights aligned to colors_row (WeightsPairID analog,
    # Correction.cpp:417-427); None = all ones
    colors_w: Optional[np.ndarray] = None
    # quality of the raw target bases (target orientation). Open regions use
    # it to gate acceptance: a walk may only replace bases it agrees with at
    # least as well as their certified identity.
    tgt_qual: Optional[np.ndarray] = None
    # an anchor unitig lies on a short repeat cycle: the beam gets a doubled
    # path budget (fixRepeats, GraphTraversal.cpp:1149-1334)
    on_cycle: bool = False
    # the RIGHT anchor specifically is cyclic: completion must not freeze
    # the path (beam.py scoreboard; the fixRepeats splicing role)
    end_on_cycle: bool = False
    mirror_end_on_cycle: bool = False
    # anchors for the backward mirror (gap regions)
    mirror: Optional[tuple] = None
    # right-anchor GRAPH k-mer bases + its raw-window length (differs from k
    # for weak 1-edit anchors whose read window spans k-1 or k+1 bases)
    end_anchor: Optional[np.ndarray] = None
    end_win: int = 0
    # mirrored target = revcomp(raw[raw_a-k : raw_b-k]): the backward path
    # emits from after the reversed right anchor through the left anchor k-mer
    mirror_tgt: Optional[np.ndarray] = None
    # filled by the runner:
    ok: bool = False
    seq: Optional[np.ndarray] = None      # corrected codes (read orientation)
    qual: Optional[np.ndarray] = None     # per-base quality chars
    iupac: Optional[np.ndarray] = None    # ambiguity masks over seq (fixAmbiguity)
    covered: int = 0                      # target prefix covered (open regions)
    # partial paths when neither direction completes (consensus merge,
    # Alignment.cpp:309-470): (trimmed codes in path orientation, target
    # columns covered, align score)
    partial_fw: Optional[tuple] = None
    partial_bw: Optional[tuple] = None


@dataclasses.dataclass
class _Call:
    """What one plan_batch call gathers: the bases the pass-2 max-quality
    skip left raw (maxq_bp) and the splices _resolve_splices completes."""
    maxq_bp: int = 0
    splices: list = dataclasses.field(default_factory=list)


class Planner:
    def __init__(self, cdbg, colors, opt, hap=None, snps=None, *,
                 devplan=None, sharded=None):
        """hap, snps, devplan, sharded: the Corrector's, or None (devplan
        and sharded None: the host index)."""
        self.cdbg = cdbg
        self.colors = colors
        self.opt = opt
        self.hap = hap
        self.snps = snps
        self.devplan = devplan
        self.sharded = sharded
        self.nk = cdbg.nkmers
        self.branching = branching_mask(colors.edge_support)
        # repeat-coverage exclusion threshold (getMaxKmerCoverage,
        # Graph.cpp:825-841; Ratatosk.cpp:625): unitigs in the top
        # top_km_cov_ratio coverage quantile contribute no colors
        km_cov = colors.coverage / np.maximum(cdbg.nkmers, 1)
        self.max_km_cov = float(opt.max_km_cov)
        if len(km_cov):
            q = np.sort(km_cov)[::-1][int(len(km_cov) * opt.top_km_cov_ratio)]
            self.max_km_cov = max(float(q), self.max_km_cov)
        self.km_cov = km_cov
        self._cycle_cache: dict = {}

    def _oriented_slice(self, uid: int, direction: int, a: int, b: int) -> np.ndarray:
        """Oriented bases [a, b) of a unitig."""
        o0, o1 = int(self.cdbg.uoff[uid]), int(self.cdbg.uoff[uid + 1])
        if direction == 0:
            return self.cdbg.useq[o0 + a:o0 + b].astype(np.uint8)
        seg = self.cdbg.useq[o1 - b:o1 - a]
        return (3 - seg)[::-1].astype(np.uint8)

    def _region_colors(self, u1: int, u2: int, hap: int) -> np.ndarray:
        r1 = self.colors.rows[u1]
        if u2 >= 0:
            r1 = CS.union_rows(r1[None], self.colors.rows[u2][None], np,
                               self.colors.cap)[0]
        if self.hap is not None and hap >= 0:
            # phased read: correct with same-haplotype + unphased short reads
            # (chooseColors' haplotype intersection, Correction.cpp:256)
            from ratatosk_tpu_torch.graph import phasing as PH
            r1 = PH.filter_colors_by_hap(r1, self.hap, hap)
        return r1

    def _chosen_colors(self, runs, li, ri, raw_a, raw_b, hap: int):
        """chooseColors analog: flank-aware priority-class color row + weights
        (correct/choose.py), intersected with the read's haplotype partners
        when phased (Correction.cpp:256)."""
        row, wts = choose_region_colors(
            runs, li, ri, raw_a, raw_b, self.colors, self.branching,
            self.opt.insert_sz, km_cov=self.km_cov,
            max_km_cov=self.max_km_cov)
        if self.hap is not None and hap >= 0:
            from ratatosk_tpu_torch.graph import phasing as PH
            new_row = PH.filter_colors_by_hap(row, self.hap, hap)
            idx = np.searchsorted(row, new_row)
            idx = np.minimum(idx, len(row) - 1)
            wts = np.where(new_row == CS.PAD, 0, wts[idx]).astype(np.int8)
            row = new_row
        return row, wts

    def _plan_read(self, st: _Call, ridx: int, codes: np.ndarray,
                   regions: List[RegionSpec], runs: List[SolidRun],
                   wps: List[SolidRun], hap: int,
                   qual: Optional[np.ndarray]):
        """Returns list of segments: ('raw'|'solid', a, b) or ('region', idx)
        or ('splice', codes, qual). hap: the read's haplotype, -1 unphased."""
        k = self.cdbg.k
        L = len(codes)
        if not runs:
            return [("raw", 0, L)]
        if wps:
            runs = sorted(runs + wps, key=lambda r: r.s)
        # open (head/tail) regions share the weak-region length cap
        # (max_len_weak_region, Common.hpp:131-132); the anchor-adjacent part
        # is corrected and the far remainder stays raw
        cap_open = self.opt.max_len_weak_region1
        segs: list = []
        r0 = runs[0]
        if r0.s > 0 and self._span_max_quality(qual, 0, r0.s):
            st.maxq_bp += r0.s
            segs.append(("raw", 0, r0.s))
        elif r0.s > 0:
            # head: correct the reversed prefix from the reversed first anchor
            nk0 = int(self.nk[r0.uid])
            d_h = r0.direction ^ 1
            o_h = nk0 - 1 - r0.o_s
            h_a = max(r0.s - cap_open, 0)
            if h_a > 0:
                segs.append(("raw", 0, h_a))
            c_row, c_w = self._chosen_colors(runs, None, 0, h_a, r0.s, hap)
            regions.append(RegionSpec(
                read_idx=ridx, kind="head", raw_a=h_a, raw_b=r0.s,
                tgt=dna.revcomp_codes(codes[h_a:r0.s]),
                start_tip=(r0.uid << 1) | d_h, start_off=o_h + k,
                end_tip=-1, end_off=0,
                colors_row=c_row, colors_w=c_w,
                tgt_qual=None if qual is None else qual[h_a:r0.s][::-1].copy()))
            segs.append(("region", len(regions) - 1))
        for i, run in enumerate(runs):
            if i == 0 and run.weak:
                # a weak first anchor's read k-mer carries the error: emit the
                # GRAPH copy of the k-mer instead of the raw bases
                gk = self._oriented_slice(run.uid, run.direction,
                                          run.o_s, run.o_e + k)
                q = np.full(len(gk), _qual_for(self.opt, 0.5), np.uint8)
                segs.append(("splice", gk, q, None))
            else:
                a = run.s if i == 0 else run.s + k
                segs.append(("solid", a, run.e + k))
            rspan = run.rspan or k
            if i + 1 >= len(runs):
                continue
            nxt = runs[i + 1]
            raw_a, raw_b = run.e + rspan, nxt.s + (nxt.rspan or k)
            seg = self._plan_gap(st, ridx, codes, run, nxt, raw_a, raw_b,
                                 regions, runs, i, hap, qual)
            segs.append(seg)
        last = runs[-1]
        ta = last.e + (last.rspan or k)
        if ta < L and self._span_max_quality(qual, ta, L):
            st.maxq_bp += L - ta
            segs.append(("raw", ta, L))
        elif ta < L:
            t_b = min(ta + cap_open, L)
            c_row, c_w = self._chosen_colors(runs, len(runs) - 1, None, ta,
                                             t_b, hap)
            regions.append(RegionSpec(
                read_idx=ridx, kind="tail", raw_a=ta, raw_b=t_b,
                tgt=codes[ta:t_b].astype(np.uint8),
                start_tip=(last.uid << 1) | last.direction,
                start_off=last.o_e + k,
                end_tip=-1, end_off=0,
                colors_row=c_row, colors_w=c_w,
                tgt_qual=None if qual is None else qual[ta:t_b].copy()))
            segs.append(("region", len(regions) - 1))
            if t_b < L:
                segs.append(("raw", t_b, L))
        return segs

    def _plan_seeds(self, reads: List[np.ndarray],
                    quals: Optional[Sequence[Optional[np.ndarray]]],
                    haps: List[int]):
        """Solid runs + weak-seed waypoints for a whole batch.

        Waypoints re-express the reference's inexact re-search + semi-weak
        path hops (extractSemiWeakPaths, Correction.cpp:3-157; seeds from the
        masked inexact re-search, Graph.cpp:100-196): every long anchor-free
        span gets 1-edit seeds probed against the index, and a
        color-consistent, spaced subset becomes pseudo-anchors that cut the
        span into short CLOSED legs the beam can certify. All spans of all
        reads are probed in ONE batched pass (find_weak_seeds_batch) — the
        per-span probe loop was the dominant host cost.
        """
        opt = self.opt
        with TR.span("plan.runs") as span:
            probe = self._probe()
            batched = (self.devplan is None and probe is None
                       and NK.available())
            if batched:
                # the host index: the whole batch in one pass
                runs_list = find_runs_batch(self.cdbg, self.colors, reads)
            else:
                runs_raw = None
                if self.devplan is not None:
                    runs_raw = self.devplan.collect_runs(
                        self.devplan.dispatch_runs(reads))
                if runs_raw is None:
                    runs_raw = [find_runs(self.cdbg, r, probe=probe)
                                for r in reads]
                runs_list = [filter_runs_by_color(rr, self.colors)
                             for rr in runs_raw]
            if span:
                span.set("batched", int(batched))
        wps_list: List[List[SolidRun]] = [[] for _ in reads]
        if not opt.use_weak_seeds:
            return runs_list, wps_list
        k = self.cdbg.k
        with TR.span("plan.probe"):
            min_gap = opt.weak_seed_min_gap
            requests = []   # (read_idx, a, b, (uid1, uid2))
            for i, (codes, runs) in enumerate(zip(reads, runs_list)):
                if not runs:
                    continue
                q = quals[i] if quals is not None else None
                L = len(codes)
                r0, last = runs[0], runs[-1]
                spans = [(0, r0.s, (r0.uid, -1))]
                for run, nxt in zip(runs, runs[1:]):
                    spans.append((run.e + (run.rspan or k), nxt.s + k,
                                  (run.uid, nxt.uid)))
                spans.append((last.e + (last.rspan or k), L, (last.uid, -1)))
                for a, b, fl in spans:
                    if b - a < min_gap or self._span_max_quality(q, a, b):
                        continue
                    requests.append((i, a, b, fl))
            if not requests:
                return runs_list, wps_list
            spans3 = [(r[0], r[1], r[2]) for r in requests]
            seeds_per_span = None
            if self.devplan is not None:
                seeds_per_span = self.devplan.collect_probe(
                    self.devplan.dispatch_probe(
                        reads, spans3, stride=opt.weak_seed_stride,
                        near_exact_skip=_NEAR_EXACT_SKIP))
            if seeds_per_span is None:
                seeds_per_span = find_weak_seeds_batch(
                    self.cdbg, reads, spans3, stride=opt.weak_seed_stride)
        with TR.span("plan.waypoints"):
            for (i, a, b, fl), seeds in zip(requests, seeds_per_span):
                if not seeds:
                    continue
                flank = self._region_colors(fl[0], fl[1], haps[i])
                wps_list[i].extend(select_waypoints(
                    seeds, self.colors, flank, min_cov=opt.min_cov_vertices,
                    min_space=opt.weak_seed_min_space, lo=a, hi=b - k))
        return runs_list, wps_list

    def _splice_iupac(self, run, splice: np.ndarray, tgt: np.ndarray,
                      k: int) -> Optional[np.ndarray]:
        """IUPAC masks for annotated SNP sites inside a same-unitig splice.

        fixAmbiguity-style (Alignment.cpp:527-844, simplified): at a
        graph-annotated het site, if the raw read carries the *other* allele,
        emit the ambiguity code instead of silently overwriting it.
        """
        if self.snps is None or len(splice) != len(tgt):
            return None
        lo = run.o_e + k            # oriented coords of the splice start
        return _iupac_masks(splice, [
            (po - lo, int(tgt[po - lo]), mo)
            for po, mo in _oriented_sites(self.snps, self.cdbg, run)
            if 0 <= po - lo < len(splice)])

    def _probe(self):
        """Anchor-lookup probe for find_runs: sharded device lookup when the
        sharded-index mode is active, else None (replicated host array)."""
        if self.sharded is None:
            return None
        sh = self.sharded

        def probe(can, valid):
            hi = np.asarray(can.hi) if sh.two_word else None
            uid, pos, strand = (t.cpu().numpy() for t in
                                sh.lookup(np.asarray(can.lo), hi))
            uid = uid.copy()
            uid[~valid] = -1
            return uid, pos, strand.astype(bool)

        return probe

    def _on_cycle(self, uid: int) -> bool:
        """Lazy, cached short-cycle test for an anchor unitig
        (detectShortCycles, Graph.cpp:4659-4855)."""
        hit = self._cycle_cache.get(uid)
        if hit is None:
            from ratatosk_tpu_torch.graph.cycles import unitig_on_cycle
            hit = unitig_on_cycle(self.cdbg, uid, self.colors,
                                  min_cov=self.opt.min_cov_vertices)
            self._cycle_cache[uid] = hit
        return hit

    def _span_max_quality(self, qual: Optional[np.ndarray], a: int,
                          b: int) -> bool:
        """True when pass 2 skips raw span [a,b) of a read of qualities
        `qual`, already corrected at max confidence
        (Correction.cpp:779,808,941)."""
        if qual is None or not self.opt.skip_max_quality_regions or b <= a:
            return False
        return bool((qual[a:b] >= 33 + self.opt.max_qual).all())

    def _plan_gap(self, st: _Call, ridx, codes, run, nxt, raw_a, raw_b,
                  regions, runs, run_i, hap, qual):
        k = self.cdbg.k
        f = self.opt.weak_region_len_factor
        raw_len = raw_b - raw_a
        if self._span_max_quality(qual, raw_a, raw_b):
            st.maxq_bp += raw_b - raw_a
            return ("raw", raw_a, raw_b)
        # same-unitig fast path (Correction.cpp:814-858). The splice-vs-raw
        # NW distance only feeds the quality char, so non-equal cases defer
        # to ONE threaded native batch call per plan_batch (the per-call
        # ctypes overhead dominated this site, r5 plan profile) — the seg is
        # a mutable list whose qual slot is filled by _resolve_splices.
        if run.uid == nxt.uid and run.direction == nxt.direction:
            glen = nxt.o_s - run.o_e
            if glen > 0 and abs(glen - raw_len) <= max(f * raw_len, 0):
                sp = self._oriented_slice(run.uid, run.direction,
                                          run.o_e + k, nxt.o_s + k)
                tgt = codes[raw_a:raw_b]
                iu = self._splice_iupac(run, sp, tgt, k)
                if len(sp) == len(tgt) and (sp == tgt).all():
                    qual = np.full(len(sp), _qual_for(self.opt, 1.0),
                                   np.uint8)
                    return ("splice", sp, qual, iu)
                seg = ["splice", sp, None, iu]
                st.splices.append((seg, tgt))
                return seg
        if raw_len > self.opt.max_len_weak_region1 or raw_len <= 0:
            return ("raw", raw_a, raw_b)
        nk2 = int(self.nk[nxt.uid])
        nk1 = int(self.nk[run.uid])
        mirror = (
            (nxt.uid << 1) | (nxt.direction ^ 1), (nk2 - 1 - nxt.o_s) + k,
            (run.uid << 1) | (run.direction ^ 1), (nk1 - 1 - run.o_e) + k,
        )
        # mirrored target = revcomp of the raw span the backward path replaces:
        # from the left anchor's first read base through the base before the
        # right anchor's read window (anchor windows span rspan raw bases each)
        m_a = raw_a - (run.rspan or k)
        m_b = raw_b - (nxt.rspan or k)
        c_row, c_w = self._chosen_colors(runs, run_i, run_i + 1, raw_a, raw_b,
                                         hap)
        regions.append(RegionSpec(
            read_idx=ridx, kind="gap", raw_a=raw_a, raw_b=raw_b,
            tgt=codes[raw_a:raw_b].astype(np.uint8),
            start_tip=(run.uid << 1) | run.direction, start_off=run.o_e + k,
            end_tip=(nxt.uid << 1) | nxt.direction, end_off=nxt.o_s + k,
            colors_row=c_row, colors_w=c_w,
            tgt_qual=None if qual is None else qual[raw_a:raw_b].copy(),
            on_cycle=self._on_cycle(run.uid) or self._on_cycle(nxt.uid),
            end_on_cycle=self._on_cycle(nxt.uid),
            mirror_end_on_cycle=self._on_cycle(run.uid),
            mirror=mirror,
            mirror_tgt=dna.revcomp_codes(codes[m_a:m_b]),
            end_anchor=self._oriented_slice(nxt.uid, nxt.direction,
                                            nxt.o_s, nxt.o_s + k),
            end_win=(nxt.rspan or k)))
        return ("region", len(regions) - 1)

    def plan_batch(self, reads: Sequence[np.ndarray],
                   quals: Optional[Sequence[np.ndarray]],
                   names: Optional[Sequence[str]], timers: dict):
        """Host-side planning of a batch: seeds, waypoints, region specs;
        its seconds add to timers["plan"].

        Split from execution so a caller can overlap planning of the next
        batch with device execution of the current one (the reference's
        worker-pool structure, Ratatosk.cpp:618-909)."""
        regions: List[RegionSpec] = []
        plans = []
        st = _Call()
        with TR.span("plan", timers) as span:
            reads_np = [np.asarray(r, dtype=np.uint8) for r in reads]
            haps = [(self.hap.hap_of(names[i])
                     if self.hap is not None and names is not None else -1)
                    for i in range(len(reads))]
            runs_list, wps_list = self._plan_seeds(reads_np, quals, haps)
            with TR.span("plan.reads"):
                for i, r in enumerate(reads_np):
                    q = quals[i] if quals is not None else None
                    plans.append(self._plan_read(st, i, r, regions,
                                                 runs_list[i], wps_list[i],
                                                 haps[i], q))
            with TR.span("plan.splices"):
                self._resolve_splices(st)
            if span:
                # proc, slice: a planner process overwrites them
                span.set("maxq_bp", st.maxq_bp)
                span.set("proc", -1)
                span.set("slice", 0)
        return reads_np, plans, regions

    def _resolve_splices(self, st: _Call) -> None:
        """Fill the deferred same-unitig splice qualities: all NW distances
        of the batch in one threaded native call (_plan_gap fast path)."""
        if not st.splices:
            return
        from ratatosk_tpu_torch.ops import native_align as NA
        dists = NA.align_dist_batch(
            [(dna.codes_to_masks(seg[1]), dna.codes_to_masks(tgt))
             for seg, tgt in st.splices], CG.NW)
        for (seg, tgt), d in zip(st.splices, dists.tolist()):
            s1 = 1.0 - d / max(len(tgt), 1)
            seg[2] = np.full(len(seg[1]), _qual_for(self.opt, s1), np.uint8)
