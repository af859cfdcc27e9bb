"""Per-read correction engine: regions -> device beam -> assembly.

Host-side re-expression of the reference's `correctSequence`
(Correction.cpp:159-958, SURVEY.md §3.3). The host planner
(correct/planner.py) cuts each read at its solid anchors into solid spans,
same-unitig splices (Correction.cpp:814-858) and weak regions. Weak regions
from ALL reads of a batch are bucketed by padded target length and
corrected together on device (correct/beam.py); regions whose forward
search fails retry backward on mirrored anchors (Correction.cpp:880), and
still-failed regions merge their partial fw/bw paths or keep their raw
bases.

Per-base quality follows getScorePath's string overload
(GraphTraversal.cpp:722-772): CIGAR matches get getQual(best score), other
positions get getQual(best * (1 - second/best)) — quality encodes the margin
between the best and runner-up candidate path.

Port of ratatosk_tpu/correct/engine.py: the host planning and assembly are
the reference's code unchanged. The device parts are rewritten for torch:
`_launch_bucket` packs a launch's regions on the host (`region_arrays`),
uploads one tensor per field, enqueues the beam and the finish bundle (on a
CUDA device: the fused beam kernel's two launches and the finish kernel's
one, with no host sync between them), and `_execute_regions` reads the two
result arrays back with `.cpu()`; the
device planner (`plan_on_device`) runs in plain torch on the same device.
With a mesh of several slots (parallel/mesh.py) the graph is replicated per
device and every launch splits its rows over the slots, each slot on its own
worker thread and stream; with a mesh and a large index, anchor lookups go
through the range-sharded index (parallel/sharded_index.py) instead.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from ratatosk_tpu_torch import dna
from ratatosk_tpu_torch import trace as TR
from ratatosk_tpu_torch.config import CorrectOpt
from ratatosk_tpu_torch.correct import beam as BM
from ratatosk_tpu_torch.correct import finish as FN
from ratatosk_tpu_torch.correct.graphdev import DeviceGraph
from ratatosk_tpu_torch.correct.planner import (
    _NEAR_EXACT_SKIP, Planner, RegionSpec, _iupac_masks, _oriented_sites,
    _qual_for)
from ratatosk_tpu_torch.correct.seeds import find_runs
from ratatosk_tpu_torch.graph.build import Cdbg
from ratatosk_tpu_torch.graph.colors import GraphColors
from ratatosk_tpu_torch.ops import beam_kernel, finish_kernel, sprint
from ratatosk_tpu_torch.ops import cigar as CG
from ratatosk_tpu_torch.ops import colorset as CS
from ratatosk_tpu_torch.ops.finish_kernel import finish_bundle_kernel
from ratatosk_tpu_torch.parallel import mesh as M

# target-length buckets = jit shapes. Three are enough: <=256 runs the exact
# full-row DP; longer regions run the fixed-width band, whose per-step cost is
# independent of NT, and the while_loop's all-frozen early exit means short
# regions padded into a wide bucket add no steps (chunks are length-sorted).
# 5376 covers pass-2's max_len_weak_region2=5000 (Common.hpp:132).
BUCKETS = (256, 2048, 5376)


def _beam_finish(g, rb, qv_max, min_k, *, beam, lmax, min_cov, band, w,
                 min_score_open, impl="auto", launch_t=None):
    """Beam search + chained finish bundle: one launch's device work, ending
    in the two arrays the host reads back. On a CUDA device with
    impl="auto" that is two beam-kernel launches and one finish-kernel
    launch on the current stream, with no host sync in between (a mesh
    slot's part of a launch reads back its step count once, for launch_t:
    beam.beam_search); "steps" and "torch" run the plain finish
    (beam.IMPLS)."""
    res = BM.beam_search(g, rb, beam=beam, lmax=lmax, min_cov=min_cov,
                         band=band, impl=impl, launch_t=launch_t)
    finish = finish_bundle_kernel if impl == "auto" else FN.finish_bundle
    return finish(rb.tgt_masks, rb.tgt_len, rb.tgt_qual, qv_max, min_k, res,
                  w=w, min_score_open=min_score_open)


def bucket_band(nt: int, opt: CorrectOpt) -> int:
    """The DP band of a launch in bucket nt (0: the exact full row). The
    band must absorb the path-vs-read indel drift, which grows with region
    length (~2-3% of NT at ONT error rates): it scales."""
    return 0 if nt <= 256 else max(opt.band_width, nt // 16)


def bucket_lmax(nt: int, len_factor: float) -> int:
    """The longest path a launch in bucket nt holds (region_arrays)."""
    return int(np.ceil((1.0 + 2.0 * len_factor) * nt)) + 4


def check_kernel_widths(opt: CorrectOpt, impl: str) -> None:
    """Raise ValueError, naming the option, when a launch of some bucket
    would ask a kernel of route `impl` (beam.IMPLS) on a CUDA device for a
    wider band than it takes: the beam kernel's band (band_width, up to
    1,024 columns) and the finish kernel's (band_width, or the whole path
    row at NT=256, set by weak_region_len_factor) on "auto", the sprint
    kernel's (band_width, up to 1,024 columns) on "steps"; or for longer
    paths than the finish kernel's shared memory holds
    (weak_region_len_factor above ~13). Each kernel's own refuses() is the
    test."""
    band_kernel = {"auto": beam_kernel, "steps": sprint}.get(impl)
    if band_kernel is None:
        return
    for nt in BUCKETS:
        band = bucket_band(nt, opt)
        lmax = bucket_lmax(nt, opt.weak_region_len_factor)
        why = band_kernel.refuses(BM.band_width(nt, band))
        if why:
            raise ValueError(
                f"band_width={opt.band_width} gives {why} in the {nt} "
                f"bucket, which the {impl!r} route's band kernel does not "
                "take (impl='torch' takes any)")
        why = impl == "auto" and finish_kernel.refuses(
            nt, lmax, lmax + 1 if band <= 0 or band >= lmax + 1 else band)
        if why:
            raise ValueError(
                f"weak_region_len_factor={opt.weak_region_len_factor} and "
                f"band_width={opt.band_width} give {why} in the {nt} bucket, "
                "which the finish kernel does not take (impl='torch' takes "
                "any)")


def region_arrays(specs: List["RegionSpec"], nt: int, color_cap: int, *,
                  mirrored: bool = False, r_pad: Optional[int] = None,
                  len_factor: float = 0.25):
    """Pack RegionSpecs into the padded host arrays of a RegionBatch (the
    reference's make_region_batch before its upload), one per field.

    Returns (dict of [Rp]-leading arrays, lmax). Padding rows are inert
    (tgt_len=1, open).
    """
    R = len(specs)
    Rp = r_pad or R
    tgt_masks = np.zeros((Rp, nt), dtype=np.uint8)
    tgt_qual = np.zeros((Rp, nt), dtype=np.int32)
    tgt_len = np.ones(Rp, dtype=np.int32)
    start_tip = np.zeros(Rp, dtype=np.int32)
    start_off = np.zeros(Rp, dtype=np.int32)
    end_tip = np.full(Rp, -1, dtype=np.int32)
    end_off = np.zeros(Rp, dtype=np.int32)
    colors = np.full((Rp, color_cap), CS.PAD, dtype=np.int32)
    weights = np.zeros((Rp, color_cap), dtype=np.int8)
    max_plen = np.ones(Rp, dtype=np.int32)
    end_cyc = np.zeros(Rp, dtype=bool)
    for i, sp in enumerate(specs):
        if mirrored:
            tgt = sp.mirror_tgt
            stip, soff, etip, eoff = sp.mirror
            end_cyc[i] = sp.mirror_end_on_cycle
        else:
            tgt, stip, soff = sp.tgt, sp.start_tip, sp.start_off
            etip, eoff = sp.end_tip, sp.end_off
            end_cyc[i] = sp.end_on_cycle
        tgt_masks[i, :len(tgt)] = dna.codes_to_masks(tgt)
        if not mirrored and sp.tgt_qual is not None:
            tgt_qual[i, :len(sp.tgt_qual)] = np.maximum(
                sp.tgt_qual.astype(np.int32) - 33, 0)
        tgt_len[i] = len(tgt)
        start_tip[i], start_off[i] = stip, soff
        end_tip[i], end_off[i] = etip, eoff
        colors[i] = sp.colors_row
        weights[i] = (sp.colors_w if sp.colors_w is not None
                      else (sp.colors_row != CS.PAD).astype(np.int8))
        # regions anchored on a short-cycle unitig get a doubled budget:
        # tandem repeats legitimately need paths longer than the raw gap
        # (the fixRepeats cycle-splicing role, GraphTraversal.cpp:1149-1334)
        f = len_factor * (2.0 if sp.on_cycle else 1.0)
        max_plen[i] = int(np.ceil((1.0 + f) * len(tgt))) + 4
    lmax = bucket_lmax(nt, len_factor)
    return dict(
        tgt_masks=tgt_masks, tgt_len=tgt_len,
        start_tip=start_tip, start_off=start_off,
        end_tip=end_tip, end_off=end_off,
        colors_sig=CS.color_signature(colors),
        colors_wsig=CS.color_signature(colors, weights=weights),
        max_plen=max_plen, tgt_qual=tgt_qual, end_cyclic=end_cyc), lmax


def make_region_batch(specs: List["RegionSpec"], nt: int, color_cap: int, *,
                      mirrored: bool = False, r_pad: Optional[int] = None,
                      len_factor: float = 0.25, device):
    """Pack RegionSpecs into a padded RegionBatch on `device`:
    region_arrays, then one upload per field.

    Returns (RegionBatch, lmax). Padding rows are inert (tgt_len=1, open).
    """
    arrays, lmax = region_arrays(specs, nt, color_cap, mirrored=mirrored,
                                 r_pad=r_pad, len_factor=len_factor)
    return BM.RegionBatch.from_numpy(arrays, torch.device(device)), lmax


@dataclasses.dataclass
class CorrectedRead:
    codes: np.ndarray
    qual: np.ndarray     # uint8 Phred33 chars
    n_solid: int
    n_regions: int
    n_corrected: int
    # 4-bit IUPAC masks at ambiguous sites (0 = concrete base). Unresolved
    # heterozygous SNPs surface as ambiguity characters in the output, as in
    # the reference (fixAmbiguity, Alignment.cpp:527-844).
    iupac: Optional[np.ndarray] = None

    @property
    def seq(self) -> str:
        if self.iupac is None or not self.iupac.any():
            return dna.decode(self.codes)
        chars = np.frombuffer(dna.decode(self.codes).encode(), np.uint8).copy()
        amb = self.iupac != 0
        chars[amb] = dna.IUPAC_CHARS[self.iupac[amb] & 15]
        return chars.tobytes().decode()

    @property
    def qual_str(self) -> str:
        return self.qual.tobytes().decode("ascii")


class Corrector:
    def __init__(self, cdbg: Cdbg, colors: GraphColors,
                 opt: Optional[CorrectOpt] = None, hap=None, snps=None,
                 mesh=None, *, device=None, impl: str = "auto"):
        """device: where the graph lives and every launch runs (given by the
        caller; nothing falls back to another device); with a mesh it
        defaults to the mesh's first slot. mesh (parallel.mesh.Mesh): with
        several slots, every launch splits its rows over them. impl
        (correct.beam.IMPLS): "auto" runs each launch through the fused beam
        and finish kernels on a CUDA device, "steps" the per-step beam with
        the sprint kernel, "torch" the plain versions."""
        BM.check_impl(impl)
        if device is None and mesh is None:
            raise TypeError("Corrector needs device= or mesh=")
        self.cdbg = cdbg
        self.colors = colors
        self.opt = opt or CorrectOpt()
        self.snps = snps  # graph.snp.SnpAnnotations or None
        # sharded-index mode: with a mesh and an index past the threshold,
        # anchor lookups run range-partitioned over the mesh's devices
        # instead of against the host array (both key widths; pass 2's k=63
        # index is the one that outgrows a device)
        self.sharded = None
        if mesh is not None and cdbg.index.n >= self.opt.shard_index_min_keys:
            from ratatosk_tpu_torch.parallel.sharded_index import \
                ShardedKmerIndex
            self.sharded = ShardedKmerIndex(cdbg.index, mesh)
        self.device = (torch.device(device) if device is not None
                       else mesh.devices[0])
        self.impl = impl
        devs = mesh.devices if mesh is not None else (self.device,)
        if any(d.type == "cuda" for d in devs):
            # the kernels' widths: refused here, before any read is planned
            check_kernel_widths(self.opt, impl)
        self.g = DeviceGraph.from_host(cdbg, colors, self.device)
        # multi-device execution: with a mesh of several slots the graph is
        # replicated per device and every region batch splits over the
        # slots (parallel/mesh.py), the reference's per-node fan-out
        # (Ratatosk.nf:139-164)
        self.mesh = mesh if (mesh is not None and mesh.size > 1) else None
        self.replicas = None
        if self.mesh is not None:
            self.replicas = M.replicate_graph(self.g, self.mesh)
        # device batch planner (anchor lookup + 1-edit probe as async device
        # work, ops/plan_device.py); None past its index-size limit, where
        # the host planner serves the index. Exclusive with the sharded
        # mode, which serves lookups range-partitioned instead
        self.devplan = None
        if self.sharded is None and self.opt.plan_on_device:
            from ratatosk_tpu_torch.ops.plan_device import DevicePlanner
            self.devplan = DevicePlanner.build(cdbg, self.device,
                                               impl=impl)
        self.planner = Planner(cdbg, colors, self.opt, hap, snps,
                               devplan=self.devplan, sharded=self.sharded)
        self.qv_max = self.opt.max_qual
        # wall-time breakdown (seconds), for bench/verbose reporting, fed
        # by the spans of the same names (trace.py). With a mesh, "launch"
        # is the queueing of the slots' work and "finish" includes waiting
        # for it. "wait": pipeline.correct_file's double buffer waiting for
        # the next batch's plan
        self.timers = {"plan": 0.0, "launch": 0.0, "finish": 0.0,
                       "wait": 0.0}

    # ---------- helpers ----------

    def _region_quality(self, seq: np.ndarray, tgt: np.ndarray,
                        s1: float, s2: Optional[float]) -> np.ndarray:
        """Per-base quality of a corrected region via CIGAR matches."""
        q = np.full(len(seq), 0, dtype=np.uint8)
        margin = 1.0 if (s2 is None or s1 <= 0) else max(1.0 - s2 / s1, 0.0)
        # CIGAR matches use the full quality floor 0, not out_qual
        # (getScorePath: getQual(score_best, 0, max_qual) for matches vs
        # getQual(score_comp, out_qual, max_qual) elsewhere,
        # GraphTraversal.cpp:735,737)
        q_match = dna.get_qual_char(max(min(s1, 1.0), 0.0), qv_min=0,
                                    qv_max=self.qv_max)
        q_other = _qual_for(self.opt, s1 * margin)
        if len(seq) == 0:
            return q
        if len(tgt) == 0:
            q[:] = q_other
            return q
        _, _, _, qclass = CG.aln_stats(dna.codes_to_masks(seq),
                                       dna.codes_to_masks(tgt), CG.NW,
                                       want_qclass=True)
        return np.where(qclass == 0, q_match, q_other).astype(np.uint8)

    def _region_iupac(self, sp: RegionSpec, s1: float) -> Optional[np.ndarray]:
        """fixAmbiguity over a beam-corrected gap region (Alignment.cpp:527-844).

        The winning path's unitig chain is recovered by re-anchoring the
        corrected sequence on the graph (it is graph-perfect, so find_runs
        maps every k-mer); graph-annotated het sites falling inside the chain
        are checked against the raw read via the alignment's query->target
        map: if the raw read carries the OTHER allele and the correction is
        below `min_confidence_snp_corr`, the site surfaces as an IUPAC code
        instead of silently picking one allele.
        """
        if (self.snps is None or self.snps.n_sites == 0 or sp.seq is None
                or len(sp.seq) < self.cdbg.k
                or s1 >= self.opt.min_confidence_snp_corr):
            # n_sites == 0 skips the per-region find_runs re-anchor entirely
            # (the common case on haploid data; r4 weak #4 host-finish cost)
            return None
        k = self.cdbg.k
        seq = sp.seq
        sites = []   # (seq_pos, oriented mask)
        for run in find_runs(self.cdbg, seq):
            for po, mo in _oriented_sites(self.snps, self.cdbg, run):
                j = run.s + (po - run.o_s)
                if run.s <= j < run.e + k and 0 <= j < len(seq):
                    sites.append((j, mo))
        if not sites:
            return None
        _, cig, b0, _ = CG.aln_cigar(dna.codes_to_masks(seq),
                                     dna.codes_to_masks(sp.tgt), CG.NW)
        q2t = CG.query_target_map(cig, len(seq), b0)
        return _iupac_masks(seq, [(j, int(sp.tgt[q2t[j]]), mo)
                                  for j, mo in sites if q2t[j] >= 0])

    def resolve_iupac(self, cr: "CorrectedRead") -> int:
        """fixSNPs (-f, Alignment.cpp:846-965): disambiguate leftover IUPAC
        sites by testing each allele's k covering k-mers against the graph;
        the best-supported allele wins (first allele on ties). Returns the
        number of sites resolved."""
        if cr.iupac is None or not cr.iupac.any():
            return 0
        from ratatosk_tpu_torch.graph.keys import KeyArray
        k = self.cdbg.k
        codes = cr.codes
        index_keys = KeyArray(k, np.asarray(self.cdbg.index.keys_lo),
                              np.asarray(self.cdbg.index.keys_hi)
                              if self.cdbg.index.two_word else None)
        n_res = 0
        for j in np.flatnonzero(cr.iupac):
            m = int(cr.iupac[j])
            alleles = [b for b in range(4) if (1 << b) & m]
            if len(alleles) < 2:
                cr.iupac[j] = 0
                continue
            a0 = max(j - k + 1, 0)
            b0 = min(j + k, len(codes))
            best, best_n = int(codes[j]), -1
            for b in alleles:
                win = codes[a0:b0].copy()
                win[j - a0] = b
                if len(win) < k:
                    continue
                ka, valid = KeyArray.from_codes(win, k)
                can, _ = ka.canonical()
                rows = index_keys.find(can)
                n = int(((rows >= 0) & valid).sum())
                if n > best_n:
                    best, best_n = b, n
            codes[j] = best
            cr.iupac[j] = 0
            n_res += 1
        return n_res

    # ---------- device execution ----------

    def _launch_bucket(self, specs: List[RegionSpec], nt: int, mirrored: bool,
                       beam: Optional[int] = None, pool=None):
        """One launch, queued: returns (read, lmax), where read() waits for
        it and gives its (scalars, seq_packed) as NumPy, covering at least
        the launch's real rows. With a mesh the rows split over the slots of
        `pool` (parallel.mesh.SlotPool), each run on its own thread."""
        # pad R to a power-of-two tier in [128, batch_regions], as the
        # reference does, so both packages launch the same shapes. Padding
        # rows are inert (tgt_len=1, max_plen=1) and freeze on the first step.
        R = len(specs)
        Rp = 1 << int(np.ceil(np.log2(max(R, 1))))
        Rp = min(Rp, self.opt.batch_regions)
        Rp = max(Rp, min(128, self.opt.batch_regions))
        if self.mesh is not None:
            nd = self.mesh.size
            Rp = ((Rp + nd - 1) // nd) * nd
        arrays, lmax = region_arrays(
            specs, nt, self.colors.cap, mirrored=mirrored, r_pad=Rp,
            len_factor=self.opt.weak_region_len_factor)
        band = bucket_band(nt, self.opt)
        kw = dict(beam=beam or self.opt.beam_width, lmax=lmax,
                  min_cov=self.opt.min_cov_vertices, band=band, w=band,
                  min_score_open=self.opt.min_score_open_region,
                  impl=self.impl)
        def host(fin):
            return fin.scalars.cpu().numpy(), fin.seq_packed.cpu().numpy()

        if self.mesh is None:
            rb = BM.RegionBatch.from_numpy(arrays, self.device)
            fin = _beam_finish(self.g, rb, self.qv_max, self.cdbg.k, **kw)
            return (lambda: host(fin)), lmax

        def slot(dev, rows, steps):
            # upload, launch and read-back on the slot's thread and stream;
            # the launch's slots agree on its step count T
            rb = BM.RegionBatch.from_numpy(
                {f: a[rows] for f, a in arrays.items()}, dev)
            return host(_beam_finish(self.replicas[dev], rb, self.qv_max,
                                     self.cdbg.k, launch_t=steps.agree,
                                     **kw))

        futs = pool.submit_rows(Rp, slot, n_real=R)
        return (lambda: M.gather(futs)), lmax

    def warmup_compile(self) -> None:
        """Build the kernel library before the timed run (nvcc at first use;
        PyTorch itself compiles nothing), and pin the device planner's pad
        tier at the production batch size."""
        devs = self.mesh.devices if self.mesh is not None else [self.device]
        if self.impl != "torch" and any(d.type == "cuda" for d in devs):
            from ratatosk_tpu_torch.ops import cuda_lib
            cuda_lib.library()
        if self.devplan is not None:
            self.devplan.warmup(self.opt.read_batch_bp,
                                stride=self.opt.weak_seed_stride,
                                near_exact_skip=_NEAR_EXACT_SKIP)

    def _execute_regions(self, regions: List[RegionSpec]):
        # forward pass, bucketed by target length; all bucket batches are
        # dispatched asynchronously before any result is read back, so the
        # device pipelines across buckets. Failed forward gaps retry backward
        # (Correction.cpp:880); with -r > 1, still-failed gaps retry at a
        # doubled beam width per round (the reference's staged relaxation,
        # Ratatosk.cpp:847-865) before falling back to the partial consensus.
        rounds = max(self.opt.nb_correction_rounds, 1)
        pending = [(i, False, 1) for i in range(len(regions))]

        def tgt_len(i: int, mirrored: bool) -> int:
            # mirrored retries pack mirror_tgt, which can be up to 2 bp
            # LONGER than tgt when the anchors are weak seeds with rspan
            # k±1 — bucket by the length actually packed
            sp = regions[i]
            if mirrored and sp.mirror_tgt is not None:
                return len(sp.mirror_tgt)
            return len(sp.tgt)

        # with a mesh, launches queue on the slots' threads and the read-back
        # below waits for them; leaving the block joins the threads
        with (M.SlotPool(self.mesh) if self.mesh is not None
              else contextlib.nullcontext()) as pool:
            while pending:
                by_bucket: dict = {}
                for i, mirrored, rnd in pending:
                    ln = tgt_len(i, mirrored)
                    nt = next((b for b in BUCKETS if ln <= b), None)
                    if nt is None:
                        continue
                    by_bucket.setdefault((nt, mirrored, rnd), []).append(i)
                chunk = max(self.opt.batch_regions, 8)
                launched = []
                with TR.span("launch", self.timers):
                    for (nt, mirrored, rnd), items in by_bucket.items():
                        beam = self.opt.beam_width * (1 << (rnd - 1))
                        # sort by target length: the while_loop exits when
                        # every entry is frozen, so homogeneous chunks stop
                        # at ~1.25x their own longest region instead of the
                        # bucket's worst case
                        items.sort(key=lambda i: tgt_len(i, mirrored))
                        for c0 in range(0, len(items), chunk):
                            idxs = items[c0:c0 + chunk]
                            read, lmax = self._launch_bucket(
                                [regions[i] for i in idxs], nt, mirrored,
                                beam=beam, pool=pool)
                            launched.append((idxs, mirrored, rnd, read,
                                             lmax))
                retry = []
                with TR.span("finish", self.timers):
                    for idxs, mirrored, rnd, read, lmax in launched:
                        # the two result arrays of the launch, sliced on the
                        # host
                        scal, packed = read()
                        scal = scal[:len(idxs)]
                        seqs = FN.unpack_codes(packed[:len(idxs)], lmax)
                        for j, i in enumerate(idxs):
                            sp = regions[i]
                            final = mirrored and rnd >= rounds
                            ok = self._finish_region(sp, scal[j], seqs[j],
                                                     mirrored, final)
                            if ok or sp.kind != "gap" or not sp.mirror:
                                continue
                            if not mirrored:
                                retry.append((i, True, rnd))
                            elif rnd < rounds:
                                retry.append((i, False, rnd + 1))
                pending = retry

    def _finish_region(self, sp: RegionSpec, scal: np.ndarray,
                       seq_full: np.ndarray, mirrored: bool,
                       final: bool = True) -> bool:
        k = self.cdbg.k
        n = len(sp.tgt)
        (blen, d1, end, d2, completed, istar, jend_open, s1_open_m, ok_open,
         pdist, pjend) = (int(x) for x in scal[:11])
        seq = seq_full[:blen]
        s1 = 1.0 - d1 / max(n, 1)
        s2 = None if d2 >= (1 << 20) else 1.0 - d2 / max(n, 1)
        if sp.kind == "gap":
            gate = self.opt.min_score_closed_region
            if sp.tgt_qual is not None and n > 0:
                # a completed walk may only replace bases it agrees with at
                # least as well as their certified identity (same rule as
                # open regions)
                q = sp.tgt_qual.astype(np.float32)
                gate = max(gate, float(np.mean(np.clip(q - 33, 0, self.qv_max))
                                       / self.qv_max))
            if not completed or blen == 0 or s1 < gate:
                self._record_partial(sp, seq, end, pdist, pjend, mirrored)
                if mirrored and final:
                    return self._merge_partials(sp)
                return False
            if mirrored:
                # mirrored path covers raw [raw_a-k, raw_b-k) reversed; drop its
                # trailing left-anchor k-mer and re-append the right-anchor k-mer
                fwd = dna.revcomp_codes(seq)
                if len(fwd) < k:
                    return False
                body = fwd[k:]
                anchor = sp.end_anchor if sp.end_anchor is not None else sp.tgt[-k:]
                ew = sp.end_win or k
                sp.seq = np.concatenate([body, anchor])
                q = self._region_quality(body, sp.tgt[:max(n - ew, 0)], s1, s2)
                sp.qual = np.concatenate(
                    [q, np.full(k, _qual_for(self.opt, 1.0), np.uint8)])
            else:
                sp.seq = seq
                sp.qual = self._region_quality(seq, sp.tgt, s1, s2)
            sp.ok = True
            sp.iupac = self._region_iupac(sp, s1)
            return True
        return self._finish_open(sp, seq, istar, jend_open, s1_open_m,
                                 ok_open, s2)

    def _record_partial(self, sp: RegionSpec, seq: np.ndarray, end: int,
                        pdist: int, pjend: int, mirrored: bool) -> None:
        """Trim a non-completed path to its covered target prefix and stash it.

        The SHW trim (dist of tgt[:end] vs the path, max-tie cut column) was
        computed on device by the finish bundle: dist = dmin[end],
        cut = endcol[end] (correct/finish.py)."""
        blen = len(seq)
        if blen == 0 or end <= 0:
            return
        jend = pjend
        if jend <= 0:
            return
        s = 1.0 - pdist / max(end, 1)
        if s < 0.25:
            return
        part = (seq[:jend].copy(), end, s)
        prev = sp.partial_bw if mirrored else sp.partial_fw
        if prev is not None and (prev[1], prev[2]) >= (end, s):
            return  # keep the better partial across retry rounds
        if mirrored:
            sp.partial_bw = part
        else:
            sp.partial_fw = part

    def _merge_partials(self, sp: RegionSpec) -> bool:
        """Consensus of partial fw/bw corrections (Alignment.cpp:309-470).

        fw covers raw [raw_a, raw_a+end_f); bw (reversed) covers
        raw [raw_b-k-end_b, raw_b-k), to which the solid right-anchor k-mer
        raw[raw_b-k, raw_b) is appended. OVERLAPPING partials are merged
        region-wise: the side that corrected the longer stretch keeps the
        overlap, and the other side's non-overlapping remainder is spliced at
        a CIGAR-mapped cut (generateConsensus's per-region choice +
        moveIntoCIGAR, Alignment.cpp:354-448).
        """
        k = self.cdbg.k
        n = len(sp.tgt)
        f = sp.partial_fw
        b = sp.partial_bw
        if f is None and b is None:
            return False
        end_f = f[1] if f else 0
        end_b = b[1] if b else 0
        anchor = sp.end_anchor if sp.end_anchor is not None else sp.tgt[-k:]
        ew = sp.end_win or k   # raw bases the right-anchor window consumes
        anchor_q = np.full(len(anchor), _qual_for(self.opt, 1.0), np.uint8)
        nb0 = n - ew - end_b   # first target column bw covers
        overlap = f is not None and b is not None and end_f > nb0

        if overlap:
            bw_seq = dna.revcomp_codes(b[0])
            if end_f >= end_b:
                # fw keeps the overlap; splice bw's remainder past column
                # end_f via its query->target CIGAR map
                bw_tgt = sp.tgt[max(nb0, 0):n - ew]
                _, cig, c0, _ = CG.aln_cigar(dna.codes_to_masks(bw_seq),
                                             dna.codes_to_masks(bw_tgt),
                                             CG.NW)
                q2t = CG.query_target_map(cig, len(bw_seq), c0)
                past = np.flatnonzero(q2t >= end_f - max(nb0, 0))
                bw_rest = bw_seq[past[0]:] if past.size else \
                    np.zeros(0, np.uint8)
                sp.seq = np.concatenate([f[0], bw_rest, anchor])
                sp.qual = np.concatenate([
                    np.full(len(f[0]), _qual_for(self.opt, f[2]), np.uint8),
                    np.full(len(bw_rest), _qual_for(self.opt, b[2]), np.uint8),
                    anchor_q])
            else:
                # bw keeps the overlap; cut fw at column nb0
                fw_tgt = sp.tgt[:end_f]
                _, cig, c0, _ = CG.aln_cigar(dna.codes_to_masks(f[0]),
                                             dna.codes_to_masks(fw_tgt),
                                             CG.NW)
                q2t = CG.query_target_map(cig, len(f[0]), c0)
                keep = np.flatnonzero(q2t >= nb0)
                fw_head = f[0][:keep[0]] if keep.size else f[0]
                sp.seq = np.concatenate([fw_head, bw_seq, anchor])
                sp.qual = np.concatenate([
                    np.full(len(fw_head), _qual_for(self.opt, f[2]), np.uint8),
                    np.full(len(bw_seq), _qual_for(self.opt, b[2]), np.uint8),
                    anchor_q])
            sp.ok = True
            return True

        if f and (not b or end_f >= end_b) and end_f + ew <= n:
            # fw partial + raw middle + right-anchor graph k-mer
            qual_f = np.full(len(f[0]), _qual_for(self.opt, f[2]), np.uint8)
            mid = sp.tgt[end_f:n - ew]
            mid_q = np.full(len(mid), 33, np.uint8)
            if b and end_f + end_b + ew <= n:
                bw_seq = dna.revcomp_codes(b[0])
                qual_b = np.full(len(bw_seq), _qual_for(self.opt, b[2]), np.uint8)
                mid = sp.tgt[end_f:n - ew - end_b]
                mid_q = np.full(len(mid), 33, np.uint8)
                sp.seq = np.concatenate([f[0], mid, bw_seq, anchor])
                sp.qual = np.concatenate([qual_f, mid_q, qual_b, anchor_q])
            else:
                sp.seq = np.concatenate([f[0], mid, anchor])
                sp.qual = np.concatenate([qual_f, mid_q, anchor_q])
        elif b and end_b + ew <= n:
            bw_seq = dna.revcomp_codes(b[0])
            qual_b = np.full(len(bw_seq), _qual_for(self.opt, b[2]), np.uint8)
            mid = sp.tgt[:n - ew - end_b]
            sp.seq = np.concatenate([mid, bw_seq, anchor])
            sp.qual = np.concatenate([np.full(len(mid), 33, np.uint8), qual_b,
                                      anchor_q])
        else:
            return False
        sp.ok = True
        return True

    def _finish_open(self, sp: RegionSpec, seq: np.ndarray, istar: int,
                     jend: int, s1_open_m: int, ok_open: int, s2) -> bool:
        # open regions (head/tail): an open region has no right anchor to
        # certify the path, so a free-running beam can return a walk that
        # starts right and then diverges (e.g. through a repeat). Accept only
        # the longest target prefix that stays well-aligned — maximize
        # (matched bases - 2*edits) over prefixes, the X-drop-style analog of
        # the reference's waypoint-by-waypoint extension + SHW overshoot trim
        # (extractSemiWeakPaths Correction.cpp:3-157; trim 727-747). The
        # uncovered suffix keeps its raw bases. The prefix DP, the
        # quality-aware gates and the max-tie path cut all ran on device
        # (finish_bundle, correct/finish.py) — here we only apply them.
        if not ok_open:
            return False
        s1 = s1_open_m / 1e6
        seq = seq[:jend]
        sp.covered = istar
        qual = self._region_quality(seq, sp.tgt[:istar], s1, s2)
        if sp.kind == "head":
            # target was reversed: result maps to raw [raw_a, raw_b)
            sp.seq = dna.revcomp_codes(seq)
            sp.qual = qual[::-1].copy()
        else:
            sp.seq = seq
            sp.qual = qual
        sp.ok = True
        return True

    # ---------- assembly ----------

    def _assemble(self, codes: np.ndarray, raw_qual: Optional[np.ndarray],
                  segs, regions: List[RegionSpec]) -> CorrectedRead:
        out_seq, out_qual = [], []
        out_iupac: list = []    # (global offset, mask array) of splice sites
        n_solid = n_regions = n_corr = 0

        def raw_span(a, b):
            out_seq.append(codes[a:b])
            if raw_qual is not None:
                out_qual.append(np.clip(raw_qual[a:b], 33, 33 + self.qv_max))
            else:
                out_qual.append(np.full(b - a, 33, dtype=np.uint8))

        for seg in segs:
            if seg[0] == "raw":
                raw_span(seg[1], seg[2])
            elif seg[0] == "solid":
                n_solid += 1
                out_seq.append(codes[seg[1]:seg[2]])
                out_qual.append(np.full(seg[2] - seg[1], _qual_for(self.opt, 1.0), np.uint8))
            elif seg[0] == "splice":
                n_corr += 1
                out_seq.append(seg[1])
                out_qual.append(seg[2])
                if len(seg) > 3 and seg[3] is not None:
                    out_iupac.append((sum(map(len, out_seq[:-1])), seg[3]))
            else:  # region
                sp = regions[seg[1]]
                n_regions += 1
                if not sp.ok:
                    raw_span(sp.raw_a, sp.raw_b)
                    continue
                n_corr += 1
                if sp.kind == "gap":
                    if sp.iupac is not None:
                        out_iupac.append((sum(map(len, out_seq)), sp.iupac))
                    out_seq.append(sp.seq)
                    out_qual.append(sp.qual)
                elif sp.kind == "tail":
                    out_seq.append(sp.seq)
                    out_qual.append(sp.qual)
                    if sp.covered < sp.raw_b - sp.raw_a:
                        raw_span(sp.raw_a + sp.covered, sp.raw_b)
                else:  # head: corrected suffix of the head span
                    if sp.covered < sp.raw_b - sp.raw_a:
                        raw_span(sp.raw_a, sp.raw_b - sp.covered)
                    out_seq.append(sp.seq)
                    out_qual.append(sp.qual)
        seq = np.concatenate(out_seq) if out_seq else np.zeros(0, np.uint8)
        qual = np.concatenate(out_qual) if out_qual else np.zeros(0, np.uint8)
        iupac = None
        if out_iupac:
            iupac = np.zeros(len(seq), dtype=np.uint8)
            for off, arr in out_iupac:
                iupac[off:off + len(arr)] = arr
        return CorrectedRead(codes=seq, qual=qual, n_solid=n_solid,
                             n_regions=n_regions, n_corrected=n_corr,
                             iupac=iupac)

    # ---------- public API ----------

    def plan_batch(self, reads: Sequence[np.ndarray],
                   quals: Optional[Sequence[np.ndarray]] = None,
                   names: Optional[Sequence[str]] = None):
        """Planner.plan_batch, timed in self.timers as it is at the call."""
        return self.planner.plan_batch(reads, quals, names, self.timers)
    def assemble_batch(self, reads_np, quals, plans, regions
                       ) -> List[CorrectedRead]:
        out = []
        with TR.span("assemble"):
            for i, (codes, segs) in enumerate(zip(reads_np, plans)):
                rq = None if quals is None else quals[i]
                out.append(self._assemble(codes, rq, segs, regions))
        return out

    def correct_batch(self, reads: Sequence[np.ndarray],
                      quals: Optional[Sequence[np.ndarray]] = None,
                      names: Optional[Sequence[str]] = None
                      ) -> List[CorrectedRead]:
        reads_np, plans, regions = self.plan_batch(reads, quals, names)
        self._execute_regions(regions)
        return self.assemble_batch(reads_np, quals, plans, regions)
