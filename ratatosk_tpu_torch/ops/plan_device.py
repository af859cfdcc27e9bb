"""Device-side batch planning: exact-anchor runs + 1-edit seed probe.

Port of ratatosk_tpu/ops/plan_device.py (plain JAX there). Here
`_runs_kernel` and `_probe_kernel` are the plain torch versions; on a CUDA
device the planner launches their hand-written kernels instead
(ops/plan_kernel.py, csrc/plan.cu), unless its impl is "torch". Both
host-planner costs are index lookups, and this module runs them as TWO
device dispatches per read batch against the two-orientation
hash-directory index (ops/hash_index.py):

- `runs`: every k-window of the concatenated read batch is packed,
  hash-probed in READ orientation (the doubled table answers orientation),
  and chained into maximal colinear runs (correct/seeds.find_runs
  semantics, Graph.cpp:203-239); runs are compacted on the device so the
  download is O(runs), not O(L).
- `probe`: the reference's masked inexact re-search (Graph.cpp:100-196 ->
  searchSequence with 1 substitution/indel), in three phases:
    exact: probe every window, derive the near-exact skip mask;
    A: compact the allowed window positions, then loop over edit positions
       generating each 1-edit variant key by 128-bit surgery (ops/u128.py)
       in FORWARD orientation only, 32-bit-word hashing, and testing the
       hashed occupancy bitmap; survivors' keys are appended to a bounded
       buffer;
    B: ONE hash-table probe over the survivor buffer, then scatter-min/max
       of a packed placement identity (row, rsp-kind, orientation) per
       window position. A position yields a seed iff it has an exact hit or
       exactly ONE distinct 1-edit placement (`min == max`).

Dispatch queues device work only: fixed-capacity compaction, no
`nonzero`, no `.item()`, no branch on a device value. `collect_*` is where
the host waits. JAX drops out-of-range scatters; here every scatter target
past the end goes to one extra slot that is sliced off (or, for the
survivor buffer, to the reference's own never-valid last row).

Bit-identical to correct/seeds.find_runs / find_weak_seeds_batch (pinned by
tests/test_torch_plan_device.py). The reference's two host paths stay: an
index too large for the int32 placement identity gets no planner
(`build` returns None), and a batch whose caps overflow is planned on the
host and counted in `n_fallback`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ratatosk_tpu_torch.ops import hash_index as HX
from ratatosk_tpu_torch.ops import u128 as U

_SUB, _DEL, _INS = 0, 1, 2     # rsp codes packed into the placement identity
_BIG = 0x7FFFFFFF
# DevicePlanner.timers, for runs and probe alike: `dispatch` the host's
# concat, upload and enqueue; `wait` the host blocked in collect_* until the
# results are downloaded; `build` making the anchor and seed objects;
# `device` the dispatched work's device seconds (CUDA events; 0 on the CPU)
TIMERS = tuple(f"{d}_{part}" for d in ("runs", "probe")
               for part in ("dispatch", "wait", "build", "device"))


def _pad_tier(n: int, lo: int = 1 << 16) -> int:
    t = lo
    while t < n:
        t <<= 1
    return t


def _compact_i32(mask, size: int, fill: int):
    """Positions of set bits, compacted to [size] (ascending, `fill`
    padded). Bits past `size` are dropped into one extra slot."""
    idx = torch.cumsum(mask, 0, dtype=torch.int64) - 1
    pos = torch.arange(mask.shape[0], dtype=torch.int64, device=mask.device)
    tgt = torch.where(mask & (idx < size), idx, size)
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=mask.device)
    return out.scatter_(0, tgt, pos)[:size]


def _pack_windows(codes, m: int):
    """(hi, lo, valid) of every m-window of uint8 codes [L]; hi and lo are
    int64-held uint64 words (ops/kmers.py layout), hi zeros when m <= 32.
    Windows holding a base >= 4 are invalid (their bits are garbage)."""
    L = codes.shape[0]
    P = L - m + 1
    c = (codes & 3).long()
    cs = torch.cumsum(codes >= 4, 0, dtype=torch.int64)
    head = torch.cat([cs.new_zeros(1), cs[:P - 1]])
    valid = (cs[m - 1:] - head) == 0
    hi = torch.zeros(P, dtype=torch.int64, device=codes.device)
    lo = torch.zeros(P, dtype=torch.int64, device=codes.device)
    for j in range(max(m - 32, 0)):
        hi |= c[j:j + P] << (2 * (m - 33 - j))
    for j in range(max(m - 32, 0), m):
        lo |= c[j:j + P] << (2 * (m - 1 - j))
    return hi, lo, valid


# ---------------------------------------------------------------------------
# runs
# ---------------------------------------------------------------------------

def _runs_kernel(codes, hx: HX.HashKmerIndex, nk, *, k: int, rcap: int):
    P = codes.shape[0] - k + 1
    whi, wlo, valid = _pack_windows(codes, k)
    uid, upos, strand, is_fw = HX.probe_upa_raw(
        hx, wlo, whi if k > 32 else None, valid)
    hit = uid >= 0
    direction = torch.where(is_fw == (strand == 1), 0, 1)
    o = torch.where(direction == 0, upos,
                    nk[torch.clamp(uid, min=0)] - 1 - upos)
    chain = (hit[:-1] & hit[1:] & (uid[:-1] == uid[1:])
             & (direction[:-1] == direction[1:]) & (o[1:] == o[:-1] + 1))
    f = torch.zeros(1, dtype=torch.bool, device=codes.device)
    start = hit & ~torch.cat([f, chain])
    end = hit & ~torch.cat([chain, f])
    n = start.sum()
    sidx = _compact_i32(start, rcap, P)
    eidx = _compact_i32(end, rcap, P)
    safe = torch.clamp(sidx, max=P - 1)
    return (sidx, eidx, uid[safe], direction[safe], o[safe], n)


# ---------------------------------------------------------------------------
# probe
# ---------------------------------------------------------------------------

def _variant_key(kind: int, k: int, whi, wlo, p: int):
    """Forward-orientation 1-edit variant keys at edit position p:
    [(hi, lo, keep)], keep None = all."""
    if kind == _SUB:
        orig = U.get_base(whi, wlo, k, p)
        return [U.set_base(whi, wlo, k, p, b) + (orig != b,)
                for b in range(4)]
    if kind == _DEL:
        return [U.drop_base(whi, wlo, k + 1, p) + (None,)]
    return [U.insert_base(whi, wlo, k - 1, p, b) + (None,) for b in range(4)]


def _scan_side(kind: int, k: int, whi, wlo, qv, pf_tbl, pf_bits, qpos,
               buf, qcap: int, scap: int, tcap: int, two_word: bool,
               p_lo: int, p_hi: int) -> None:
    """Append prefilter-surviving variants (key words, concat position,
    kind) to the survivor buffer, edit positions p in [p_lo, p_hi).

    whi/wlo: m-window packs at one SIDE's qualifying positions [qcap]
    (pigeonhole: prefix-intact positions scan the tail edit range, suffix-
    intact positions the head range); qv masks the compaction padding.
    buf: dict of the buffer tensors w, meta and the scalars cnt, of;
    updated in place.
    """
    nb = 1 if kind == _DEL else 4
    dev = wlo.device
    slot = torch.arange(scap, dtype=torch.int64, device=dev)
    for p in range(p_lo, p_hi):
        kl, ok = [], []
        for vh, vl, keep in _variant_key(kind, k, whi, wlo, p):
            words = list(HX.split64(vl))
            if two_word:
                words += list(HX.split64(vh))
            pass_pf = qv & HX.prefilter_test(pf_tbl, pf_bits,
                                             HX.hash_words(*words))
            if keep is not None:
                pass_pf = pass_pf & keep
            kl.append(torch.stack(words, 1))
            ok.append(pass_pf)
        keyw = torch.stack(kl, 1)                # [qcap, nb, W]
        flat = torch.stack(ok, 1).reshape(-1)    # [qcap * nb]
        c = flat.sum()
        cnt = buf["cnt"]
        buf["of"] = buf["of"] | (cnt + c > tcap) | (c > scap)
        sel = _compact_i32(flat, scap, qcap * nb)
        ssafe = torch.clamp(sel, max=qcap * nb - 1)
        kw_sel = keyw.reshape(qcap * nb, -1)[ssafe]
        pos_sel = qpos[ssafe // nb]
        # past the buffer's end -> its last row, which is never valid
        # (cnt stays <= tcap), where the reference drops the write
        tgt = torch.where(sel < qcap * nb, torch.clamp(cnt + slot, max=tcap),
                          tcap)
        buf["w"][tgt] = kw_sel
        buf["meta"][tgt] = (pos_sel << 2) | kind
        buf["cnt"] = torch.clamp(cnt + c, max=tcap)


def probe_caps(qcap: int):
    """(scap, tcap): survivors of one (kind, side, p) step and in all, the
    reference's functions of qcap."""
    return max(qcap // 8, 1 << 12), qcap * 4


def overflow_cap(stats, n: int, *, qcap: int, hcap: int) -> str:
    """Which cap an overflowing probe batch's `of` came from, read from its
    stats and the caps: "qcap" if some (kind, side) qualified more
    positions, "hcap" if it has more seeds, "tcap" if its survivors reached
    the total cap (stats hold min(survivors, tcap), so a total of exactly
    tcap with a step over scap reads as tcap), else "scap"."""
    _, tcap = probe_caps(qcap)
    if int(stats[1]) > qcap:
        return "qcap"
    if n > hcap:
        return "hcap"
    if int(stats[2]) == tcap:
        return "tcap"
    return "scap"


def span_sstart(starts, L: int):
    """The span start of every concat position [L] from the spans' starts
    (int64, ascending): the last start at or before the position, 0 before
    the first (and everywhere without spans). The plain probe's per-position
    input; the probe kernel takes the starts themselves."""
    pos = torch.arange(L, dtype=torch.int64, device=starts.device)
    if starts.numel() == 0:
        return torch.zeros_like(pos)
    j = torch.searchsorted(starts, pos, right=True) - 1
    return torch.where(j >= 0, starts[torch.clamp(j, min=0)], 0)


def _probe_kernel(codes, sstart, hx: HX.HashKmerIndex, pf_tbl, hf_tbl, *,
                  k: int, stride: int, nes: int, subs: bool, indels: bool,
                  pf_bits: int, hf_bits: int, qcap: int, hcap: int):
    """codes: concat span codes uint8 [L] (separator >= 4); sstart: span
    start concat position per position, int64 [L]."""
    L = codes.shape[0]
    dev = codes.device
    posL = torch.arange(L, dtype=torch.int64, device=dev)
    two = hx.two_word
    h = (k - 1) // 2

    # exact phase: k-windows at every valid position, read orientation
    whi_L, wlo_L, valid_k = _pack_windows(codes, k)
    ex_row_p, ex_fw_p, _ = HX.probe_rowflag(
        hx, wlo_L, whi_L if k > 32 else None, valid_k)
    P = L - k + 1
    ex_row = torch.cat([ex_row_p, ex_row_p.new_full((L - P,), -1)])
    ex_fw = torch.cat([ex_fw_p.long(), ex_row_p.new_zeros(L - P)])

    # near-exact skip mask over concat positions (windowed OR via cumsum)
    cs = torch.cat([posL.new_zeros(1),
                    torch.cumsum(ex_row >= 0, 0, dtype=torch.int64)])
    if nes > 0:
        a = torch.clamp(posL - nes, 0, L)
        b = torch.clamp(posL + nes + 1, 0, L)
        skip = (cs[b] - cs[a]) > 0
    else:
        skip = torch.zeros(L, dtype=torch.bool, device=dev)
    if stride > 1:
        on_stride = (posL - sstart) % stride == 0
    else:
        on_stride = torch.ones(L, dtype=torch.bool, device=dev)
    allowed = ~skip & on_stride

    # pigeonhole half filter: one h-window hash-bitmap pass over the concat;
    # a position qualifies for a kind only if its h-prefix or the kind's
    # h-suffix exists among the graph keys' halves (make_half_bitmap)
    _, hlo, hvalid = _pack_windows(codes, h)
    hhit_p = hvalid & HX.prefilter_test(hf_tbl, hf_bits, HX.hash_key64(hlo))
    hhit = torch.cat([hhit_p, hhit_p.new_zeros(L - hhit_p.shape[0])])

    def suf_ok(m):
        # h-suffix of the m-window at pos starts at pos + m - h
        return hhit[torch.clamp(posL + (m - h), max=L - 1)]

    kinds = []
    if subs:
        kinds.append((_SUB, k))
    if indels:
        kinds.append((_DEL, k + 1))
        kinds.append((_INS, k - 1))

    W = 4 if two else 2
    # caps: the half filter qualifies ~10-25% of allowed positions on noisy
    # spans; prefilter survivors are ~1-3% of enumerated variants. Overflow
    # of any cap -> host fallback (reported via `of`).
    scap, tcap = probe_caps(qcap)
    zero = posL.new_zeros(())
    buf = {"w": torch.zeros((tcap + 1, W), dtype=torch.int64, device=dev),
           "meta": torch.zeros(tcap + 1, dtype=torch.int64, device=dev),
           "cnt": zero, "of": torch.zeros((), dtype=torch.bool, device=dev)}
    # two pigeonhole sides per kind: prefix-intact positions enumerate the
    # tail edit range [h, k), suffix-intact ones the head range
    # [p0, suf_max]; both-flag positions enter both sides (the small
    # [h, suf_max] overlap re-probes duplicates — harmless for the
    # min==max distinct test)
    nq_max = zero
    for kind, m in kinds:
        wh_m, wl_m, wv_m = _pack_windows(codes, m)
        Pm = wv_m.shape[0]
        validm = torch.cat([wv_m, wv_m.new_zeros(L - Pm)])
        p0 = 0 if kind == _SUB else 1
        suf_max = (k - h) if kind == _DEL else (k - 1 - h)
        sides = ((hhit, max(p0, h), k), (suf_ok(m), p0, suf_max + 1))
        for flag, p_lo, p_hi in sides:
            qual = allowed & validm & flag
            nq = qual.sum()
            nq_max = torch.maximum(nq_max, nq)
            buf["of"] = buf["of"] | (nq > qcap)
            qpos = _compact_i32(qual, qcap, L)
            qsafe = torch.clamp(qpos, max=Pm - 1)
            _scan_side(kind, k, wh_m[qsafe], wl_m[qsafe], qpos < L, pf_tbl,
                       pf_bits, qpos, buf, qcap, scap, tcap, two, p_lo, p_hi)

    # phase B: one probe over the survivor buffer
    bw = buf["w"]
    blo = bw[:, 0] | (bw[:, 1] << 32)
    bhi = (bw[:, 2] | (bw[:, 3] << 32)) if two else None
    tvalid = torch.arange(tcap + 1, device=dev) < buf["cnt"]
    row_b, fw_b, _ = HX.probe_rowflag(hx, blo, bhi, tvalid)
    kind_b = buf["meta"] & 3
    pos_b = buf["meta"] >> 2
    ids = ((row_b * 3 + kind_b) << 1) | fw_b.long()
    tgt = torch.where(row_b >= 0, pos_b, L)
    minid = posL.new_full((L + 1,), _BIG).scatter_reduce_(
        0, tgt, ids, "amin", include_self=True)[:L]
    maxid = posL.new_full((L + 1,), -_BIG).scatter_reduce_(
        0, tgt, ids, "amax", include_self=True)[:L]

    var_ok = (minid != _BIG) & (minid == maxid)
    varid_L = torch.where(var_ok, minid, -1)

    outmask = (ex_row >= 0) | var_ok
    n = outmask.sum()
    of = buf["of"] | (n > hcap)
    sel = _compact_i32(outmask, hcap, L)
    safe = torch.clamp(sel, max=L - 1)
    # stats: [n_allowed, max n_qual, survivor cnt, n_seeds]
    stats = torch.stack([allowed.sum(), nq_max, buf["cnt"], n])
    return (sel, ex_row[safe], ex_fw[safe], varid_L[safe], n, of, stats)


# ---------------------------------------------------------------------------
# host wrapper
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DevicePlanner:
    """Per-corrector device planning state (index tables resident on the
    device)."""

    k: int
    device: torch.device
    hx: HX.HashKmerIndex
    pf_tbl: torch.Tensor
    pf_bits: int
    hf_tbl: torch.Tensor
    hf_bits: int
    nk_dev: torch.Tensor
    # host copies for resolving probe rows to placements
    uid: np.ndarray
    upos: np.ndarray
    strand: np.ndarray
    nk: np.ndarray
    # the Corrector's route (correct.beam.IMPLS): "torch" runs the plain
    # versions; else a CUDA device launches the kernels of csrc/plan.cu
    # (ops/plan_kernel.py; a CPU tensor takes the plain versions there)
    impl: str = "auto"
    n_fallback: int = 0
    # high-water-mark pad tier: every dispatch pads its concat up to the
    # largest tier seen so far (warmup() pre-sets it to the full-batch
    # tier). The caps are pure functions of the tier, as in the reference,
    # so both packages overflow on the same batches.
    min_tier: int = 0
    # last probe stats [n_allowed, max n_qual, survivors, n_seeds]
    last_stats: Optional[np.ndarray] = None
    # fallen-back probe batches by the cap their `of` came from
    # (overflow_cap)
    fallback_caps: dict = dataclasses.field(default_factory=dict)
    # seconds by part of the planner's batches (TIMERS); the rest of
    # Corrector.plan_batch is its "plan" timer less these host parts
    timers: dict = dataclasses.field(
        default_factory=lambda: dict.fromkeys(TIMERS, 0.0))

    @staticmethod
    def _qcap(L: int) -> int:
        # bounds each (kind, side)'s half-filter-qualifying positions; the
        # reference's measured sizing (ratatosk_tpu/ops/plan_device.py)
        return min(L // 12 + 4096, L)

    @staticmethod
    def build(cdbg, device, impl: str = "auto") -> Optional["DevicePlanner"]:
        # the packed placement identity ((row*3+kind)<<1)|fw and the
        # rowflag word (row<<1)|fw are int32: past ~3.5e8 keys they
        # overflow while the host planner (int64 rows) stays correct —
        # serve such indexes from the host
        if 6 * int(cdbg.index.n) + 5 >= 2 ** 31:
            return None
        device = torch.device(device)
        hx = HX.HashKmerIndex.build(cdbg.index, device)
        pf_tbl, pf_bits = HX.make_prefilter_bitmap(cdbg.index, device)
        hf_tbl, hf_bits = HX.make_half_bitmap(cdbg.index, (cdbg.k - 1) // 2,
                                              device)
        return DevicePlanner(
            k=cdbg.k, device=device, hx=hx, pf_tbl=pf_tbl, pf_bits=pf_bits,
            hf_tbl=hf_tbl, hf_bits=hf_bits,
            nk_dev=torch.from_numpy(
                np.asarray(cdbg.nkmers, np.int64)).to(device),
            uid=np.asarray(cdbg.index.unitig_id),
            upos=np.asarray(cdbg.index.pos),
            strand=np.asarray(cdbg.index.strand),
            nk=np.asarray(cdbg.nkmers), impl=impl)

    def _kernels(self):
        """(runs, probe): the plain versions, or their kernels' wrappers."""
        if self.impl == "torch":
            return _runs_kernel, _probe_kernel
        from ratatosk_tpu_torch.ops import plan_kernel as PK
        return PK.runs_kernel, PK.probe_kernel

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(self.device)

    # ---- timers ----

    def _add(self, name: str, t0: float) -> float:
        t = time.time()
        self.timers[name] += t - t0
        return t

    def _event(self):
        """A CUDA event recorded on the current stream (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _dispatched(self, what: str, t0: float, start):
        """Close a dispatch: add its host seconds; returns the (start, end)
        events around its device work (None on the CPU) for its handle."""
        evs = None
        if start is not None:
            evs = (start, self._event())
        self._add(f"{what}_dispatch", t0)
        return evs

    def _waited(self, what: str, evs) -> float:
        """Start of a collect: block until the dispatch's device work is
        done (counted in the wait), then add its device seconds."""
        t0 = time.time()
        if evs is not None:
            evs[1].synchronize()
            self.timers[f"{what}_device"] += evs[0].elapsed_time(evs[1]) / 1e3
        return t0

    # ---- warmup ----

    def warmup(self, batch_bp: int, *, stride: int, near_exact_skip: int,
               subs: bool = True, indels: bool = True) -> None:
        """Run both dispatches once at the production batch tier (the
        kernels build and load here) and pin the tier as the pad floor.
        batch_bp: the pipeline's read-batch size in bases; the tier holds
        batch_bp plus separator/overshoot slack."""
        k = self.k
        L = _pad_tier(max(int(batch_bp * 1.25), k + 2))
        self.min_tier = max(self.min_tier, L)
        codes = self._upload(np.full(L, 4, np.uint8))
        runs, probe = self._kernels()
        r = runs(codes, self.hx, self.nk_dev, k=k, rcap=max(L // 24, 1 << 12))
        p = probe(codes, self._span_arg(self._upload(np.zeros(0, np.int64)),
                                        L), self.hx, self.pf_tbl, self.hf_tbl,
                  **self.probe_options(L, stride=stride,
                                       near_exact_skip=near_exact_skip,
                                       subs=subs, indels=indels))
        del r, p
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- runs ----

    def runs_inputs(self, reads: Sequence[np.ndarray]):
        """(codes, offs, rcap) of a batch's runs dispatch: the reads
        concatenated with separators and padded to the pad tier (which it
        raises), each read's offset, the runs cap."""
        parts = []
        offs = []
        off = 0
        sep = np.full(1, 4, np.uint8)
        for r in reads:
            offs.append(off)
            parts.append(np.asarray(r, np.uint8))
            parts.append(sep)
            off += len(r) + 1
        concat = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        L = _pad_tier(max(len(concat), self.k + 1, self.min_tier))
        self.min_tier = max(self.min_tier, L)
        codes = np.full(L, 4, np.uint8)
        codes[:len(concat)] = concat
        return codes, offs, max(L // 24, 1 << 12)

    def dispatch_runs(self, reads: Sequence[np.ndarray]):
        """Queue find_runs for a whole batch on the device."""
        t0 = time.time()
        codes, offs, rcap = self.runs_inputs(reads)
        ev = self._event()
        out = self._kernels()[0](self._upload(codes), self.hx, self.nk_dev,
                                 k=self.k, rcap=rcap)
        return (out, offs, [len(r) for r in reads], rcap,
                self._dispatched("runs", t0, ev))

    def collect_runs(self, handle) -> Optional[List[list]]:
        """Blocks; returns per-read SolidRun lists (None = overflow)."""
        from ratatosk_tpu_torch.correct.seeds import SolidRun
        (sidx, eidx, uid, dirn, o, n), offs, lens, rcap, ev = handle
        t0 = self._waited("runs", ev)
        n = int(n)
        if n > rcap:
            self._add("runs_wait", t0)
            return None
        sidx = sidx[:n].cpu().numpy()
        eidx = eidx[:n].cpu().numpy()
        uid = uid[:n].cpu().numpy()
        dirn = dirn[:n].cpu().numpy()
        o = o[:n].cpu().numpy()
        t0 = self._add("runs_wait", t0)
        out: List[list] = [[] for _ in offs]
        offs_arr = np.asarray(offs, np.int64)
        ri = np.searchsorted(offs_arr, sidx, side="right") - 1
        rel_s = sidx - offs_arr[ri]
        rel_e = eidx - offs_arr[ri]
        for r_j, run in zip(ri.tolist(),
                            (SolidRun(s=s, e=e, uid=u, direction=d, o_s=oo)
                             for s, e, u, d, oo in
                             zip(rel_s.tolist(), rel_e.tolist(),
                                 uid.tolist(), dirn.tolist(), o.tolist()))):
            out[r_j].append(run)
        self._add("runs_build", t0)
        return out

    # ---- 1-edit probe ----

    def probe_inputs(self, reads, spans):
        """(codes, starts) of a batch's probe dispatch: the spans (read_idx,
        a, b) concatenated with separators and padded to the pad tier (which
        it raises), and each span's offset (int64, ascending)."""
        parts, starts = [], []
        off = 0
        sep = np.full(1, 4, np.uint8)
        for ri, a, b in spans:
            seg = np.asarray(reads[ri][a:b], np.uint8)
            starts.append(off)
            parts.append(seg)
            parts.append(sep)
            off += len(seg) + 1
        concat = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        L = _pad_tier(max(len(concat), self.k + 2, self.min_tier))
        self.min_tier = max(self.min_tier, L)
        codes = np.full(L, 4, np.uint8)
        codes[:len(concat)] = concat
        return codes, np.asarray(starts, np.int64)

    def _span_arg(self, starts, L: int):
        """The probe's span input: the starts for the kernel's wrapper, a
        start per position (span_sstart) for the plain version."""
        return span_sstart(starts, L) if self.impl == "torch" else starts

    def probe_options(self, L: int, *, stride: int, near_exact_skip: int,
                      subs: bool = True, indels: bool = True) -> dict:
        """The probe's keyword arguments at pad tier L; the caps are pure
        functions of L."""
        return dict(k=self.k, stride=stride, nes=near_exact_skip, subs=subs,
                    indels=indels and self.k <= 63, pf_bits=self.pf_bits,
                    hf_bits=self.hf_bits, qcap=self._qcap(L),
                    hcap=max(L // 8, 1 << 12))

    def dispatch_probe(self, reads, spans, *, stride: int,
                       near_exact_skip: int, subs: bool = True,
                       indels: bool = True):
        """spans: list of (read_idx, a, b). Queues the probe on the device."""
        t0 = time.time()
        codes, starts = self.probe_inputs(reads, spans)
        L = len(codes)
        kw = self.probe_options(L, stride=stride,
                                near_exact_skip=near_exact_skip, subs=subs,
                                indels=indels)
        ev = self._event()
        out = self._kernels()[1](
            self._upload(codes), self._span_arg(self._upload(starts), L),
            self.hx, self.pf_tbl, self.hf_tbl, **kw)
        return (out, starts, spans, kw, self._dispatched("probe", t0, ev))

    def collect_probe(self, handle) -> Optional[List[list]]:
        """Blocks; per-span weak SolidRun lists (None = overflow: the caller
        plans this batch on the host)."""
        from ratatosk_tpu_torch.correct.seeds import SolidRun
        (sel, ex_row, ex_fw, varid, n, of, stats), starts, spans, kw, ev \
            = handle
        t0 = self._waited("probe", ev)
        self.last_stats = stats.cpu().numpy()
        hcap = kw["hcap"]
        if bool(of) or int(n) > hcap:
            # capacity overflow: this batch falls back to the host probe
            self.n_fallback += 1
            cap = overflow_cap(self.last_stats, int(n), qcap=kw["qcap"],
                               hcap=hcap)
            self.fallback_caps[cap] = self.fallback_caps.get(cap, 0) + 1
            self._add("probe_wait", t0)
            return None
        k = self.k
        n = int(n)
        sel = sel[:n].cpu().numpy()
        ex_row = ex_row[:n].cpu().numpy()
        ex_fw = ex_fw[:n].cpu().numpy()
        varid = varid[:n].cpu().numpy()
        t0 = self._add("probe_wait", t0)
        out: List[list] = [[] for _ in spans]
        if n == 0:
            self._add("probe_build", t0)
            return out
        si = np.searchsorted(starts, sel, side="right") - 1
        rpos = sel - starts[si]
        is_ex = ex_row >= 0
        # varid packs ((row*3 + kind) << 1) | fw
        vt = np.maximum(varid, 0) >> 1
        fw = np.where(is_ex, ex_fw, varid & 1).astype(bool)
        rsp_code = np.where(is_ex, _SUB, vt % 3)
        row = np.where(is_ex, ex_row, vt // 3)
        rsp = np.where(is_ex, k,
                       np.where(rsp_code == _DEL, k + 1,
                                np.where(rsp_code == _INS, k - 1, k))
                       ).astype(np.int32)
        uid = self.uid[row].astype(np.int64)
        direction = np.where(fw == self.strand[row], 0, 1)
        o = np.where(direction == 0, self.upos[row],
                     self.nk[uid] - 1 - self.upos[row])
        span_a = [sp[1] for sp in spans]
        for s_i, p, u, d, oo, rs in zip(si.tolist(), rpos.tolist(),
                                        uid.tolist(), direction.tolist(),
                                        o.tolist(), rsp.tolist()):
            a = span_a[s_i]
            out[s_i].append(SolidRun(s=a + p, e=a + p, uid=u, direction=d,
                                     o_s=oo, weak=True, rspan=rs))
        self._add("probe_build", t0)
        return out
