"""Two-pass correction pipeline (port of ratatosk_tpu/pipeline.py).

Pass 1: colored cDBG at k1=31 from short reads -> correct long reads ->
        `<out>.2.fastq`.
Pass 2: cDBG at k2=63 from short reads, colored by helper long reads (-a) and
        pass-1 corrected reads (>= min_len_2nd_pass bp, low-confidence bases
        masked to N — Graph.cpp:1806-1814) -> correct pass-1 output ->
        `<out>.fastq[.gz]`.
`index` stops after construction and persists `<prefix>.index.k<k>.npz`
(graph/io.py), the 4-step contract the Nextflow layer ships between nodes.

The host steps are the reference's code. Every Corrector runs on the device
the caller names (`run_correct(opt, device=...)`), and with `--devices` > 1
on a mesh over that many CUDA devices (`local_mesh`).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import sys
import time
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from ratatosk_tpu_torch import dna
from ratatosk_tpu_torch.config import CorrectOpt
from ratatosk_tpu_torch.correct import plan_pool as PP
from ratatosk_tpu_torch.correct.engine import Corrector
from ratatosk_tpu_torch.graph import build as B
from ratatosk_tpu_torch.graph import io as GIO
from ratatosk_tpu_torch.graph.colors import color_graph
from ratatosk_tpu_torch.io import fastx
from ratatosk_tpu_torch import trace as TR

# batches a pass with --trace-json writes at a time: the events and spans
# of its finished batches, so the recorder holds at most this many
TRACE_EVERY = 64


def _log(opt: CorrectOpt, msg: str) -> None:
    if opt.verbose:
        print(f"[ratatosk_tpu_torch] {msg}", file=sys.stderr, flush=True)


def local_mesh(opt: CorrectOpt, device):
    """Mesh over this process's devices, or None when one is in play.

    `--devices 1` runs on `device` alone; `--devices N` > 1 on a mesh over
    cuda:0..N-1, and raises when fewer devices of that kind are visible (no
    device is quietly dropped); `--devices 0` on every visible CUDA device
    (None when only one is). Every Corrector built by the pipeline splits
    its region batches over the mesh, the per-node fan-out of the
    reference's worker pool (Ratatosk_nf/Ratatosk.nf:139-164). A CUDA
    device that torch cannot see raises; nothing moves to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested, but torch sees no "
                           "CUDA device")
    if opt.n_devices == 1:
        return None
    visible = torch.cuda.device_count() if device.type == "cuda" else 1
    n = opt.n_devices or visible
    if n > visible:
        raise RuntimeError(f"--devices {n} requested, but {visible} "
                           f"{device.type} device(s) are visible")
    if n <= 1:
        return None
    from ratatosk_tpu_torch.parallel import mesh as M
    _log(opt, f"mesh: splitting region batches over {n} CUDA devices")
    return M.make_mesh(devices=[torch.device("cuda", i) for i in range(n)])


def _expand_file_lists(paths: List[str]) -> List[str]:
    """A non-FASTA/FASTQ input is a list file: one path per line
    (reference Common.cpp:396-493 check_files indirection)."""
    out = []
    for p in paths:
        try:
            fastx.sniff_format(p)
            out.append(p)
        except (ValueError, UnicodeDecodeError):
            with open(p) as f:
                out.extend(line.strip() for line in f if line.strip())
    return out


def load_short_reads(opt: CorrectOpt):
    """Short reads + color ids + names.

    Mates share a name => share one color id (reference: paired reads must
    share names, Ratatosk.cpp usage header). Duplicate reads (same sequence or
    its reverse complement) share one color id — the signature-based
    deduplication of addCoverage phase 2 (Graph.cpp:2089-2136).
    """
    reads, ids, names = [], [], []
    name_to_id: dict = {}
    sig_to_id: dict = {}
    next_id = 0
    for rec in fastx.read_many(_expand_file_lists(opt.filename_seq_in)):
        fw = rec.codes.tobytes()
        sig = min(fw, dna.revcomp_codes(rec.codes).tobytes())
        if rec.name in name_to_id:
            cid = name_to_id[rec.name]
        elif sig in sig_to_id:
            cid = sig_to_id[sig]
            name_to_id[rec.name] = cid
        else:
            cid = next_id
            next_id += 1
            name_to_id[rec.name] = cid
            sig_to_id[sig] = cid
        reads.append(rec.codes)
        ids.append(cid)
        names.append(rec.name)
    return reads, ids, names


def rescue_unmapped(opt: CorrectOpt, short_reads, read_ids, read_names) -> int:
    """Append `-u` reads whose loci exist in the long reads but not in the
    mapped short reads (retrieveMissingReads, Graph.cpp:3857-4131;
    Ratatosk.cpp:1040-1056). Returns how many reads were rescued."""
    paths = _expand_file_lists(opt.filename_unmapped_in)
    if not paths:
        return 0
    from ratatosk_tpu_torch.graph import rescue as RS
    unmapped = list(fastx.read_many(paths))
    lrs = (rec.codes for rec in
           fastx.read_many(_expand_file_lists(opt.filename_long_in)))
    idx = RS.find_missing_reads(
        short_reads, lrs, [u.codes for u in unmapped],
        k=opt.small_k, min_nb_km_unmapped=opt.min_nb_km_unmapped)
    next_id = (max(read_ids) + 1) if read_ids else 0
    name_to_id = {}
    for j in idx:
        rec = unmapped[j]
        cid = name_to_id.setdefault(rec.name, next_id + len(name_to_id))
        short_reads.append(rec.codes)
        read_ids.append(cid)
        read_names.append(rec.name)
    _log(opt, f"rescued {len(idx)} unmapped short reads (-u)")
    return len(idx)


def load_hap(opt: CorrectOpt, read_ids, read_names):
    """HapReads from -p/-P phasing TSVs, bound to short-read color ids."""
    paths = _expand_file_lists(list(opt.filename_phase_short)
                               + list(opt.filename_phase_long))
    if not paths:
        return None
    from ratatosk_tpu_torch.graph import phasing as PH
    hap = PH.load_phasing(paths)
    if read_ids is not None and read_names is not None:
        PH.bind_colors(hap, read_names, read_ids)
    return hap


def load_graph_input(opt: CorrectOpt, path: str, k: int,
                     short_reads=None, read_ids=None):
    """Load a -g graph argument: our `.npz` bundle, or a reference-written
    unitig `.fasta.gz` (graph/interop.py). A FASTA carries no colors — they
    are rebuilt from the short reads, reference ref-input semantics."""
    from ratatosk_tpu_torch.graph import interop as IT
    kind = IT.sniff_graph_file(path)
    if kind != "fasta":
        return GIO.load_index(path)
    _log(opt, f"importing reference unitig FASTA graph {path} (k={k})")
    cdbg = IT.import_unitigs_fasta(path, k)
    if short_reads is None:
        short_reads, read_ids, _ = load_short_reads(opt)
    colors = color_graph(cdbg, short_reads, read_ids=read_ids,
                         cap=opt.max_cov_vertices,
                         min_cov_edge=opt.min_cov_vertices,
                         sampling_rate=opt.sampling_rate,
                         spill_bytes=opt.spill_bytes)
    return cdbg, colors


def build_pass1_index(opt: CorrectOpt,
                      short_reads: Optional[list] = None,
                      read_ids: Optional[list] = None):
    if short_reads is None:
        short_reads, read_ids, _ = load_short_reads(opt)
    k = opt.small_k
    _log(opt, f"pass 1: building cDBG k={k} from {len(short_reads)} short reads")
    t0 = time.time()
    cdbg = B.build_cdbg(short_reads, k, min_count=opt.min_count_kmer)
    _log(opt, f"pass 1: {cdbg.n_unitigs} unitigs, {cdbg.index.n} k-mers "
              f"({time.time() - t0:.1f}s)")
    colors = color_graph(cdbg, short_reads, read_ids=read_ids,
                         cap=opt.max_cov_vertices,
                         min_cov_edge=opt.min_cov_vertices,
                         sampling_rate=opt.sampling_rate,
                         auto_subsample=opt.auto_subsample,
                         spill_bytes=opt.spill_bytes)
    _graph_build_event(opt, 1, cdbg, t0)
    return cdbg, colors


def rescue_edges_pass1(opt: CorrectOpt, cdbg, colors,
                       short_reads: list):
    """Pass-1 low-coverage edge rescue from the k2 graph (addCoverage phase
    7, Graph.cpp:3085-3363): builds the UNCOLORED k2 cDBG from the short
    reads, adds pseudo-read support to k1 edges that are consecutive inside
    a k2 unitig, and returns the k2 cdbg so pass 2 can reuse it."""
    from ratatosk_tpu_torch.graph.rescue_edges import rescue_pass1_edges
    t0 = time.time()
    cdbg2 = B.build_cdbg(short_reads, opt.k, min_count=opt.min_count_kmer)
    n = rescue_pass1_edges(cdbg, colors, cdbg2,
                           min_cov=opt.min_cov_vertices)
    _log(opt, f"pass 1: rescued {n} low-coverage edges from the k{opt.k} "
              f"graph ({time.time() - t0:.1f}s)")
    TR.make(opt.trace_json).event("rescue", edges=n,
                                  secs=round(time.time() - t0, 3))
    return cdbg2


def build_pass2_index(opt: CorrectOpt,
                      corrected: Iterable[Tuple[np.ndarray, np.ndarray]],
                      short_reads: Optional[list] = None,
                      read_ids: Optional[list] = None,
                      prebuilt_cdbg=None):
    """Pass-2 graph from short reads at k2; colors from corrected/helper LRs.

    corrected: (codes, qual) pairs from pass 1. Bases below the pass-2
    confidence threshold are masked to N before coloring (Graph.cpp:1806-1814);
    reads shorter than min_len_2nd_pass are skipped. prebuilt_cdbg reuses the
    k2 graph already built for pass-1 edge rescue.

    The build is one `index` span (trace.py), a tree of its own outside any
    job's, with two children: `index.graph` (the k2 graph, or its reuse) and
    `index.colour` (masking and coloring). Its fields: `k`, `reads` (reads
    colored), `short` (reads under min_len_2nd_pass, skipped) and `masked`
    (bases masked to N under min_confidence_2nd_pass).
    """
    if short_reads is None:
        short_reads, read_ids, _ = load_short_reads(opt)
    k = opt.k
    t0 = time.time()
    with TR.span("index") as span:
        with TR.span("index.graph"):
            if prebuilt_cdbg is not None:
                cdbg = prebuilt_cdbg
            else:
                _log(opt, f"pass 2: building cDBG k={k}")
                cdbg = B.build_cdbg(short_reads, k,
                                    min_count=opt.min_count_kmer)
        _log(opt, f"pass 2: {cdbg.n_unitigs} unitigs, {cdbg.index.n} k-mers")
        with TR.span("index.colour"):
            color_reads: List[np.ndarray] = []
            n_short = n_masked = 0
            min_q = 33 + int(opt.min_confidence_2nd_pass * opt.max_qual)
            for codes, qual in corrected:
                if len(codes) < opt.min_len_2nd_pass:
                    n_short += 1
                    continue
                masked = codes.copy()
                if qual is not None and opt.min_confidence_2nd_pass > 0:
                    low = qual < min_q
                    masked[low] = 4
                    if span:
                        n_masked += int(np.count_nonzero(low))
                color_reads.append(masked)
            for p in _expand_file_lists(opt.filename_helper_long_in):
                for rec in fastx.read_fastx(p):
                    color_reads.append(rec.codes)
            _log(opt, f"pass 2: coloring with {len(color_reads)} long reads")
            colors = color_graph(cdbg, color_reads,
                                 cap=opt.max_cov_vertices,
                                 min_cov_edge=opt.min_cov_vertices,
                                 spill_bytes=opt.spill_bytes)
        if span:
            for key, v in (("k", cdbg.k), ("reads", len(color_reads)),
                           ("short", n_short), ("masked", n_masked)):
                span.set(key, v)
    _graph_build_event(opt, 2, cdbg, t0)
    return cdbg, colors


def _graph_build_event(opt: CorrectOpt, pass_no: int, cdbg, t0: float
                       ) -> None:
    """The trace's graph_build event of a pass's index, built since t0."""
    TR.make(opt.trace_json).event(
        "graph_build", pass_no=pass_no, k=cdbg.k, unitigs=cdbg.n_unitigs,
        kmers=cdbg.index.n, secs=round(time.time() - t0, 3))


def correct_file(corrector: Corrector, opt: CorrectOpt, in_paths: List[str],
                 out_path: str, pass_no: int,
                 trim_qual: int = 0,
                 raw_reads: Optional[dict] = None) -> Tuple[int, int]:
    """Stream long reads in ~read_batch_bp batches through the corrector.

    raw_reads (pass 2, from -L): name -> raw codes; before correction each
    input read is rephased against its raw mate — phase-inconsistent pass-1
    segments are spliced back to raw (phasing(), Graph.cpp:869-1097,
    Ratatosk.cpp:774-836).

    The call is one `job` span (trace.py) and each batch's reading, wait,
    plan merge, launches, finishes, assembly and writing are its children,
    on this thread, and so are the batch's plans, on the planner processes
    (one a slice) or the planner thread. With
    --trace-json the pass records its spans and writes them with its batch
    events every TRACE_EVERY batches, and the rest, with pass_done, at its
    end (without pass_done when it raises).
    """
    n_reads = n_bases = 0
    n_rephased = 0
    tracer = TR.make(opt.trace_json)
    batch_events = []   # (ts, fields): seconds from the batch's spans later
    written = 0         # batches whose events and spans are written
    t_pass0 = time.time()

    def batches():
        # one `read` span a batch: parsing, rephasing and batching its reads
        nonlocal n_rephased
        recs = iter(fastx.read_many(_expand_file_lists(in_paths)))
        for b in itertools.count():
            batch_reads: List[np.ndarray] = []
            batch_quals: List[Optional[np.ndarray]] = []
            batch_names: List[str] = []
            bp = 0
            with TR.span("read", batch=b):
                for rec in recs:
                    codes, qual = rec.codes, rec.qual
                    if raw_reads is not None:
                        raw = raw_reads.get(rec.name)
                        if raw is None:
                            # the reference hard-aborts on raw/corrected
                            # pairing mismatch (Ratatosk.cpp:786-800)
                            raise SystemExit(
                                f"-L raw read missing for '{rec.name}': raw "
                                f"and corrected inputs must contain the same "
                                f"reads")
                        from ratatosk_tpu_torch.graph import rephase as RP
                        codes, qual, n = RP.rephase_read(
                            corrector.cdbg, corrector.colors, raw, codes,
                            qual, insert_sz=opt.insert_sz)
                        n_rephased += n
                    batch_reads.append(codes)
                    batch_quals.append(qual)
                    batch_names.append(rec.name)
                    bp += len(codes)
                    if bp >= opt.read_batch_bp:
                        break
            if not batch_reads:
                return
            if all(q is None for q in batch_quals):
                batch_quals = None
            yield batch_reads, batch_quals, batch_names

    def emit(b, names, results, n_regions):
        nonlocal n_reads, n_bases
        nb = 0
        with TR.span("write"):
            for name, cr in zip(names, results):
                if opt.fix_snps and pass_no == 2:
                    corrector.resolve_iupac(cr)   # fixSNPs, Alignment.cpp:846-965
                writer.write(name, cr.codes, cr.qual, cr.iupac)
                nb += len(cr.codes)
        n_reads += len(names)
        n_bases += nb
        if opt.trace_json:
            extra = {}
            if corrector.devplan is not None:
                # devplan capacity-overflow fallbacks: nonzero means batches
                # were planned on the host planner
                extra["devplan_fallbacks"] = corrector.devplan.n_fallback
            batch_events.append((time.time(), dict(
                pass_no=pass_no, batch=b, reads=len(names), bases=nb,
                regions=n_regions, **extra)))
            if (b + 1) % TRACE_EVERY == 0:
                trace_out(b + 1)

    def trace_out(hi=None, tail=()):
        # writes the batch events and spans of the batches from `written`
        # to hi - 1 (with hi None: all that are left, the job's own span
        # and `tail`); every span of those batches has closed
        nonlocal written
        spans = rec.take(job.id, written, hi)
        secs = TR.seconds_by_batch(spans, ("plan", "launch", "finish"))
        out = []
        while batch_events and (hi is None
                                or batch_events[0][1]["batch"] < hi):
            ts, fields = batch_events.pop(0)
            per = secs.get(fields["batch"], {})
            out.append(TR.record("batch", ts, **fields, **{
                f"{k}_s": round(per.get(k, 0.0), 3)
                for k in ("plan", "launch", "finish")}))
        out += tail
        out += [TR.record("span", sp.t1 / 1e9, **sp.as_dict())
                for sp in spans]
        tracer.write(out)
        written = hi

    def drive(b, ticket):
        # batch b on this thread: its plan, launches, finishes, assembly
        with TR.within(job, b):
            names, quals, (reads_np, plans, regions) = planner.collect(
                ticket, job, b, corrector.timers)
            corrector._execute_regions(regions)
            emit(b, names, corrector.assemble_batch(reads_np, quals, plans,
                                                    regions), len(regions))

    done = []   # the pass_done event, once the pass has ended
    try:
        with (TR.recording() if opt.trace_json
              else contextlib.nullcontext()) as rec, TR.span("job") as job, \
                PP.planner_for(corrector, opt) as planner:
            writer = fastx.FastqWriter(out_path, trim_qual=trim_qual,
                                       min_len=opt.k)
            # the double buffer where the planner plans ahead (Ratatosk.cpp:618-909)
            pending = collections.deque()
            for b, batch in enumerate(batches()):
                pending.append((b, planner.submit(batch, job, b)))
                if len(pending) > planner.ahead:
                    drive(*pending.popleft())
            while pending:
                drive(*pending.popleft())
            writer.close()
        done.append(TR.record("pass_done", pass_no=pass_no, reads=n_reads,
                              bases=n_bases,
                              secs=round(time.time() - t_pass0, 3)))
    finally:
        if opt.trace_json:
            trace_out(tail=done)
    if raw_reads is not None:
        _log(opt, f"pass 2: rephased {n_rephased} segments (-L)")
    return n_reads, n_bases


def run_correct(opt: CorrectOpt, *, device) -> None:
    """The CLI's `correct` run; both passes' Correctors run on `device`, or
    on the mesh of local_mesh."""
    opt.validate()
    mesh = local_mesh(opt, device)
    prefix = opt.prefix_filename_out
    pass1_out = f"{prefix}.2.fastq"
    final_out = f"{prefix}.fastq" + (".gz" if opt.gzip_out else "")
    short_reads = read_ids = read_names = None
    # a prebuilt index (-g) covers the pass it starts; a full two-pass run
    # still needs the short reads to build the other pass's graph
    need_shorts = (not opt.filename_graph_in
                   or not (opt.pass1_only or opt.pass2_only))
    if need_shorts:
        short_reads, read_ids, read_names = load_short_reads(opt)
        rescue_unmapped(opt, short_reads, read_ids, read_names)
    hap = load_hap(opt, read_ids, read_names)

    cdbg2_pre = None
    if not opt.pass2_only:
        if opt.filename_graph_in:
            cdbg, colors = load_graph_input(opt, opt.filename_graph_in,
                                            opt.small_k, short_reads,
                                            read_ids)
            _log(opt, f"pass 1: loaded index {opt.filename_graph_in}")
        else:
            cdbg, colors = build_pass1_index(opt, short_reads, read_ids)
            cdbg2_pre = rescue_edges_pass1(opt, cdbg, colors, short_reads)
        o1 = _pass_opt(opt, 1)
        corr = Corrector(cdbg, colors, o1, hap=hap,
                         snps=_detect_snps(opt, cdbg, colors), mesh=mesh,
                         device=device)
        out = pass1_out if not opt.pass1_only else final_out
        try:
            n, bp = correct_file(corr, o1, opt.filename_long_in, out, 1,
                                 trim_qual=(opt.trim_qual if opt.pass1_only
                                            else 0))
        finally:
            PP.close(corr.planner)
        _log(opt, f"pass 1: corrected {n} reads / {bp} bases -> {out}")
        if opt.pass1_only:
            return
        pass2_in = [out]
    else:
        pass2_in = opt.filename_long_in  # already pass-1-corrected input

    corrected = (
        (rec.codes, rec.qual)
        for rec in fastx.read_many(_expand_file_lists(pass2_in))
    )
    if opt.filename_graph_in and opt.pass2_only:
        cdbg2, colors2 = load_graph_input(opt, opt.filename_graph_in, opt.k,
                                          short_reads, read_ids)
    else:
        cdbg2, colors2 = build_pass2_index(opt, corrected, short_reads,
                                           read_ids, prebuilt_cdbg=cdbg2_pre)
    o2 = _pass_opt(opt, 2)
    corr2 = Corrector(cdbg2, colors2, o2, hap=hap,
                      snps=_detect_snps(opt, cdbg2, colors2), mesh=mesh,
                      device=device)
    raw_reads = None
    if opt.filenames_long_raw:
        raw_reads = {rec.name: rec.codes for rec in
                     fastx.read_many(_expand_file_lists(opt.filenames_long_raw))}
        _log(opt, f"pass 2: loaded {len(raw_reads)} raw mates (-L)")
    try:
        n, bp = correct_file(corr2, o2, pass2_in, final_out, 2,
                             trim_qual=opt.trim_qual, raw_reads=raw_reads)
    finally:
        PP.close(corr2.planner)
    _log(opt, f"pass 2: corrected {n} reads / {bp} bases -> {final_out}")


def run_index(opt: CorrectOpt) -> None:
    """The CLI's `index` run: host only."""
    opt.validate()
    prefix = opt.prefix_filename_out
    short_reads, read_ids, read_names = load_short_reads(opt)
    rescue_unmapped(opt, short_reads, read_ids, read_names)
    from ratatosk_tpu_torch.graph import interop as IT
    if opt.pass1_only or not opt.pass2_only:
        cdbg, colors = build_pass1_index(opt, short_reads, read_ids)
        rescue_edges_pass1(opt, cdbg, colors, short_reads)
        path = GIO.index_path(prefix, opt.small_k)
        GIO.save_index(path, cdbg, colors)
        _log(opt, f"wrote {path}")
        # reference-format graph artifact alongside the .npz
        # (Ratatosk.cpp:1067 naming; loadable by `Ratatosk correct -g`)
        fp = IT.fasta_index_path(prefix, opt.small_k)
        IT.export_unitigs_fasta(cdbg, fp)
        _log(opt, f"wrote {fp}")
    if opt.pass2_only:
        corrected = (
            (rec.codes, rec.qual)
            for rec in fastx.read_many(_expand_file_lists(opt.filename_long_in))
        )
        cdbg2, colors2 = build_pass2_index(opt, corrected, short_reads, read_ids)
        path = GIO.index_path(prefix, opt.k)
        GIO.save_index(path, cdbg2, colors2)
        _log(opt, f"wrote {path}")
        fp = IT.fasta_index_path(prefix, opt.k)
        IT.export_unitigs_fasta(cdbg2, fp)
        _log(opt, f"wrote {fp}")


def _detect_snps(opt: CorrectOpt, cdbg, colors):
    """SNP-candidate annotation (detectSNPs analog) unless disabled by -F."""
    if opt.no_snp_correction:
        return None
    from ratatosk_tpu_torch.graph import snp as SNP
    t0 = time.time()
    ann = SNP.detect_snps(cdbg, colors)
    _log(opt, f"SNP candidates: {ann.n_sites} annotated sites "
              f"({time.time() - t0:.1f}s)")
    TR.make(opt.trace_json).event("snp", sites=ann.n_sites,
                                  secs=round(time.time() - t0, 3))
    return ann


def _pass_opt(opt: CorrectOpt, pass_no: int) -> CorrectOpt:
    """Per-pass view: pass 2 corrects longer weak regions (Common.hpp:131-132)."""
    import dataclasses as _dc
    o = _dc.replace(opt)
    if pass_no == 2:
        o.max_len_weak_region1 = opt.max_len_weak_region2
        o.skip_max_quality_regions = True
    return o
