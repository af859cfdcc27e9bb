"""Two-pass correction pipeline (port of ratatosk_tpu/pipeline.py).

Pass 1: colored cDBG at k1=31 from short reads -> correct long reads ->
        `<out>.2.fastq`.
Pass 2: cDBG at k2=63 from short reads, colored by pass-1 corrected reads
        (>= min_len_2nd_pass bp, low-confidence bases masked to N —
        Graph.cpp:1806-1814) -> correct pass-1 output -> `<out>.fastq`.

The port covers the entry points the main path calls: `load_short_reads`,
`build_pass1_index`, `build_pass2_index`, `correct_file` and `_pass_opt`,
with a Corrector built on an explicit device. `run_correct` (whose default
run adds the pass-1 edge rescue and SNP detection), `-L` rephasing and the
index I/O are not ported yet.
"""

from __future__ import annotations

import sys
import time
from typing import Iterable, List, Optional, Tuple

import numpy as np

from ratatosk_tpu_torch import dna
from ratatosk_tpu_torch.config import CorrectOpt
from ratatosk_tpu_torch.correct.engine import Corrector
from ratatosk_tpu_torch.graph import build as B
from ratatosk_tpu_torch.graph.colors import color_graph
from ratatosk_tpu_torch.io import fastx
from ratatosk_tpu_torch import trace as TR


def _log(opt: CorrectOpt, msg: str) -> None:
    if opt.verbose:
        print(f"[ratatosk_tpu_torch] {msg}", file=sys.stderr, flush=True)


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
    return cdbg, colors


def build_pass2_index(opt: CorrectOpt,
                      corrected: Iterable[Tuple[np.ndarray, np.ndarray]],
                      short_reads: Optional[list] = None,
                      read_ids: Optional[list] = None,
                      prebuilt_cdbg=None):
    """Pass-2 graph from short reads at k2; colors from corrected/helper LRs.

    corrected: (codes, qual) pairs from pass 1. Bases below the pass-2
    confidence threshold are masked to N before coloring (Graph.cpp:1806-1814);
    reads shorter than min_len_2nd_pass are skipped. prebuilt_cdbg reuses a
    k2 graph built already.
    """
    if short_reads is None:
        short_reads, read_ids, _ = load_short_reads(opt)
    k = opt.k
    if prebuilt_cdbg is not None:
        cdbg = prebuilt_cdbg
    else:
        _log(opt, f"pass 2: building cDBG k={k}")
        cdbg = B.build_cdbg(short_reads, k, min_count=opt.min_count_kmer)
    _log(opt, f"pass 2: {cdbg.n_unitigs} unitigs, {cdbg.index.n} k-mers")
    color_reads: List[np.ndarray] = []
    min_q = 33 + int(opt.min_confidence_2nd_pass * opt.max_qual)
    for codes, qual in corrected:
        if len(codes) < opt.min_len_2nd_pass:
            continue
        masked = codes.copy()
        if qual is not None and opt.min_confidence_2nd_pass > 0:
            masked[qual < min_q] = 4
        color_reads.append(masked)
    for p in _expand_file_lists(opt.filename_helper_long_in):
        for rec in fastx.read_fastx(p):
            color_reads.append(rec.codes)
    _log(opt, f"pass 2: coloring with {len(color_reads)} long reads")
    colors = color_graph(cdbg, color_reads,
                         cap=opt.max_cov_vertices,
                         min_cov_edge=opt.min_cov_vertices,
                         spill_bytes=opt.spill_bytes)
    return cdbg, colors


def correct_file(corrector: Corrector, opt: CorrectOpt, in_paths: List[str],
                 out_path: str, pass_no: int,
                 trim_qual: int = 0,
                 raw_reads: Optional[dict] = None) -> Tuple[int, int]:
    """Stream long reads in ~read_batch_bp batches through the corrector.

    raw_reads (`-L` rephasing against raw mates) is not ported yet.
    """
    if raw_reads is not None:
        raise NotImplementedError(
            "-L rephasing (graph/rephase.py) is not ported to "
            "ratatosk_tpu_torch yet; use the JAX package")
    n_reads = n_bases = 0
    writer = fastx.FastqWriter(out_path, trim_qual=trim_qual, min_len=opt.k)
    tracer = TR.make(opt.trace_json)
    t_pass0 = time.time()

    def batches():
        batch_reads: List[np.ndarray] = []
        batch_quals: List[Optional[np.ndarray]] = []
        batch_names: List[str] = []
        bp = 0
        for rec in fastx.read_many(_expand_file_lists(in_paths)):
            batch_reads.append(rec.codes)
            batch_quals.append(rec.qual)
            batch_names.append(rec.name)
            bp += len(rec.codes)
            if bp >= opt.read_batch_bp:
                yield batch_reads, batch_quals, batch_names
                batch_reads, batch_quals, batch_names, bp = [], [], [], 0
        if batch_reads:
            yield batch_reads, batch_quals, batch_names

    def emit(names, results):
        nonlocal n_reads, n_bases
        nb = 0
        for name, cr in zip(names, results):
            if opt.fix_snps and pass_no == 2:
                corrector.resolve_iupac(cr)   # fixSNPs, Alignment.cpp:846-965
            writer.write(name, cr.codes, cr.qual, cr.iupac)
            n_reads += 1
            nb += len(cr.codes)
        n_bases += nb
        tracer.event("batch", pass_no=pass_no, reads=len(names), bases=nb,
                     plan_s=round(corrector.timers["plan"], 3),
                     launch_s=round(corrector.timers["launch"], 3),
                     finish_s=round(corrector.timers["finish"], 3))

    def plan(batch):
        reads, quals_b, names = batch
        quals = quals_b if any(q is not None for q in quals_b) else None
        return (names, quals,
                corrector.plan_batch(reads, quals, names))

    if opt.nb_threads > 1:
        # double-buffer (the reference's worker-pool streaming loop,
        # Ratatosk.cpp:618-909): a worker thread plans batch N+1 while this
        # thread drives the device for batch N — numpy planning and the
        # device waits both release the GIL
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = None
            for batch in batches():
                nxt = pool.submit(plan, batch)
                if fut is not None:
                    names, quals, (reads_np, plans, regions) = fut.result()
                    corrector._execute_regions(regions)
                    emit(names, corrector.assemble_batch(reads_np, quals,
                                                         plans, regions))
                fut = nxt
            if fut is not None:
                names, quals, (reads_np, plans, regions) = fut.result()
                corrector._execute_regions(regions)
                emit(names, corrector.assemble_batch(reads_np, quals,
                                                     plans, regions))
    else:
        for batch in batches():
            names, quals, (reads_np, plans, regions) = plan(batch)
            corrector._execute_regions(regions)
            emit(names, corrector.assemble_batch(reads_np, quals, plans,
                                                 regions))
    writer.close()
    tracer.event("pass_done", pass_no=pass_no, reads=n_reads, bases=n_bases,
                 secs=round(time.time() - t_pass0, 3))
    tracer.close()
    return n_reads, n_bases


def run_correct(opt: CorrectOpt) -> None:
    """The CLI's full run. Not ported yet: its default run also rescues
    low-coverage pass-1 edges from the k2 graph and detects SNP candidates,
    which the port does not have."""
    raise NotImplementedError(
        "run_correct (and the CLI) is not ported to ratatosk_tpu_torch yet: "
        "drive the passes with build_pass1_index, Corrector, correct_file and "
        "build_pass2_index, or use the JAX package")


def _pass_opt(opt: CorrectOpt, pass_no: int) -> CorrectOpt:
    """Per-pass view: pass 2 corrects longer weak regions (Common.hpp:131-132)."""
    import dataclasses as _dc
    o = _dc.replace(opt)
    if pass_no == 2:
        o.max_len_weak_region1 = opt.max_len_weak_region2
        o.skip_max_quality_regions = True
    return o
