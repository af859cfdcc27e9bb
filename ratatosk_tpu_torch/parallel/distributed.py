"""Multi-host distribution: the Nextflow scatter/gather layer on
torch.distributed.

Counterpart of ratatosk_tpu/parallel/distributed.py. The reference scales
across nodes by splitting the long-read FASTQ into ~50 chunks, replicating
the index to every node, correcting chunks independently, and concatenating
outputs (Ratatosk_nf/Ratatosk.nf:5-59,139-164,232-248; SURVEY.md §2.4). Here
every process (host) holds a replica of the colored cDBG, corrects its
contiguous shard of the input reads, writes `<out>.part<pid>.fastq`, and
host 0 concatenates.

The process group runs the gloo backend on CPU tensors. Every payload here
is host bytes or host integers (corrected FASTQ shards, statistics,
barriers); no device tensor crosses processes, and each process drives its
own devices through a local mesh (pipeline.local_mesh). gloo also lets two
processes share one GPU, which NCCL does not.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ratatosk_tpu_torch.correct import plan_pool as PP

# gloo's default timeout (30 min) is shorter than host 0's index build at
# genome scale, which every other host waits for at a barrier
TIMEOUT = datetime.timedelta(hours=12)


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> Tuple[int, int]:
    """Join the gloo process group from args or RATATOSK_* env vars
    (coordinator as host:port).

    Returns (process_id, num_processes). A no-op for one process; a group
    that is already live is trusted (its size must match)."""
    coordinator = coordinator or os.environ.get("RATATOSK_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("RATATOSK_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RATATOSK_PROCESS_ID", "0"))
    if num_processes > 1:
        if dist.is_initialized():
            if dist.get_world_size() != num_processes:
                raise RuntimeError(
                    f"live process group has {dist.get_world_size()} "
                    f"processes, {num_processes} requested")
            process_id = dist.get_rank()
        else:
            if not coordinator:
                raise ValueError("several processes need a coordinator "
                                 "(host:port)")
            dist.init_process_group(
                backend="gloo", init_method=f"tcp://{coordinator}",
                world_size=num_processes, rank=process_id, timeout=TIMEOUT)
    return process_id, num_processes


def shard_records(n_records: int, process_id: int, num_processes: int
                  ) -> Tuple[int, int]:
    """Contiguous [start, end) record shard for this host (chunk-scatter)."""
    per = (n_records + num_processes - 1) // num_processes
    start = min(process_id * per, n_records)
    return start, min(start + per, n_records)


def part_path(prefix: str, process_id: int) -> str:
    return f"{prefix}.part{process_id}.fastq"


def merge_parts(prefix: str, num_processes: int, final_path: str,
                parts: Optional[List[str]] = None) -> None:
    """Host-0 gather: concatenate per-host outputs in process order
    (the reference's `cat` merge, Ratatosk.nf:232-248). A `.gz` final path
    compresses while merging (-G)."""
    paths = parts or [part_path(prefix, pid) for pid in range(num_processes)]
    if final_path.endswith(".gz"):
        import gzip
        out = gzip.open(final_path, "wb")
    else:
        out = open(final_path, "wb")
    with out:
        for p in paths:
            with open(p, "rb") as f:
                while True:
                    buf = f.read(1 << 20)
                    if not buf:
                        break
                    out.write(buf)
            os.remove(p)
            if os.path.exists(p + ".done"):
                os.remove(p + ".done")


def allgather_bytes(buf: bytes, max_total: int = 1 << 31):
    """All-gather one byte payload per host (process order). Returns the
    list of payloads, or None when the gathered total would exceed
    max_total (callers fall back to the shared filesystem). The transport
    of the pass-1 -> pass-2 corrected-read hand-off (SURVEY.md §5: the
    reference ships `.2.fastq` through the filesystem,
    Ratatosk.cpp:1189-1194)."""
    n = _world()
    if n == 1:
        lens = [len(buf)]
    else:
        mine = torch.tensor([len(buf)], dtype=torch.int64)
        got = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
        dist.all_gather(got, mine)
        lens = [int(t) for t in got]
    if max(lens) * n > max_total:
        return None
    if n == 1:
        return [bytes(buf)]
    L = max(max(lens), 1)
    arr = torch.zeros(L, dtype=torch.uint8)
    arr[:len(buf)] = torch.from_numpy(np.frombuffer(buf, np.uint8).copy())
    out = [torch.empty(L, dtype=torch.uint8) for _ in range(n)]
    dist.all_gather(out, arr)
    return [out[i][:lens[i]].numpy().tobytes() for i in range(n)]


def allreduce_stats(stats: dict) -> dict:
    """Sum integer stats across hosts (one all-reduce, which also serves as
    the end-of-shard barrier)."""
    if _world() == 1:
        return dict(stats)
    keys = sorted(stats)
    t = torch.tensor([stats[k] for k in keys], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return {k: int(v) for k, v in zip(keys, t.tolist())}


def barrier() -> None:
    """Cross-host sync point."""
    if _world() > 1:
        dist.barrier()


def _correct_with_retry(opt, fn, part: str) -> None:
    """Per-shard retry + checkpointed resume (the Nextflow maxRetries /
    resume analog, Ratatosk_nf/nextflow.config:63-82): a completed shard
    leaves a `.done` marker and is skipped on restart; a failing shard is
    retried up to opt.shard_retries times before the error propagates."""
    marker = part + ".done"
    if os.path.exists(marker) and os.path.exists(part):
        return
    attempts = max(int(getattr(opt, "shard_retries", 1)), 0) + 1
    for attempt in range(attempts):
        try:
            fn()
            with open(marker, "w") as f:
                f.write("ok\n")
            return
        except Exception:
            if attempt + 1 >= attempts:
                raise


def _write_shard(recs, a: int, b: int, path: str) -> None:
    with open(path, "w") as f:
        for r in recs[a:b]:
            qual = (r.qual.tobytes().decode("ascii") if r.qual is not None
                    else "!" * len(r.codes))
            f.write(f"@{r.name}\n{r.seq}\n+\n{qual}\n")


def run_distributed_correct(opt, coordinator=None, num_processes=None,
                            process_id=None, *, device) -> None:
    """Full two-pass pipeline across hosts, bit-identical to single-host.

    Matches the Nextflow contract (Ratatosk_nf/Ratatosk.nf):
    - each index is built ONCE and persisted as the `.npz` artifact; other
      hosts load it from the shared filesystem (Ratatosk.nf:106-137 builds
      the index once and ships it to every correction job);
    - pass 1 corrects per-host shards, then host 0 concatenates ONE global
      `<out>.2.fastq` in input order (Ratatosk.nf:139-164);
    - the pass-2 graph is colored by ALL hosts' pass-1 output
      (Ratatosk.nf:166-192), so results match the single-host run exactly;
    - pass 2 corrects shards of the global pass-1 output; host 0 concatenates
      the final FASTQ (Ratatosk.nf:232-248).
    Each host corrects on `device`, or on its local mesh (`--devices`).
    Sync points are gloo collectives instead of a workflow engine.
    """
    from ratatosk_tpu_torch import pipeline
    from ratatosk_tpu_torch.correct.engine import Corrector
    from ratatosk_tpu_torch.graph import io as GIO
    from ratatosk_tpu_torch.io import fastx

    pid, n = init_distributed(coordinator, num_processes, process_id)
    if n == 1:
        pipeline.run_correct(opt, device=device)
        return
    opt.validate()
    prefix = opt.prefix_filename_out
    final_out = f"{prefix}.fastq" + (".gz" if opt.gzip_out else "")

    def load_shorts():
        shorts, ids, names = pipeline.load_short_reads(opt)
        pipeline.rescue_unmapped(opt, shorts, ids, names)
        return shorts, ids, names

    shorts = ids = names = None
    hap = None
    if opt.filename_phase_short or opt.filename_phase_long:
        # phasing needs the short-read name->color binding on every host
        # (each reference correction job reloads the phasing TSVs too)
        shorts, ids, names = load_shorts()
        hap = pipeline.load_hap(opt, ids, names)

    # distributed construction shards counting by key range and coloring by
    # read shard over ALL hosts (parallel/build_dist.py); the auto-subsample
    # and disk-spill color modes keep the single-host builder on host 0
    dist_build = not (opt.auto_subsample or opt.spill_bytes)
    workdir = os.path.dirname(os.path.abspath(prefix)) or "."
    cdbg2_pre = None

    if not opt.pass2_only:
        # ---- pass-1 index: every host participates in construction ----
        idx1 = opt.filename_graph_in or GIO.index_path(prefix, opt.small_k)
        if not opt.filename_graph_in and dist_build:
            from ratatosk_tpu_torch.graph.rescue_edges import \
                rescue_pass1_edges
            from ratatosk_tpu_torch.parallel import build_dist as BD
            if shorts is None:
                shorts, ids, names = load_shorts()
            cdbg = BD.build_cdbg_dist(shorts, opt.small_k, pid, n, workdir,
                                      min_count=opt.min_count_kmer,
                                      barrier=barrier, tag="k1")
            colors = BD.color_graph_dist(
                cdbg, shorts, pid, n, workdir, read_ids=ids,
                cap=opt.max_cov_vertices, min_cov_edge=opt.min_cov_vertices,
                sampling_rate=opt.sampling_rate, barrier=barrier, tag="c1")
            # pass-1 edge rescue needs the k2 graph — distributed count too,
            # and pass 2 reuses it (pipeline.rescue_edges_pass1 contract)
            cdbg2_pre = BD.build_cdbg_dist(shorts, opt.k, pid, n, workdir,
                                           min_count=opt.min_count_kmer,
                                           barrier=barrier, tag="k2")
            rescue_pass1_edges(cdbg, colors, cdbg2_pre,
                               min_cov=opt.min_cov_vertices)
            if pid == 0:
                GIO.save_index(idx1, cdbg, colors)
            barrier()
        else:
            if not opt.filename_graph_in and pid == 0:
                if shorts is None:
                    shorts, ids, names = load_shorts()
                cdbg, colors = pipeline.build_pass1_index(opt, shorts, ids)
                pipeline.rescue_edges_pass1(opt, cdbg, colors, shorts)
                GIO.save_index(idx1, cdbg, colors)
            barrier()
            if opt.filename_graph_in or pid != 0:
                cdbg, colors = GIO.load_index(idx1)
        o1 = pipeline._pass_opt(opt, 1)
        # each host also fans out over its own local devices (the
        # reference's per-node 32-way pool inside each SLURM job)
        corr = Corrector(cdbg, colors, o1, hap=hap,
                         snps=pipeline._detect_snps(opt, cdbg, colors),
                         mesh=pipeline.local_mesh(opt, device), device=device)
        recs = list(fastx.read_many(
            pipeline._expand_file_lists(opt.filename_long_in)))
        a, b = shard_records(len(recs), pid, n)
        shard1 = f"{prefix}.shard{pid}.p1.fastq"
        _write_shard(recs, a, b, shard1)
        del recs
        part1 = f"{prefix}.p1part{pid}.fastq"
        _correct_with_retry(
            opt,
            lambda: pipeline.correct_file(
                corr, o1, [shard1], part1, 1,
                trim_qual=opt.trim_qual if opt.pass1_only else 0),
            part1)
        os.remove(shard1)
        PP.close(corr.planner)
        del corr, cdbg, colors
        # pass-1 -> pass-2 hand-off rides a collective instead of the
        # reference's shared-filesystem `.2.fastq` round trip (SURVEY §5):
        # every host all-gathers the corrected shards and continues from its
        # own copy; the global `.2.fastq` artifact is still written by host 0
        # for the file contract. Oversized payloads fall back to the
        # filesystem path (allgather_bytes -> None).
        gathered = None
        if not opt.pass1_only:
            with open(part1, "rb") as f:
                gathered = allgather_bytes(f.read())
        barrier()
        pass1_global = final_out if opt.pass1_only else f"{prefix}.2.fastq"
        if pid == 0:
            merge_parts(prefix, n, pass1_global,
                        parts=[f"{prefix}.p1part{q}.fastq" for q in range(n)])
        barrier()
        if opt.pass1_only:
            return
        if gathered is not None:
            p1_local = f"{prefix}.p1local{pid}.fastq"
            with open(p1_local, "wb") as f:
                for part in gathered:
                    f.write(part)
            del gathered
            pass2_in = [p1_local]
        else:
            p1_local = None
            pass2_in = [pass1_global]
    else:
        p1_local = None
        pass2_in = list(opt.filename_long_in)

    # ---- pass-2 index from the GLOBAL pass-1 output ----
    use_prebuilt2 = bool(opt.pass2_only and opt.filename_graph_in)
    idx2 = opt.filename_graph_in if use_prebuilt2 \
        else GIO.index_path(prefix, opt.k)
    if not use_prebuilt2 and dist_build:
        from ratatosk_tpu_torch.parallel import build_dist as BD
        if shorts is None:
            shorts, ids, names = load_shorts()
        if cdbg2_pre is not None:
            cdbg2 = cdbg2_pre
        else:
            cdbg2 = BD.build_cdbg_dist(shorts, opt.k, pid, n, workdir,
                                       min_count=opt.min_count_kmer,
                                       barrier=barrier, tag="k2")
        # color reads exactly as build_pass2_index: pass-1 corrected reads
        # >= min_len_2nd_pass (low-confidence bases masked), then helper LRs
        color_reads = []
        min_q = 33 + int(opt.min_confidence_2nd_pass * opt.max_qual)
        for rec in fastx.read_many(pipeline._expand_file_lists(pass2_in)):
            if len(rec.codes) < opt.min_len_2nd_pass:
                continue
            masked = rec.codes.copy()
            if rec.qual is not None and opt.min_confidence_2nd_pass > 0:
                masked[rec.qual < min_q] = 4
            color_reads.append(masked)
        for p in pipeline._expand_file_lists(opt.filename_helper_long_in):
            for rec in fastx.read_fastx(p):
                color_reads.append(rec.codes)
        colors2 = BD.color_graph_dist(
            cdbg2, color_reads, pid, n, workdir,
            cap=opt.max_cov_vertices, min_cov_edge=opt.min_cov_vertices,
            barrier=barrier, tag="c2")
        if pid == 0:
            GIO.save_index(idx2, cdbg2, colors2)
        barrier()
    else:
        if not use_prebuilt2 and pid == 0:
            if shorts is None:
                shorts, ids, names = load_shorts()
            corrected = ((rec.codes, rec.qual) for rec in fastx.read_many(
                pipeline._expand_file_lists(pass2_in)))
            cdbg2, colors2 = pipeline.build_pass2_index(opt, corrected,
                                                        shorts, ids)
            GIO.save_index(idx2, cdbg2, colors2)
        barrier()
        if use_prebuilt2 or pid != 0:
            cdbg2, colors2 = GIO.load_index(idx2)
    o2 = pipeline._pass_opt(opt, 2)
    corr2 = Corrector(cdbg2, colors2, o2, hap=hap,
                      snps=pipeline._detect_snps(opt, cdbg2, colors2),
                      mesh=pipeline.local_mesh(opt, device), device=device)
    raw_reads = None
    if opt.filenames_long_raw:
        raw_reads = {rec.name: rec.codes for rec in fastx.read_many(
            pipeline._expand_file_lists(opt.filenames_long_raw))}
    recs2 = list(fastx.read_many(pipeline._expand_file_lists(pass2_in)))
    a, b = shard_records(len(recs2), pid, n)
    shard2 = f"{prefix}.shard{pid}.p2.fastq"
    _write_shard(recs2, a, b, shard2)
    del recs2
    part2 = part_path(prefix, pid)
    _correct_with_retry(
        opt,
        lambda: pipeline.correct_file(corr2, o2, [shard2], part2, 2,
                                      trim_qual=opt.trim_qual,
                                      raw_reads=raw_reads),
        part2)
    PP.close(corr2.planner)
    os.remove(shard2)
    if p1_local is not None:
        os.remove(p1_local)
    barrier()
    if pid == 0:
        merge_parts(prefix, n, final_out)
    barrier()
