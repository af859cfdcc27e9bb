"""The planner processes of the double buffer (correct/plan_pool.py) on the
CPU: a batch planned in slices and merged equals the batch planned whole,
field for field, in both passes; correct_file with the pool writes the
FASTQ of one thread; a worker's failure raises from correct_file, soon;
the pool starts once per Planner and plan_pool.close ends its workers;
the configurations that plan on a thread or inline start none.

Each test runs under a time limit of its own (`limited`)."""

from __future__ import annotations

import dataclasses
import functools
import multiprocessing
import os
import signal
import time
from concurrent.futures.process import BrokenProcessPool

import numpy as np
import pytest
import torch

from ratatosk_tpu_torch import dna, pipeline
from ratatosk_tpu_torch import testing as T
from ratatosk_tpu_torch import trace as TR
from ratatosk_tpu_torch.config import CorrectOpt
from ratatosk_tpu_torch.correct import plan_pool as PP
from ratatosk_tpu_torch.correct.engine import Corrector, RegionSpec
from ratatosk_tpu_torch.correct.planner import Planner
from ratatosk_tpu_torch.graph import phasing as PH


def limited(seconds: int):
    """The test fails with TimeoutError past `seconds`."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*a, **kw):
            def expire(signum, frame):
                raise TimeoutError(f"{fn.__name__}: over {seconds} s")
            old = signal.signal(signal.SIGALRM, expire)
            signal.alarm(seconds)
            try:
                return fn(*a, **kw)
            finally:
                signal.alarm(0)
                signal.signal(signal.SIGALRM, old)
        return run
    return wrap


@pytest.fixture
def eight_cores(monkeypatch):
    """The pool's path as on an eight-core host (W = 3), whatever the cores
    here; the workers run on every core this process may use."""
    monkeypatch.setattr(PP, "usable_cores", lambda: list(range(8)))
    monkeypatch.setattr(PP, "worker_cores",
                        lambda cores: sorted(os.sched_getaffinity(0)))


def _write_fq(path, reads, quals=None):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            q = ("!" * len(r) if quals is None
                 else quals[i].tobytes().decode("ascii"))
            f.write(f"@r{i}\n{dna.decode(r)}\n+\n{q}\n")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 20 kbp genome, its short reads, ten long reads at 10% error (pass
    1's input) and ten at 1.2% with qualities (pass 2's), whose first
    halves are at the maximal quality; haplotypes for half the short reads
    and for the long reads by name."""
    tmp = tmp_path_factory.mktemp("plan_pool")
    rng = np.random.default_rng(2121)
    genome = T.random_genome(rng, 20000)
    sreads = T.short_reads(rng, genome, coverage=30.0, read_len=100)
    p1 = [n for n, _, _ in T.long_reads(rng, genome, n=10, min_len=1500,
                                        max_len=2500, err=0.10)]
    p2 = [n for n, _, _ in T.long_reads(rng, genome, n=10, min_len=1500,
                                        max_len=2500, err=0.012)]
    quals = []
    for r in p2:
        q = rng.integers(33 + 5, 33 + 30, len(r)).astype(np.uint8)
        q[:len(r) // 2] = 33 + 40
        quals.append(q)
    _write_fq(tmp / "p1.fq", p1)
    _write_fq(tmp / "p2.fq", p2, quals)
    snames = [f"s{i}" for i in range(len(sreads))]
    hap = PH.HapReads(
        read2hap={**{n: i % 2 for i, n in enumerate(snames[::2])},
                  **{f"r{i}": i % 2 for i in range(0, 10, 3)}},
        block_ids={"b": 0}, n_haps=2)
    PH.bind_colors(hap, snames, list(range(len(sreads))))
    return dict(tmp=tmp, sreads=sreads, p1=p1, p2=p2, quals=quals, hap=hap)


def _opt(pass_no):
    o = CorrectOpt(small_k=31, k=63, beam_width=8, batch_regions=32,
                   read_batch_bp=6000, nb_threads=1, weak_seed_min_gap=80)
    return pipeline._pass_opt(o, pass_no)


@pytest.fixture(scope="module")
def passes(data):
    """{pass: (Corrector, opt, reads, quals, input FASTQ)}; pass 2's graph
    (k=63) is coloured by pass 2's reads. Closed at the end."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    ids = list(range(len(data["sreads"])))
    o1, o2 = _opt(1), _opt(2)
    cdbg1, col1 = pipeline.build_pass1_index(o1, data["sreads"], ids)
    cdbg2, col2 = pipeline.build_pass2_index(
        o2, zip(data["p2"], data["quals"]), data["sreads"], ids)
    out = {
        1: (Corrector(cdbg1, col1, o1, hap=data["hap"], device="cpu"), o1,
            data["p1"], None, str(data["tmp"] / "p1.fq")),
        2: (Corrector(cdbg2, col2, o2, hap=data["hap"], device="cpu"), o2,
            data["p2"], data["quals"], str(data["tmp"] / "p2.fq")),
    }
    yield out
    for corr, *_ in out.values():
        PP.close(corr.planner)
    torch.set_num_threads(n)


def _same_region(a: RegionSpec, b: RegionSpec) -> None:
    for f in dataclasses.fields(RegionSpec):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert isinstance(x, np.ndarray) and isinstance(y, np.ndarray)
            assert x.dtype == y.dtype and np.array_equal(x, y), f.name
        else:
            assert type(x) is type(y) and x == y, f.name


def _same_seg(a, b) -> None:
    assert type(a) is type(b) and len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        else:
            assert type(x) is type(y) and x == y


@pytest.mark.parametrize("lengths, w", [
    ([4000] * 10, 3), ([100, 9000, 100, 100], 3), ([5] * 3, 8),
    ([1], 1), ([3000, 1000, 2000, 2500, 1500], 2), ([0, 0, 7], 3)])
@limited(30)
def test_split_is_contiguous_nonempty_and_even(lengths, w):
    bounds = PP.split(lengths, w)
    assert len(bounds) == min(w, len(lengths))
    assert bounds[0][0] == 0 and bounds[-1][1] == len(lengths)
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    if len(set(lengths)) == 1 and len(lengths) % w == 0:
        assert {hi - lo for lo, hi in bounds} == {len(lengths) // w}


@pytest.mark.parametrize("cores, w", [(3, 2), (4, 2), (8, 3), (9, 4),
                                      (32, 4)])
@limited(30)
def test_workers_follow_the_usable_cores(cores, w):
    assert PP.worker_count(cores) == w
    assert PP.worker_cores(list(range(cores))) == list(range(1, cores))


@pytest.mark.parametrize("missing, readable", [
    ((), True), (("smaps_rollup",), True), (("smaps_rollup", "smaps"), False)])
@limited(30)
def test_private_memory_reads_what_the_kernel_has(monkeypatch, missing,
                                                  readable):
    """From smaps_rollup, else summed over smaps; None without either."""
    def fake_open(path, *a, **kw):
        if os.path.basename(path) in missing:
            raise FileNotFoundError(path)
        return open(path, *a, **kw)
    monkeypatch.setattr(PP, "open", fake_open, raising=False)
    mb = PP.private_mb()
    assert (mb is not None and mb > 0) if readable else mb is None


@pytest.mark.parametrize("pass_no", [1, 2])
@pytest.mark.parametrize("w", [1, 2, 3, 64])
@limited(120)
def test_merged_slices_equal_the_whole_batch(passes, pass_no, w):
    corr, _, reads, quals, _ = passes[pass_no]
    names = [f"r{i}" for i in range(len(reads))]
    with TR.recording() as rec:
        whole_np, whole_plans, whole_regions = corr.plan_batch(reads, quals,
                                                               names)
    whole_maxq = rec.spans[-1].fields["maxq_bp"]
    assert whole_regions and (whole_maxq > 0) == (pass_no == 2)
    bounds = PP.split([len(r) for r in reads], w)
    assert len(bounds) == min(w, len(reads))
    parts, maxq = [], 0
    for lo, hi in bounds:
        with TR.recording() as rec:
            _, plans, regions = corr.plan_batch(
                reads[lo:hi], None if quals is None else quals[lo:hi],
                names[lo:hi])
        maxq += rec.spans[-1].fields["maxq_bp"]
        parts.append((lo, plans, regions))
    plans, regions = PP.merge(parts)
    assert maxq == whole_maxq
    assert len(regions) == len(whole_regions)
    for a, b in zip(regions, whole_regions):
        _same_region(a, b)
    assert len(plans) == len(whole_plans)
    for pa, pb in zip(plans, whole_plans):
        assert type(pa) is type(pb) and len(pa) == len(pb)
        for a, b in zip(pa, pb):
            _same_seg(a, b)


def _correct(corr, opt, src, out, pass_no, threads):
    pipeline.correct_file(corr, dataclasses.replace(opt, nb_threads=threads),
                          [src], out, pass_no)
    with open(out, "rb") as f:
        return f.read()


@pytest.mark.parametrize("pass_no", [1, 2])
@limited(240)
def test_pool_writes_the_fastq_of_one_thread(passes, data, eight_cores,
                                             pass_no):
    corr, opt, _, _, src = passes[pass_no]
    tmp = data["tmp"]
    one = _correct(corr, opt, src, str(tmp / f"one{pass_no}.fq"), pass_no, 1)
    assert corr.planner not in PP.pools
    pooled = _correct(corr, opt, src, str(tmp / f"pool{pass_no}.fq"),
                      pass_no, 2)
    assert PP.pools[corr.planner].workers == 3
    assert one and pooled == one


@pytest.fixture
def fresh(passes, data, eight_cores):
    """A pass-1 Corrector of its own, closed after the test, and a job
    with two reads a batch."""
    corr0, opt, _, _, src = passes[1]
    corr = Corrector(corr0.cdbg, corr0.colors, opt, device="cpu")
    yield (corr, dataclasses.replace(opt, nb_threads=2, read_batch_bp=3000),
           src, str(data["tmp"] / "fresh.fq"))
    PP.close(corr.planner)


def _kids():
    return {p.pid for p in multiprocessing.active_children()}


@limited(120)
def test_pool_starts_once_and_close_leaves_no_child(fresh):
    corr, opt, src, out = fresh
    before = _kids()
    pids = []
    for _ in range(2):
        with TR.recording() as rec:
            pipeline.correct_file(corr, opt, [src], out, 1)
        pids.append({s.thread for s in rec.spans if s.name == "plan"})
    workers = _kids() - before
    assert len(workers) == 3
    assert pids[0] <= workers and pids[1] <= workers and len(pids[0]) > 1
    pool = PP.pools[corr.planner]
    PP.close(corr.planner)
    assert pool.closed and corr.planner not in PP.pools
    assert not (_kids() & workers)
    for pid in workers:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def _fail(*a, **kw):
    raise ValueError("planted in a planner process")


def _die(*a, **kw):
    os.kill(os.getpid(), signal.SIGKILL)


def _touch_cuda(*a, **kw):
    torch.zeros(1, device="cuda")


@pytest.mark.parametrize("plan, raises", [
    (_fail, ValueError), (_die, BrokenProcessPool),
    (_touch_cuda, (RuntimeError, AssertionError))],
    ids=["raises", "killed", "cuda"])
@limited(120)
def test_a_worker_failure_raises_from_correct_file(fresh, monkeypatch, plan,
                                                   raises):
    """The workers fork with the planted plan_batch; correct_file raises
    what a slice raised, or BrokenProcessPool for a worker that died,
    within seconds; a broken pool closes and the next call starts
    another."""
    corr, opt, src, out = fresh
    planner = Planner.plan_batch
    monkeypatch.setattr(Planner, "plan_batch", plan)
    t0 = time.monotonic()
    with pytest.raises(raises):
        pipeline.correct_file(corr, opt, [src], out, 1)
    assert time.monotonic() - t0 < 30
    if plan is _die:
        assert PP.pools[corr.planner].closed
        monkeypatch.setattr(Planner, "plan_batch", planner)
        pipeline.correct_file(corr, opt, [src], out, 1)
        assert not PP.pools[corr.planner].closed


@pytest.mark.parametrize("config", ["one_thread", "device_planner",
                                    "sharded"])
@limited(180)
def test_thread_and_inline_paths_start_no_pool(passes, data, eight_cores,
                                               config):
    corr0, opt, _, _, src = passes[1]
    place = {"device": "cpu"}
    threads = 2
    if config == "one_thread":
        threads = 1
    elif config == "device_planner":
        opt = dataclasses.replace(opt, plan_on_device=True)
    else:
        from ratatosk_tpu_torch.parallel import mesh as M
        opt = dataclasses.replace(opt, shard_index_min_keys=0)
        place = {"mesh": M.make_mesh(devices=["cpu", "cpu"])}
    corr = Corrector(corr0.cdbg, corr0.colors, opt, **place)
    assert (corr.devplan is not None) == (config == "device_planner")
    assert (corr.sharded is not None) == (config == "sharded")
    before = _kids()
    got = _correct(corr, opt, src, str(data["tmp"] / f"{config}.fq"), 1,
                   threads)
    assert corr.planner not in PP.pools and _kids() == before
    want = _correct(passes[1][0], passes[1][1], src,
                    str(data["tmp"] / f"{config}_want.fq"), 1, 1)
    assert got and got == want


@pytest.mark.cuda
def test_a_worker_forked_after_cuda_cannot_touch_it(tmp_path, monkeypatch):
    """On the card: a Corrector on cuda:0 (CUDA initialised), its workers
    forked after; a CUDA call in one raises there, and correct_file raises
    it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(7)
    genome = T.random_genome(rng, 20000)
    sreads = T.short_reads(rng, genome, coverage=30.0, read_len=100)
    reads = [n for n, _, _ in T.long_reads(rng, genome, n=4, min_len=1500,
                                           max_len=2500, err=0.10)]
    src = tmp_path / "in.fq"
    _write_fq(src, reads)
    opt = dataclasses.replace(_opt(1), nb_threads=2, read_batch_bp=3000)
    cdbg, colors = pipeline.build_pass1_index(
        opt, sreads, list(range(len(sreads))))
    monkeypatch.setattr(PP, "usable_cores", lambda: list(range(8)))
    monkeypatch.setattr(PP, "worker_cores",
                        lambda cores: sorted(os.sched_getaffinity(0)))
    monkeypatch.setattr(Planner, "plan_batch", _touch_cuda)
    corr = Corrector(cdbg, colors, opt, device="cuda:0")
    try:
        with pytest.raises(RuntimeError, match="forked subprocess"):
            pipeline.correct_file(corr, opt, [str(src)],
                                  str(tmp_path / "out.fq"), 1)
    finally:
        PP.close(corr.planner)
