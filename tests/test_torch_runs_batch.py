"""The exact k-mer runs of a whole batch in one pass
(ratatosk_tpu_torch/correct/runs_batch.py) equal the per-read path,
`filter_runs_by_color(find_runs(...))`, list for list and field for field,
at k=31 and k=63 (two-word keys); the planner takes the batched path on the
host index with the native library, and the per-read path with a sharded
probe or without native code (the `plan.runs` span's `batched` field); and a
whole `plan_batch` is the same either way."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from ratatosk_tpu_torch import testing as T
from ratatosk_tpu_torch import trace as TR
from ratatosk_tpu_torch.config import CorrectOpt
from ratatosk_tpu_torch.correct import planner
from ratatosk_tpu_torch.correct.engine import Corrector
from ratatosk_tpu_torch.correct.runs_batch import find_runs_batch
from ratatosk_tpu_torch.correct.seeds import filter_runs_by_color, find_runs
from ratatosk_tpu_torch.graph import build as B
from ratatosk_tpu_torch.graph.colors import color_graph
from ratatosk_tpu_torch.ops import native_kmers as NK
from ratatosk_tpu_torch.parallel import mesh as M

pytestmark = pytest.mark.skipif(not NK.available(),
                                reason="the native k-mer library did not build")

KS = (31, 63)


@pytest.fixture(scope="module", params=KS, ids=lambda k: f"k{k}")
def graph(request):
    """A coloured graph at k from 150 bp error-free short reads at 30x of a
    10 kbp genome with repeats."""
    k = request.param
    rng = np.random.default_rng(1800 + k)
    genome = T.random_genome(rng, 10000, repeat_frac=0.1, repeat_len=200)
    sreads = T.short_reads(rng, genome, coverage=30.0, read_len=150)
    cdbg = B.build_cdbg(sreads, k, min_count=2)
    colors = color_graph(cdbg, sreads)
    return genome, cdbg, colors, rng


def per_read(cdbg, colors, reads):
    return [filter_runs_by_color(find_runs(cdbg, r), colors) for r in reads]


def check(cdbg, colors, reads):
    got = find_runs_batch(cdbg, colors, reads)
    want = per_read(cdbg, colors, reads)
    assert len(got) == len(want) == len(reads)
    for g, w in zip(got, want):
        assert [dataclasses.astuple(r) for r in g] == \
               [dataclasses.astuple(r) for r in w]
    return got


def noisy_reads(genome, rng, n, err=0.10):
    return [noisy for noisy, _, _ in T.long_reads(
        rng, genome, n=n, min_len=800, max_len=2500, err=err)]


def test_error_reads(graph):
    genome, cdbg, colors, rng = graph
    got = check(cdbg, colors, noisy_reads(genome, rng, 12))
    assert sum(map(len, got)) > 0


def test_sorted_key_lookup(graph, monkeypatch):
    """Past the hash directory's size limit both paths search the sorted
    keys (NK.lookup)."""
    genome, cdbg, colors, rng = graph
    monkeypatch.setattr(NK, "hash_dir", lambda index: None)
    got = check(cdbg, colors, noisy_reads(genome, rng, 4, err=0.03))
    assert any(got)


def test_short_reads_and_empty_reads(graph):
    genome, cdbg, colors, rng = graph
    k = cdbg.k
    reads = [genome[100:100 + k - 1], genome[500:500 + k], genome[:0],
             genome[2000:3000], genome[4000:4000 + k - 1]]
    got = check(cdbg, colors, reads)
    assert got[0] == got[2] == got[4] == []
    assert len(got[1]) == 1 and got[1][0].s == got[1][0].e == 0
    assert got[3]
    check(cdbg, colors, [genome[:k - 1], genome[:0]])


def test_empty_batch(graph):
    _, cdbg, colors, _ = graph
    assert find_runs_batch(cdbg, colors, []) == []


def test_reads_with_no_hit(graph):
    genome, cdbg, colors, _ = graph
    other = np.random.default_rng(7).integers(0, 4, 1500).astype(np.uint8)
    assert per_read(cdbg, colors, [other]) == [[]]
    check(cdbg, colors, [other])
    check(cdbg, colors, [other, genome[1000:2500], other])


def test_reads_holding_code_4(graph):
    genome, cdbg, colors, rng = graph
    reads = noisy_reads(genome, rng, 4)
    for r in reads:
        r[rng.choice(len(r), 6, replace=False)] = 4
    reads.append(np.full(200, 4, np.uint8))
    got = check(cdbg, colors, reads)
    assert any(got)


def test_no_chain_across_the_separator(graph):
    """Read a's last window and read b's first lie on one unitig at
    consecutive offsets: one chain across the read boundary would merge
    them."""
    genome, cdbg, colors, _ = graph
    k = cdbg.k
    a = genome[3000:3400]
    b = genome[3400 - k + 1:3800]
    want = per_read(cdbg, colors, [genome[3000:3800]])[0]
    whole = [r for r in want if r.s <= 400 - k < r.e]
    assert whole, "the genome's stretch is not one run"
    got = check(cdbg, colors, [a, b])
    last, first = got[0][-1], got[1][0]
    assert (last.e, first.s) == (400 - k, 0)
    assert (last.uid, last.direction) == (first.uid, first.direction)
    assert first.o_s == last.o_e + 1


def test_junctions_that_fail_the_colour_filter(graph):
    """Chimeras of far-apart stretches: their junctions share no short
    read, so the filter kills both long sides, or a one-k-mer side alone."""
    genome, cdbg, colors, rng = graph
    k = cdbg.k
    both = np.concatenate([genome[1000:1300], genome[7000:7300]])

    def alone(y):
        return np.concatenate([genome[2000:2300], genome[y:y + k],
                               genome[8000:8300]])
    # a middle k-mer whose neighbours across the joins miss by every base
    y = next(y for y in range(5000, 5100)
             if genome[y - 1] != genome[2299] and genome[y + k] != genome[8000]
             and any(r.s == r.e == 300 for r in find_runs(cdbg, alone(y))))
    reads = [both, alone(y)] + noisy_reads(genome, rng, 3)
    raw = [find_runs(cdbg, r) for r in reads[:2]]
    got = check(cdbg, colors, reads)
    assert len(got[0]) < len(raw[0])
    assert len(got[1]) < len(raw[1])
    assert any(r.s == r.e for r in raw[1])
    assert not any(r.s == r.e for r in got[1])
    assert got[1], "the long sides of a 0-length run die with it"


# ---------- the planner ----------

@pytest.fixture(scope="module")
def toy():
    """A k=31 Corrector on the CPU and reads of the benchmark's kind: 4 kbp
    at 10% error."""
    opt = CorrectOpt(small_k=31, k=63, beam_width=8, batch_regions=32)
    genome, corr = T.build_toy_corrector(seed=18, glen=20000, k=31,
                                         opt=opt, device="cpu")
    rng = np.random.default_rng(18)
    reads = [T.noisy_read(rng, genome, int(rng.integers(0, 16000)), 4000,
                          err=0.10)[0] for _ in range(6)]
    return corr, reads


def batched_flags(corr, reads):
    with TR.recording() as rec:
        out = corr.plan_batch(reads)
    return [s.fields["batched"] for s in rec.spans
            if s.name == "plan.runs"], out


def test_plan_runs_span_says_whether_the_batch_went_through_at_once(
        toy, monkeypatch):
    corr, reads = toy
    flags, host = batched_flags(corr, reads)
    assert flags == [1]
    sharded = Corrector(corr.cdbg, corr.colors,
                        dataclasses.replace(corr.opt, shard_index_min_keys=0),
                        mesh=M.make_mesh(devices=["cpu", "cpu"]))
    assert sharded.sharded is not None
    assert sharded.planner._probe() is not None
    flags, via_shards = batched_flags(sharded, reads)
    assert flags == [0]
    assert_same(via_shards, host)
    monkeypatch.setattr(NK, "available", lambda: False)
    flags, numpy_only = batched_flags(corr, reads)
    assert flags == [0]
    assert_same(numpy_only, host)


def assert_same(a, b, where="plan_batch"):
    """Equal, arrays by dtype and value, dataclasses field by field."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    elif dataclasses.is_dataclass(a):
        assert type(a) is type(b), where
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{where}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    else:
        assert type(a) is type(b) and a == b, where


def test_plan_batch_equals_the_per_read_path(toy, monkeypatch):
    corr, reads = toy
    new = corr.plan_batch(reads)
    monkeypatch.setattr(
        planner, "find_runs_batch",
        lambda cdbg, colors, rr: per_read(cdbg, colors, rr))
    old = corr.plan_batch(reads)
    assert len(new[2]) == len(old[2]) > 0
    assert_same(new, old)
