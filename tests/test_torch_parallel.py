"""The port's mesh layer (ratatosk_tpu_torch/parallel/mesh.py and
sharded_index.py, and the Corrector's mesh and sharded modes) on CPU slots
against the JAX package on its 8 virtual CPU devices (tests/conftest.py).
A slot list may repeat a device: ["cpu", "cpu"] runs the split, the
replicas and the gather as two cards would. Everything must be identical
(tolerance 0)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratatosk_tpu import testing as JT
from ratatosk_tpu.config import CorrectOpt as JOpt
from ratatosk_tpu.correct.engine import Corrector as JCorrector
from ratatosk_tpu.graph import build as JB
from ratatosk_tpu.graph.colors import color_graph as j_color_graph
from ratatosk_tpu.parallel import mesh as JM
from ratatosk_tpu.parallel.sharded_index import \
    ShardedKmerIndex as JShardedKmerIndex
from ratatosk_tpu_torch import pipeline as TP
from ratatosk_tpu_torch import testing as TT
from ratatosk_tpu_torch.config import CorrectOpt as TOpt
from ratatosk_tpu_torch.correct import beam as TBM
from ratatosk_tpu_torch.correct.engine import Corrector as TCorrector
from ratatosk_tpu_torch.graph import build as TB
from ratatosk_tpu_torch.graph.colors import color_graph as t_color_graph
from ratatosk_tpu_torch.graph.keys import KeyArray
from ratatosk_tpu_torch.io import fastx as TFX
from ratatosk_tpu_torch.parallel import mesh as TM
from ratatosk_tpu_torch.parallel.sharded_index import ShardedKmerIndex
from tests import sim
from tests import torch_parity as PAR
from tests.test_torch_e2e import (K1, K2, _two_pass, dataset,  # noqa: F401
                                  jax_two_pass)
from tests.torch_parity import one_torch_thread  # noqa: F401


def cpu_mesh(n: int) -> TM.Mesh:
    return TM.make_mesh(devices=["cpu"] * n)


# (beam case, slots, regions): 13 rows over 3 slots pads to 15
@pytest.mark.parametrize("case,n_slots,r", [
    ("nt256_exact", 2, 16), ("nt256_exact", 3, 13),
    ("nt512_band192", 2, 8), ("nt512_band192", 3, 7),
])
def test_sharded_beam_search_matches_jax(case, n_slots, r):
    corr, jrb, lmax, band, jres = PAR.beam_case(case)
    jrb_r = jax.tree_util.tree_map(lambda x: x[:r], jrb)
    g, rb = PAR.to_torch_graph(corr.g), PAR.to_torch_regions(jrb_r)
    got = TM.sharded_beam_search(g, rb, cpu_mesh(n_slots), beam=8,
                                 lmax=lmax, min_cov=2, band=band)
    single = TBM.beam_search(g, rb, beam=8, lmax=lmax, min_cov=2, band=band)
    if band == 0:
        want = JM.sharded_beam_search(corr.g, jrb_r, JM.make_mesh(n_slots),
                                      beam=8, lmax=lmax, min_cov=2)
    else:
        # the JAX helper runs the exact DP only; its rows are independent,
        # so the banded single-device result's first r rows stand for it
        want = jax.tree_util.tree_map(lambda x: x[:r], jres)
    for f in TBM.FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
        assert torch.equal(getattr(got, f), getattr(single, f)), f


def test_pad_and_shard_regions():
    _, jrb, _, _, _ = PAR.beam_case("nt256_exact")
    rb = PAR.to_torch_regions(jax.tree_util.tree_map(lambda x: x[:5], jrb))
    padded = TM.pad_regions_to(rb, 6)
    jpad = JM.pad_regions_to(jax.tree_util.tree_map(lambda x: x[:5], jrb), 6)
    for f, v in jpad._asdict().items():
        np.testing.assert_array_equal(getattr(padded, f).numpy(),
                                      np.asarray(v), err_msg=f)
    parts = TM.shard_regions(padded, cpu_mesh(3))
    assert [p.tgt_len.shape[0] for p in parts] == [2, 2, 2]
    assert torch.equal(torch.cat([p.tgt_masks for p in parts]),
                       padded.tgt_masks)
    with pytest.raises(ValueError, match="do not split"):
        TM.shard_regions(rb, cpu_mesh(2))
    # the split the Corrector and sharded_beam_search launch: each slot
    # gets its rows in its own thread; a slot of padding rows only is not
    # launched, and the gather covers the real rows in order
    with TM.SlotPool(cpu_mesh(3)) as pool:
        futs = pool.submit_rows(
            6, lambda dev, rows, steps: (TM.region_rows(padded, rows, dev)
                                         .tgt_len.numpy(),), n_real=3)
        got, = TM.gather(futs)
    assert len(futs) == 2
    np.testing.assert_array_equal(got, padded.tgt_len[:4].numpy())


@pytest.mark.parametrize("seed,glen,repeat_frac", [
    (100, 12000, 0.0),   # test_correct_simple_genome
    (101, 15000, 0.2),   # test_correct_repetitive_genome
])
def test_mesh_corrector_matches_jax(seed, glen, repeat_frac):
    """Corrector(mesh=2 CPU slots).correct_batch against the JAX Corrector on
    a 2-device mesh (tests/test_torch_e2e.py fixtures)."""
    rng = np.random.default_rng(seed)
    genome = sim.random_genome(rng, glen, repeat_frac=repeat_frac,
                               repeat_len=200)
    sreads = sim.short_reads(rng, genome, coverage=40.0, read_len=120)
    lreads = sim.long_reads(rng, genome, n=3, min_len=1500, max_len=2500,
                            err=0.10)
    reads = [x[0] for x in lreads]
    kw = dict(small_k=21, k=63, beam_width=8, batch_regions=32)
    cdbg = JB.build_cdbg(sreads, 21, min_count=2)
    want = JCorrector(cdbg, j_color_graph(cdbg, sreads), JOpt(**kw),
                      mesh=JM.make_mesh(2)).correct_batch(reads)
    tcdbg = TB.build_cdbg(sreads, 21, min_count=2)
    corr = TCorrector(tcdbg, t_color_graph(tcdbg, sreads), TOpt(**kw),
                      mesh=cpu_mesh(2))
    assert corr.mesh is not None and corr.sharded is None
    got = corr.correct_batch(reads)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.codes, w.codes)
        np.testing.assert_array_equal(g.qual, w.qual)
        assert (g.n_solid, g.n_regions, g.n_corrected) == (
            w.n_solid, w.n_regions, w.n_corrected)


def _queries(index, n_slots, rng):
    """Present keys, absent keys with bit 63 set in lo, 0, the all-ones key,
    and the keys on both sides of every shard boundary (and near misses of
    them that differ in bit 63 of lo). Returns (q_lo, q_hi or None)."""
    n = index.n
    per = -(-n // n_slots)
    at = np.unique(np.clip(np.concatenate(
        [np.arange(n_slots + 1) * per + d for d in (-1, 0, 1)]
        + [rng.integers(0, n, 300)]), 0, n - 1))
    flip = np.uint64(1 << 63)
    lo = [index.keys_lo[at], index.keys_lo[at] ^ flip,
          rng.integers(0, 1 << 62, 200).astype(np.uint64) | flip,
          np.array([0, 0xFFFFFFFFFFFFFFFF], np.uint64)]
    if not index.two_word:
        return np.concatenate(lo), None
    hi = [index.keys_hi[at], index.keys_hi[at],
          rng.integers(0, 1 << 61, 200).astype(np.uint64),
          np.array([0, 0xFFFFFFFFFFFFFFFF], np.uint64)]
    return np.concatenate(lo), np.concatenate(hi)


@pytest.mark.parametrize("k", [21, 63])
@pytest.mark.parametrize("n_slots", [1, 2, 3])
def test_sharded_lookup_matches_jax(k, n_slots):
    rng = np.random.default_rng(800 + k)
    genome = sim.random_genome(rng, 20000)
    jcdbg = JB.build_cdbg([genome], k, min_count=1)
    tcdbg = TB.build_cdbg([genome], k, min_count=1)
    assert tcdbg.index.two_word == (k > 32)
    q_lo, q_hi = _queries(tcdbg.index, n_slots, rng)
    sidx = ShardedKmerIndex(tcdbg.index, cpu_mesh(n_slots))
    got = [t.numpy() for t in sidx.lookup(q_lo, q_hi)]
    jidx = JShardedKmerIndex(jcdbg.index, JM.make_mesh(n_slots))
    want = jidx.lookup(jnp.asarray(q_lo),
                       None if q_hi is None else jnp.asarray(q_hi))
    for name, g, w in zip(("uid", "pos", "strand"), got, want):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    # and the hits are the host index's (KeyArray.find)
    ka = KeyArray(k, tcdbg.index.keys_lo, tcdbg.index.keys_hi)
    rows = ka.find(KeyArray(k, q_lo, q_hi))
    hit = rows >= 0
    assert hit.sum() > 250
    np.testing.assert_array_equal(got[0] >= 0, hit)
    np.testing.assert_array_equal(got[0][hit],
                                  tcdbg.index.unitig_id[rows[hit]])
    np.testing.assert_array_equal(got[1][hit], tcdbg.index.pos[rows[hit]])


def test_sharded_corrector_matches_jax():
    """shard_index_min_keys=0 routes anchor lookups through the sharded
    index (tests/test_sharded_index.py:18-41); both packages on a 2-slot
    mesh, and the port's output also equals its replicated-index run."""
    kw = dict(small_k=17, k=63, beam_width=8, batch_regions=32)
    genome, jbase = JT.build_toy_corrector(seed=77, glen=8000, k=17)
    _, tbase = TT.build_toy_corrector(seed=77, glen=8000, k=17, device="cpu")
    rng = np.random.default_rng(77)
    reads = [JT.noisy_read(rng, genome, 200 + 900 * i, 1500, err=0.08)[0]
             for i in range(3)]
    want = JCorrector(jbase.cdbg, jbase.colors,
                      JOpt(shard_index_min_keys=0, **kw),
                      mesh=JM.make_mesh(2)).correct_batch(reads)
    sharded = TCorrector(tbase.cdbg, tbase.colors,
                         TOpt(shard_index_min_keys=0, plan_on_device=True,
                              **kw), mesh=cpu_mesh(2))
    assert sharded.sharded is not None
    assert sharded.devplan is None, "device planner and sharded index clash"
    calls = []
    lookup = sharded.sharded.lookup
    sharded.sharded.lookup = lambda *a: calls.append(1) or lookup(*a)
    got = sharded.correct_batch(reads)
    assert calls, "anchor lookups bypassed the sharded index"
    plain = tbase.correct_batch(reads)
    for g, w, p in zip(got, want, plain):
        np.testing.assert_array_equal(g.codes, w.codes)
        np.testing.assert_array_equal(g.qual, w.qual)
        np.testing.assert_array_equal(g.codes, p.codes)


def test_mesh_correct_file_matches_jax(dataset, jax_two_pass):  # noqa: F811
    """Both passes through correct_file on a 2-slot mesh with the planning
    double buffer (nb_threads=2): the FASTQ bytes equal the JAX run's."""
    tmp, sreads, _, lr = dataset
    opt = TOpt(small_k=K1, k=K2, beam_width=8, batch_regions=32,
               read_batch_bp=2000, nb_threads=2)
    got = _two_pass(TP, TCorrector, TFX.read_fastx, opt, sreads, lr,
                    str(tmp / "torch_mesh"), mesh=cpu_mesh(2))
    assert got == jax_two_pass
    assert Path(str(tmp / "torch_mesh.fastq")).exists()


def test_mesh_rejects_missing_devices():
    """A slot on a device torch cannot see raises; nothing is dropped."""
    if torch.cuda.is_available():
        bad = f"cuda:{torch.cuda.device_count()}"
    else:
        bad = "cuda:0"
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.make_mesh(devices=["cpu", bad])
    with pytest.raises(RuntimeError, match="requested"):
        TM.make_mesh(3, devices=["cpu", "cpu"])
    with pytest.raises(TypeError):
        TCorrector(None, None, TOpt())


class _StepSpy:
    """Records, per thread, each search's phase-1 and phase-2 step loops
    (correct.beam._run_steps) and each slot's StepCount.agree (its own step
    count, the launch's T, which launch)."""

    def __init__(self, monkeypatch):
        import threading
        self.runs, self.agrees = {}, {}
        run_steps, agree = TBM._run_steps, TM.StepCount.agree

        def spy_run(g, rb, pt, st, t0, t_stop, *, until_frozen, **kw):
            st, t = run_steps(g, rb, pt, st, t0, t_stop,
                              until_frozen=until_frozen, **kw)
            self.runs.setdefault(threading.get_ident(), []).append(
                (until_frozen, t0, t_stop, t))
            return st, t

        def spy_agree(steps, own):
            T = agree(steps, own)
            self.agrees.setdefault(threading.get_ident(), []).append(
                (id(steps), own, T))
            return T

        monkeypatch.setattr(TBM, "_run_steps", spy_run)
        monkeypatch.setattr(TM.StepCount, "agree", spy_agree)

    def launches(self):
        """[(T, [(own f, phase-2 steps run), one per slot])] per launch:
        checks that each slot's phase 1 ran from step 0 until its rows
        froze (its own f), agreed that f, and ran phase 2 from f to
        min(T, f+1)."""
        by_launch = {}
        for tid, agrees in self.agrees.items():
            runs = self.runs[tid]
            assert len(runs) == 2 * len(agrees)
            for (key, own, T), p1, p2 in zip(agrees, runs[::2], runs[1::2]):
                assert p1[0] and p1[1] == 0 and p1[3] == own
                assert not p2[0] and p2[1] == own
                assert p2[2] == p2[3] == min(T, own + 1)
                by_launch.setdefault(key, []).append((own, T, p2[3]))
        out = []
        for slots in by_launch.values():
            T = max(own for own, _, _ in slots)
            assert all(t == T for _, t, _ in slots), slots
            out.append((T, [(own, steps) for own, _, steps in slots]))
        return out


def _by_own_steps(rb, lmax, band, g):
    """The rows of rb ordered by each region's own all-frozen step f_r."""
    f = [TBM.beam_phase1(g, TBM._rows(rb, r), beam=8, lmax=lmax, band=band).f
         for r in range(rb.tgt_masks.shape[0])]
    order = torch.as_tensor(np.argsort(f, kind="stable"))
    return TBM.RegionBatch(**{n: getattr(rb, n)[order]
                              for n in TBM.RegionBatch._DTYPES}), sorted(f)


@pytest.mark.parametrize("impl", ["torch", "auto"])
def test_mesh_slots_run_phase2_with_the_launch_wide_step_count(
        impl, monkeypatch):
    """Two CPU slots whose longest regions differ (the regions sorted by
    their own f_r, so slot 0 holds the shorter half): each slot runs phase
    1 to its own step count, both agree on the launch's T (the larger), and
    each runs phase 2 to min(T, f+1) steps: slot 0 one step more than it
    would alone. The gathered result equals one slot's (and the plain
    route's) field for field."""
    corr, jrb, lmax, band, _ = PAR.beam_case("nt256_exact")
    g = PAR.to_torch_graph(corr.g)
    rb, f = _by_own_steps(PAR.to_torch_regions(jrb), lmax, band, g)
    n = len(f)
    assert max(f[:n // 2]) < max(f[n // 2:]), f
    spy = _StepSpy(monkeypatch)
    got = TM.sharded_beam_search(g, rb, cpu_mesh(2), beam=8, lmax=lmax,
                                 min_cov=2, band=band, impl=impl)
    (T, slots), = spy.launches()
    assert T == max(f)
    assert sorted(slots) == sorted([(max(f[:n // 2]), max(f[:n // 2]) + 1),
                                    (T, T)])
    one = TBM.beam_search(g, rb, beam=8, lmax=lmax, min_cov=2, band=band,
                          impl="torch")
    for fl in TBM.FIELDS:
        assert torch.equal(getattr(got, fl), getattr(one, fl)), fl


def test_mesh_corrector_launches_use_the_launch_wide_step_count(monkeypatch):
    """Corrector(mesh=2 CPU slots).correct_batch: in every launch both
    slots run phase 2 with the launch's T, read from the step loops; some
    launch's slots reach different step counts of their own; the corrected
    reads equal the one-device Corrector's."""
    rng = np.random.default_rng(100)
    genome = sim.random_genome(rng, 12000, repeat_frac=0.0, repeat_len=200)
    sreads = sim.short_reads(rng, genome, coverage=40.0, read_len=120)
    reads = [x[0] for x in sim.long_reads(rng, genome, n=3, min_len=1500,
                                          max_len=2500, err=0.10)]
    # launches of 8 rows: 4 a slot, so both slots hold real regions
    kw = dict(small_k=21, k=63, beam_width=8, batch_regions=8)
    cdbg = TB.build_cdbg(sreads, 21, min_count=2)
    colors = t_color_graph(cdbg, sreads)
    want = TCorrector(cdbg, colors, TOpt(**kw), device="cpu").correct_batch(
        reads)
    spy = _StepSpy(monkeypatch)
    got = TCorrector(cdbg, colors, TOpt(**kw),
                     mesh=cpu_mesh(2)).correct_batch(reads)
    launches = spy.launches()
    assert launches and all(len(s) == 2 for _, s in launches)
    assert any(own < T for T, s in launches for own, _ in s)
    for g_, w in zip(got, want):
        np.testing.assert_array_equal(g_.codes, w.codes)
        np.testing.assert_array_equal(g_.qual, w.qual)


def test_padding_rows_cannot_raise_the_step_count():
    """A slot of padding rows only is not launched (SlotPool.submit_rows):
    padding rows freeze in step 0 (f = 1) and every real row runs step 0,
    so the launch's T is the real slots' alone."""
    corr, jrb, lmax, band, _ = PAR.beam_case("nt256_exact")
    g = PAR.to_torch_graph(corr.g)
    rb = TM.pad_regions_to(PAR.to_torch_regions(jrb), 24)
    n_real = jrb.tgt_len.shape[0]
    pad = TM.region_rows(rb, slice(n_real, 24), "cpu")
    assert TBM.beam_phase1(g, pad, beam=8, lmax=lmax, band=band).f == 1
    for r in range(n_real):
        assert TBM.beam_phase1(g, TBM._rows(rb, r), beam=8, lmax=lmax,
                               band=band).f >= 1


def test_step_count_waits_end_when_a_slot_fails():
    """A slot that raises before it offers its step count releases the
    launch's other slots (their agree raises BrokenBarrierError), and
    gather raises the slot's own error; a pool left by an exception
    releases a slot waiting for one that never started."""
    import threading

    def fn(dev, rows, steps):
        if rows.start:
            raise ValueError("slot 1 failed")
        return (np.array([steps.agree(3)]),)

    with TM.SlotPool(cpu_mesh(2)) as pool:
        futs = pool.submit_rows(4, fn)
        with pytest.raises(ValueError, match="slot 1 failed"):
            TM.gather(futs)
    assert isinstance(futs[0].exception(), threading.BrokenBarrierError)
    block = threading.Event()
    with pytest.raises(RuntimeError, match="left"):
        with TM.SlotPool(cpu_mesh(2)) as pool:
            pool.submit(1, lambda dev: block.wait(5))
            futs = pool.submit_rows(4, lambda dev, rows, steps:
                                    (np.array([steps.agree(1)]),))
            raise RuntimeError("left")
    block.set()
    assert all(f.done() for f in futs)
