"""The fused beam kernel (ops/beam_kernel.py, csrc/beam.cu) and the finish
kernel (ops/finish_kernel.py, csrc/finish.cu) against their plain PyTorch
versions, on region batches planned from reads by ratatosk_tpu_torch.testing
(no JAX, so the card's cases run where JAX is not installed). Every
comparison is exact: tolerance 0.

The kernels run only on a card: those cases are marked `cuda` and skip where
torch sees no CUDA device:
    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
On the CPU the same batches check that every impl route gives one result.
"""

import functools

import numpy as np
import pytest
import torch

from ratatosk_tpu_torch import testing
from ratatosk_tpu_torch.config import CorrectOpt
from ratatosk_tpu_torch.correct import beam as BM
from ratatosk_tpu_torch.correct import finish as FN
from ratatosk_tpu_torch.correct.engine import region_arrays
from ratatosk_tpu_torch.ops.beam_kernel import fused_beam_search
from ratatosk_tpu_torch.ops.finish_kernel import finish_bundle_kernel
from tests import finish_cases as FC

# (NT, band) of the engine's three buckets (engine._launch_bucket): the
# exact 256 bucket (beam W=257, finish W=lmax+1=389), then bands of 192 and
# 336 (finish w the same)
BUCKETS = {257: (256, 0), 192: (2048, 192), 336: (5376, 336)}
QV_MAX, MIN_SCORE_OPEN = 40, 0.6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _specs():
    opt = CorrectOpt(small_k=21, k=63, beam_width=8, batch_regions=32)
    genome, corr = testing.build_toy_corrector(seed=7, glen=20000, k=21,
                                               opt=opt, device="cpu")
    specs = testing.toy_region_specs(corr, genome,
                                     np.random.default_rng(7), 24)
    return corr, specs


def region_batch(W: int, device, r_pad: int = 32):
    """(graph, RegionBatch, lmax, band) of the bucket whose beam band is W,
    planned regions padded to r_pad rows as the engine pads them."""
    nt, band = BUCKETS[W]
    corr, specs = _specs()
    specs = [s for s in specs if len(s.tgt) <= nt][:r_pad]
    arrays, lmax = region_arrays(specs, nt, corr.colors.cap, r_pad=r_pad)
    return (corr.g.to(device), BM.RegionBatch.from_numpy(arrays, device),
            lmax, band)


@functools.lru_cache(maxsize=None)
def _wide_specs():
    """Regions of 600-915 bases (a toy graph under noisier reads): a band
    of 600 columns or more moves along them."""
    opt = CorrectOpt(small_k=21, k=63, beam_width=8, batch_regions=32)
    genome, corr = testing.build_toy_corrector(seed=5, glen=30000, k=21,
                                               coverage=25.0, opt=opt,
                                               device="cpu")
    specs = testing.toy_region_specs(corr, genome,
                                     np.random.default_rng(5), 120, err=0.15)
    return corr, sorted((s for s in specs if 600 < len(s.tgt) <= 2048),
                        key=lambda s: len(s.tgt))[-8:]


def wide_batch(device):
    """(graph, RegionBatch, lmax) of the wide regions in the 2048 bucket."""
    corr, specs = _wide_specs()
    arrays, lmax = region_arrays(specs, 2048, corr.colors.cap, r_pad=8)
    return corr.g.to(device), BM.RegionBatch.from_numpy(arrays, device), lmax


def _finish(fn, rb, res, band, k=21):
    return fn(rb.tgt_masks, rb.tgt_len, rb.tgt_qual, QV_MAX, k, res, w=band,
              min_score_open=MIN_SCORE_OPEN)


@pytest.mark.parametrize("impl", ["auto", "steps"])
def test_routes_agree_on_cpu(impl, W=192):
    """On CPU tensors every impl route runs the plain version: one result,
    no kernel launch, and the finish wrapper equals finish_bundle."""
    g, rb, lmax, band = region_batch(W, "cpu", r_pad=16)
    before = fused_beam_search.launches, finish_bundle_kernel.launches
    a = BM.beam_search(g, rb, beam=8, lmax=lmax, band=band, impl=impl)
    b = BM.beam_search(g, rb, beam=8, lmax=lmax, band=band, impl="torch")
    for f in BM.FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert b.completed.any(), "fixture must complete regions"
    fa = _finish(finish_bundle_kernel, rb, a, band)
    fb = _finish(FN.finish_bundle, rb, b, band)
    assert torch.equal(fa.scalars, fb.scalars)
    assert torch.equal(fa.seq_packed, fb.seq_packed)
    assert (fused_beam_search.launches,
            finish_bundle_kernel.launches) == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [16, 128])
@pytest.mark.parametrize("W", [257, 192, 336])
def test_fused_beam_kernel_matches_plain_on_card(cuda_device, W, B):
    g, rb, lmax, band = region_batch(W, cuda_device)
    before = fused_beam_search.launches
    got = BM.beam_search(g, rb, beam=B, lmax=lmax, band=band, impl="auto")
    torch.cuda.synchronize()
    assert fused_beam_search.launches == before + 2
    want = BM.beam_search(g, rb, beam=B, lmax=lmax, band=band, impl="torch")
    for f in BM.FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def edge_batch(kind: str, W: int, device):
    """(graph, RegionBatch, lmax, band) of a batch that takes the kernel's
    rarer paths: "padding" spreads padding rows among the real ones over
    R=300 rows (several regions per block); "one_long" gives every region
    but the longest a path budget of 2, so it freezes at once while one
    runs on (T >> f_r); "none_complete" opens every region (end_tip = -1),
    so no path arrives and each walk starts at step min(T, f_r+1)-1;
    "ties" makes every target base an N (mask 15) and opens every other
    region, so sibling branches tie at the rank (the index tie-break orders
    them) and the final pick falls back on partial paths."""
    g, rb, lmax, band = region_batch(W, "cpu")
    f = {n: getattr(rb, n).clone() for n in BM.RegionBatch._DTYPES}
    if kind == "padding":
        idx = np.random.default_rng(W).permutation(300) % f["tgt_len"].shape[0]
        f = {n: t[torch.as_tensor(idx)] for n, t in f.items()}
    elif kind == "one_long":
        keep = int(torch.argmax(f["tgt_len"]))
        f["max_plen"] = torch.where(torch.arange(len(f["max_plen"])) == keep,
                                    f["max_plen"], 2).to(torch.int32)
    elif kind == "none_complete":
        f["end_tip"] = torch.full_like(f["end_tip"], -1)
    elif kind == "ties":
        f["tgt_masks"][::2] = 15
        f["end_tip"][::2] = -1
    rb = BM.RegionBatch(**{n: t.contiguous().to(device) for n, t in f.items()})
    return g.to(device), rb, lmax, band


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["padding", "one_long", "none_complete",
                                  "ties"])
def test_fused_beam_kernel_edge_batches_on_card(cuda_device, kind, W=192):
    g, rb, lmax, band = edge_batch(kind, W, cuda_device)
    got = BM.beam_search(g, rb, beam=16, lmax=lmax, band=band, impl="auto")
    torch.cuda.synchronize()
    want = BM.beam_search(g, rb, beam=16, lmax=lmax, band=band, impl="torch")
    for f in BM.FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("W", [257, 192, 336])
def test_finish_kernel_matches_plain_on_card(cuda_device, W):
    g, rb, lmax, band = region_batch(W, cuda_device)
    res = BM.beam_search(g, rb, beam=16, lmax=lmax, band=band, impl="torch")
    # masks past tgt_len must not matter (the engine writes zeros there)
    rng = np.random.default_rng(W)
    masks = rb.tgt_masks.cpu().numpy()
    for r, n in enumerate(rb.tgt_len.cpu().numpy()):
        masks[r, n:] = 1 << rng.integers(0, 4, masks.shape[1] - n)
    rb.tgt_masks = torch.tensor(masks, device=cuda_device)
    before = finish_bundle_kernel.launches
    got = _finish(finish_bundle_kernel, rb, res, band)
    torch.cuda.synchronize()
    assert finish_bundle_kernel.launches == before + 1
    want = _finish(FN.finish_bundle, rb, res, band)
    assert torch.equal(got.scalars, want.scalars)
    assert torch.equal(got.seq_packed, want.seq_packed)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["padding", "one_long", "none_complete",
                                  "ties"])
def test_finish_kernel_edge_batches_on_card(cuda_device, kind, W=192):
    g, rb, lmax, band = edge_batch(kind, W, cuda_device)
    res = BM.beam_search(g, rb, beam=16, lmax=lmax, band=band, impl="torch")
    got = _finish(finish_bundle_kernel, rb, res, band)
    torch.cuda.synchronize()
    want = _finish(FN.finish_bundle, rb, res, band)
    assert torch.equal(got.scalars, want.scalars)
    assert torch.equal(got.seq_packed, want.seq_packed)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(FC.SHAPES))
def test_finish_kernel_synthetic_on_card(cuda_device, shape):
    """tests/finish_cases.py's regions (window clamped at both ends, paths
    shorter than the band, empty paths, N masks) at band widths of 1 to
    2,100 columns and full rows of 389 and 1,100 (2 and 4 words a lane
    past 1,024)."""
    NT, L, w = FC.SHAPES[shape]
    arrs = {k: torch.tensor(v, device=cuda_device)
            for k, v in FC.finish_case(sum(map(ord, shape)), NT, L).items()}
    res = BM.BeamResult(**{f: arrs[f] for f in BM.FIELDS})
    args = (arrs["tgt_masks"], arrs["tgt_len"], arrs["tgt_qual"], QV_MAX, 21,
            res)
    kw = dict(w=w, min_score_open=MIN_SCORE_OPEN)
    got = finish_bundle_kernel(*args, **kw)
    torch.cuda.synchronize()
    want = FN.finish_bundle(*args, **kw)
    assert torch.equal(got.scalars, want.scalars)
    assert torch.equal(got.seq_packed, want.seq_packed)


@pytest.mark.cuda
@pytest.mark.parametrize("band", [600, 1024])
def test_fused_beam_kernel_wide_band_on_card(cuda_device, band):
    """Bands past 512 columns (24 and 32 columns a lane) on regions longer
    than the band, and the finish kernel after it."""
    g, rb, lmax = wide_batch(cuda_device)
    got = BM.beam_search(g, rb, beam=16, lmax=lmax, band=band, impl="auto")
    torch.cuda.synchronize()
    want = BM.beam_search(g, rb, beam=16, lmax=lmax, band=band, impl="torch")
    for f in BM.FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    fg = _finish(finish_bundle_kernel, rb, want, band)
    torch.cuda.synchronize()
    fw = _finish(FN.finish_bundle, rb, want, band)
    assert torch.equal(fg.scalars, fw.scalars)
    assert torch.equal(fg.seq_packed, fw.seq_packed)


@pytest.mark.cuda
def test_kernel_width_caps_match_the_library(cuda_device):
    from ratatosk_tpu_torch.ops import beam_kernel, cuda_lib, finish_kernel
    from ratatosk_tpu_torch.ops import sprint
    lib = cuda_lib.library()
    assert lib.beam_search_max_width() == beam_kernel.MAX_WIDTH == 1024
    assert lib.finish_bundle_max_width() == finish_kernel.MAX_WIDTH == 8192
    assert lib.sprint_rows_max_width() == sprint.MAX_WIDTH == 1024


@pytest.mark.cuda
@pytest.mark.parametrize("opt_kw", [dict(band_width=600),
                                    dict(weak_region_len_factor=0.6)])
def test_wide_options_run_through_both_kernels_on_card(cuda_device, opt_kw):
    """Corrector(band_width=600) and (weak_region_len_factor=0.6) on the
    card launch both kernels and correct reads as the CPU does."""
    opt = CorrectOpt(small_k=21, k=63, beam_width=8, batch_regions=32,
                     **opt_kw)
    genome, corr = testing.build_toy_corrector(seed=5, glen=30000, k=21,
                                               coverage=25.0, opt=opt,
                                               device=cuda_device)
    rng = np.random.default_rng(5)
    reads = [testing.noisy_read(rng, genome, 3000 * i, 2500, err=0.15)[0]
             for i in range(4)]
    _, cpu = testing.build_toy_corrector(seed=5, glen=30000, k=21,
                                         coverage=25.0, opt=opt,
                                         device="cpu")
    before = fused_beam_search.launches, finish_bundle_kernel.launches
    got = corr.correct_batch(reads)
    assert fused_beam_search.launches > before[0]
    assert finish_bundle_kernel.launches > before[1]
    for a, b in zip(got, cpu.correct_batch(reads)):
        np.testing.assert_array_equal(a.codes, b.codes)
        np.testing.assert_array_equal(a.qual, b.qual)


@pytest.mark.cuda
def test_steps_route_takes_a_wide_band_on_card(cuda_device):
    """Corrector(impl="steps", band_width=600) on the card launches the
    sprint kernel at a band past 512 columns and corrects the same reads
    as impl="torch", byte for byte."""
    from ratatosk_tpu_torch.correct import beam as beam_mod
    from ratatosk_tpu_torch.correct.engine import Corrector
    from ratatosk_tpu_torch.ops import sprint
    opt = CorrectOpt(small_k=21, k=63, beam_width=8, batch_regions=32,
                     band_width=600)
    genome, corr = testing.build_toy_corrector(seed=5, glen=30000, k=21,
                                               coverage=25.0, opt=opt,
                                               device=cuda_device)
    rng = np.random.default_rng(5)
    reads = [testing.noisy_read(rng, genome, 3000 * i, 2500, err=0.15)[0]
             for i in range(4)]
    widths = []
    orig = beam_mod.sprint_rows

    def spy(*args, smax):
        widths.append(args[0].shape[2])
        return orig(*args, smax=smax)

    steps, plain = (Corrector(corr.cdbg, corr.colors, opt,
                              device=cuda_device, impl=impl)
                    for impl in ("steps", "torch"))
    before = sprint.sprint_rows.launches
    beam_mod.sprint_rows = spy
    try:
        got = steps.correct_batch(reads)
    finally:
        beam_mod.sprint_rows = orig
    assert sprint.sprint_rows.launches > before
    assert max(widths) == 600
    for a, b in zip(got, plain.correct_batch(reads)):
        assert a.codes.tobytes() == b.codes.tobytes()
        assert a.qual.tobytes() == b.qual.tobytes()


@pytest.mark.cuda
def test_mesh_slots_share_the_launch_wide_step_count_on_card(
        cuda_device, monkeypatch):
    """Two slots on one card (two streams): sharded_beam_search on the
    "auto" route, the regions sorted by their own step count so that the
    slots' own counts differ. Each slot's launch 2 reads the launch's T
    (the larger) from its t_launch, and the result equals one launch's."""
    from ratatosk_tpu_torch.ops import beam_kernel as BK
    from ratatosk_tpu_torch.parallel import mesh as TM
    g, rb, lmax, band = region_batch(257, "cpu", r_pad=16)
    f = [BM.beam_phase1(g, BM._rows(rb, r), beam=16, lmax=lmax,
                        band=band).f for r in range(16)]
    order = torch.as_tensor(np.argsort(f, kind="stable"))
    rb = BM.RegionBatch(**{n: getattr(rb, n)[order].to(cuda_device)
                           for n in BM.RegionBatch._DTYPES})
    f = sorted(f)
    assert max(f[:8]) < max(f[8:])
    seen, launch2 = [], BK.enqueue_launch2

    def spy(q):
        seen.append(int(q.t_launch.item()))
        return launch2(q)
    monkeypatch.setattr(BK, "enqueue_launch2", spy)
    mesh = TM.make_mesh(devices=[cuda_device, cuda_device])
    g = g.to(cuda_device)
    got = TM.sharded_beam_search(g, rb, mesh, beam=16, lmax=lmax, band=band,
                                 impl="auto")
    assert seen == [max(f), max(f)]
    want = BM.beam_search(g, rb, beam=16, lmax=lmax, band=band, impl="auto")
    for fl in BM.FIELDS:
        assert torch.equal(getattr(got, fl).to(cuda_device),
                           getattr(want, fl)), fl


@pytest.mark.cuda
def test_fused_beam_wrapper_rejects_bad_inputs_on_card(cuda_device):
    g, rb, lmax, band = region_batch(192, cuda_device, r_pad=8)
    kw = dict(beam=16, lmax=lmax, band=band)
    with pytest.raises(ValueError, match="beam must fit"):
        BM.beam_search(g, rb, beam=256, lmax=lmax, band=band)
    bad = BM.RegionBatch(**{**vars(rb), "tgt_len": rb.tgt_len.long()})
    with pytest.raises(TypeError, match="int32"):
        fused_beam_search(g, bad, **kw)
    bad = BM.RegionBatch(**{**vars(rb), "max_plen": rb.max_plen.cpu()})
    with pytest.raises(ValueError, match="is on cpu"):
        fused_beam_search(g, bad, **kw)
    strided = torch.zeros((8, 2 * rb.tgt_masks.shape[1]), dtype=torch.uint8,
                          device=cuda_device)[:, ::2]
    bad = BM.RegionBatch(**{**vars(rb), "tgt_masks": strided})
    with pytest.raises(ValueError, match="contiguous"):
        fused_beam_search(g, bad, **kw)
    bad = BM.RegionBatch(**{**vars(rb), "end_tip": rb.end_tip[:4]})
    with pytest.raises(ValueError, match="shape"):
        fused_beam_search(g, bad, **kw)


@pytest.mark.cuda
def test_finish_wrapper_rejects_bad_inputs_on_card(cuda_device):
    g, rb, lmax, band = region_batch(192, cuda_device, r_pad=8)
    res = BM.beam_search(g, rb, beam=16, lmax=lmax, band=band, impl="auto")
    bad = BM.BeamResult(**{**vars(res), "best_len": res.best_len.long()})
    with pytest.raises(TypeError, match="int32"):
        _finish(finish_bundle_kernel, rb, bad, band)
    bad = BM.BeamResult(**{**vars(res), "best_len": res.best_len[:4]})
    with pytest.raises(ValueError, match="shape"):
        _finish(finish_bundle_kernel, rb, bad, band)
    bad = BM.BeamResult(**{**vars(res), "completed": res.completed.cpu()})
    with pytest.raises(ValueError, match="is on cpu"):
        _finish(finish_bundle_kernel, rb, bad, band)


class _FakeLib:
    """Stands in for the kernel library: records each launch's tables and
    returns the given error codes in turn."""

    def __init__(self, name, errors):
        self.calls, self._errors = [], list(errors)
        setattr(self, name, self._launch)

    def _launch(self, ptrs, n_ptrs, ints, n_ints, *rest):
        self.calls.append(([ptrs[i] for i in range(n_ptrs)],
                           [ints[i] for i in range(n_ints)], rest))
        return self._errors.pop(0)


def test_beam_launches_pass_the_tables_in_order_and_raise_on_error():
    """The wrapper's two launches get every array's pointer and every size
    in the order of csrc/beam.cu's tables; a launch that fails raises and
    is not counted."""
    from ratatosk_tpu_torch.ops import beam_kernel as BK
    g, rb, lmax, band = region_batch(192, "cpu", r_pad=8)
    lib = _FakeLib("beam_search_launch", [0, 0])
    counted = []
    res = BK.enqueue(lib, g, rb, beam=4, W=192, lmax=lmax, min_cov=2,
                     sprint=8, index=0, stream=None,
                     counted=lambda: counted.append(1))
    assert len(lib.calls) == 2 and len(counted) == 2
    (p1, i1, r1), (p2, i2, r2) = lib.calls
    assert p1 == p2 and i1 == i2 and [r1[0], r2[0]] == [1, 2]
    assert len(p1) == len(BK.PTRS) and len(i1) == len(BK.INTS)
    ints = dict(zip(BK.INTS, i1))
    assert (ints["R"], ints["NT"], ints["B"], ints["W"], ints["lmax"],
            ints["smax"], ints["H"]) == (8, 2048, 4, 192, lmax, 8, 512)
    assert ints["state_words"] == BK.state_words(4) == 11 * 4 + 32
    ptrs = dict(zip(BK.PTRS, p1))
    assert ptrs["tgt_masks"] == rb.tgt_masks.data_ptr()
    assert ptrs["best_seq"] == res.best_seq.data_ptr()
    assert ptrs["useq"] == g.useq.data_ptr()
    assert tuple(res.best_seq.shape) == (8, lmax)
    lib = _FakeLib("beam_search_launch", [0, 700])
    counted.clear()
    with pytest.raises(RuntimeError, match="launch 2 failed"):
        BK.enqueue(lib, g, rb, beam=4, W=192, lmax=lmax, min_cov=2,
                   sprint=8, index=0, stream=None,
                   counted=lambda: counted.append(1))
    assert len(counted) == 1


def test_finish_launch_passes_the_tables_in_order_and_raises_on_error():
    from ratatosk_tpu_torch.ops import finish_kernel as FK
    g, rb, lmax, band = region_batch(192, "cpu", r_pad=8)
    res = BM.beam_search(g, rb, beam=4, lmax=lmax, band=band, impl="torch")
    arrays = dict(tgt_masks=rb.tgt_masks, tgt_len=rb.tgt_len,
                  tgt_qual=rb.tgt_qual, best_seq=res.best_seq,
                  best_len=res.best_len, best_dist=res.best_dist,
                  best_end=res.best_end, second_dist=res.second_dist,
                  completed=res.completed)
    lib = _FakeLib("finish_bundle_launch", [0])
    counted = []
    out = FK.enqueue(lib, arrays, qv_max=QV_MAX, min_k=21, w=band,
                     min_score_open=MIN_SCORE_OPEN, index=0, stream=None,
                     counted=lambda: counted.append(1))
    (ptrs, ints, rest), = lib.calls
    assert len(counted) == 1
    assert dict(zip(FK.INTS, ints)) == dict(R=8, NT=2048, L=lmax, w=band,
                                            qv_max=QV_MAX, min_k=21)
    assert rest[0] == MIN_SCORE_OPEN
    assert ptrs == [arrays[n].data_ptr() for n in FK.PTRS[:9]] + [
        out.scalars.data_ptr(), out.seq_packed.data_ptr(),
        FK._table(torch.device("cpu")).data_ptr()]
    assert tuple(out.seq_packed.shape) == (8, -(-lmax // 16))
    with pytest.raises(RuntimeError, match="finish kernel launch failed"):
        FK.enqueue(_FakeLib("finish_bundle_launch", [1]), arrays,
                   qv_max=QV_MAX, min_k=21, w=band,
                   min_score_open=MIN_SCORE_OPEN, index=0, stream=None,
                   counted=lambda: counted.append(1))
    assert len(counted) == 1


@pytest.mark.parametrize("opt_kw,impl,match", [
    (dict(band_width=1100), "auto", "band_width=1100"),
    (dict(band_width=1100), "steps", "band_width=1100"),
    (dict(weak_region_len_factor=16.0), "auto", "finish band"),
    (dict(weak_region_len_factor=14.0), "auto", "shared memory"),
])
def test_corrector_refuses_kernel_widths_at_construction(opt_kw, impl,
                                                         match):
    """Options whose bands (or, for the finish kernel, paths) a kernel
    cannot take raise ValueError naming the option when the Corrector is
    built for a CUDA device, before anything is uploaded or planned;
    impl="torch" and the CPU take every width."""
    from ratatosk_tpu_torch.correct.engine import (Corrector,
                                                   check_kernel_widths)
    corr, _ = _specs()
    opt = CorrectOpt(small_k=21, k=63, **opt_kw)
    with pytest.raises(ValueError, match=match) as err:
        Corrector(corr.cdbg, corr.colors, opt, device="cuda", impl=impl)
    assert next(iter(opt_kw)) in str(err.value)
    check_kernel_widths(opt, "torch")
    Corrector(corr.cdbg, corr.colors, opt, device="cpu", impl=impl)


@pytest.mark.parametrize("module,args", [
    ("beam_kernel", lambda w: (w,)),
    ("sprint", lambda w: (w,)),
    ("finish_kernel", lambda w: (256, w, w)),
])
def test_each_kernel_refuses_one_column_past_its_cap(module, args):
    """A kernel's refuses() (the wrapper's and the Corrector's one test of
    its widths) takes every band up to MAX_WIDTH and names the band past
    it."""
    import importlib
    mod = importlib.import_module(f"ratatosk_tpu_torch.ops.{module}")
    cap = mod.MAX_WIDTH
    assert mod.refuses(*args(1)) is None
    assert mod.refuses(*args(cap)) is None
    assert f"{cap + 1}-column" in mod.refuses(*args(cap + 1))


@pytest.mark.parametrize("opt_kw,impl", [
    pytest.param(dict(), "auto", id="opt_kw0"),
    pytest.param(dict(band_width=600), "auto", id="opt_kw1"),
    pytest.param(dict(band_width=1024), "auto", id="opt_kw2"),
    pytest.param(dict(weak_region_len_factor=0.6), "auto", id="opt_kw3"),
    pytest.param(dict(band_width=600), "steps", id="steps-600"),
    pytest.param(dict(band_width=1024), "steps", id="steps-1024"),
])
def test_kernel_widths_up_to_the_caps_are_taken(opt_kw, impl):
    from ratatosk_tpu_torch.correct.engine import check_kernel_widths
    check_kernel_widths(CorrectOpt(**opt_kw), impl)
