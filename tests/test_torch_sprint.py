"""Port's sprint band update (ratatosk_tpu_torch/ops/sprint.py) against the
NumPy oracle of tests/test_sprint_pallas.py and the JAX package's Pallas
kernel in interpret mode. Every comparison is exact (integer DP rows and
masks): tolerance 0.

The CUDA kernel itself runs only on a card: its case is marked `cuda` and
skips where torch sees no CUDA device. JAX is imported inside the tests that
use it, so the card's case also runs where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_sprint.py
"""

import numpy as np
import pytest
import torch

from ratatosk_tpu_torch.ops import sprint as SP


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and the tensors here are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, R, B, W, smax, ws_hi=50):
    """Random band state with plausible monotone window starts (delta in
    {0,1} per substep), as tests/test_sprint_pallas.py builds them."""
    rng = np.random.default_rng(seed)
    rwin = rng.integers(0, 200, (R, B, W)).astype(np.int32)
    btgt = (1 << rng.integers(0, 4, (R, W))).astype(np.int32)
    nb = rng.integers(0, 4, (R, B, smax - 1)).astype(np.int32)
    newcols = (1 << rng.integers(0, 4, (R, smax - 1))).astype(np.int32)
    ws0 = rng.integers(0, ws_hi, R)
    deltas = rng.integers(0, 2, (R, smax - 1))
    wsall = (ws0[:, None] + np.concatenate(
        [np.zeros((R, 1), int), np.cumsum(deltas, axis=1)], axis=1)
    ).astype(np.int32)
    # a few regions start at window 0 so the column-0 boundary is exercised
    wsall[::3] -= wsall[::3, :1]
    mreg = rng.integers(0, smax, R).astype(np.int32)
    live = rng.integers(0, 2, (R, B)).astype(np.int32)
    plen = rng.integers(0, 100, (R, B)).astype(np.int32)
    return rwin, btgt, nb, newcols, wsall, mreg, live, plen


def _torch(arrs, device):
    return [torch.tensor(a, device=device) for a in arrs]


@pytest.mark.parametrize("R,B,W,block_r", [
    (5, 4, 37, 4),     # uneven region blocks: the JAX kernel's pad path
    (8, 4, 257, 8),    # the exact NT=256 bucket's band
    (6, 4, 192, 8),    # the banded NT=2048 bucket's band
    (3, 2, 513, 4),    # one column past the old 512-column cap
    (2, 4, 1024, 8),   # the widest band the kernel takes
    (2, 33, 40, 8),    # more entries than a warp has lanes
])
def test_sprint_ref_matches_oracle_and_jax(R, B, W, block_r):
    import jax.numpy as jnp
    from ratatosk_tpu.ops.sprint_pallas import sprint_rows as jax_sprint_rows
    from tests import test_sprint_pallas as ORACLE
    smax = 8
    arrs = _inputs(R * 1000 + W, R, B, W, smax)
    got_r, got_b = SP.sprint_rows(*_torch(arrs, "cpu"), smax=smax)
    want_r, want_b = ORACLE._ref_sprint(*arrs, smax)
    np.testing.assert_array_equal(got_r.numpy(), want_r)
    np.testing.assert_array_equal(got_b.numpy(), want_b)
    jr, jb = jax_sprint_rows(*map(jnp.asarray, arrs), smax=smax,
                             interpret=True, block_r=block_r)
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(jb))


def test_cpu_tensors_take_the_plain_version():
    arrs = _torch(_inputs(3, 2, 2, 40, 8), "cpu")
    before = SP.sprint_rows.launches
    SP.sprint_rows(*arrs, smax=8)
    assert SP.sprint_rows.launches == before


def test_no_silent_fallback_off_the_cpu():
    """Only a CPU tensor takes the plain version: any other device gets the
    kernel or an error, never the plain version."""
    arrs = [a.to("meta") for a in _torch(_inputs(4, 2, 2, 40, 8), "cpu")]
    with pytest.raises(ValueError, match="no kernel"):
        SP.sprint_rows(*arrs, smax=8)


def _fake_library(**widths):
    """Stands in for the loaded kernel library: every entry point, the
    *_max_width exports returning the wrappers' caps (or `widths`)."""
    import types

    from ratatosk_tpu_torch.ops import align_kernel, beam_kernel, finish_kernel

    def entry(value=None):
        def fn(*args):
            return value
        return fn
    caps = dict(dict(sprint_rows_max_width=SP.MAX_WIDTH,
                     beam_search_max_width=beam_kernel.MAX_WIDTH,
                     finish_bundle_max_width=finish_kernel.MAX_WIDTH,
                     edit_distance_max_width=align_kernel.MAX_WIDTH),
                **widths)
    return types.SimpleNamespace(**{
        name: entry(caps.get(name)) for name in (
            "sprint_rows_launch", "sprint_rows_max_width",
            "beam_search_launch", "beam_search_max_width",
            "finish_bundle_launch", "finish_bundle_max_width",
            "plan_runs_launch", "plan_probe_launch",
            "edit_distance_launch", "edit_distance_max_width")})


def test_library_load_refuses_a_width_cap_its_wrapper_does_not_share(
        monkeypatch):
    """A kernel's widest band is a constant of its source and its wrapper's
    MAX_WIDTH: loading a library whose export differs raises, once, before
    any launch."""
    from ratatosk_tpu_torch.ops import cuda_lib
    monkeypatch.setattr(cuda_lib, "_lib", None)
    monkeypatch.setattr(cuda_lib, "build_library", lambda: "libfake.so")
    monkeypatch.setattr(cuda_lib.ctypes, "CDLL", lambda path: _fake_library(
        finish_bundle_max_width=4096))
    with pytest.raises(RuntimeError, match="finish_bundle_max_width"):
        cuda_lib.library()
    assert cuda_lib._lib is None
    monkeypatch.setattr(cuda_lib.ctypes, "CDLL",
                        lambda path: _fake_library())
    assert cuda_lib.library() is cuda_lib._lib


def test_library_builds_once_under_concurrent_first_use(monkeypatch):
    """Mesh slots reach their first launch from several threads at once:
    the library is built and loaded once, every thread gets it, and every
    entry point of the kernels has its signature set."""
    import threading
    import time

    from ratatosk_tpu_torch.ops import cuda_lib

    builds, loads = [], []

    def slow_build():
        builds.append(threading.get_ident())
        time.sleep(0.05)
        return "libfake.so"

    def fake_cdll(path):
        loads.append(path)
        return _fake_library()

    monkeypatch.setattr(cuda_lib, "_lib", None)
    monkeypatch.setattr(cuda_lib, "build_library", slow_build)
    monkeypatch.setattr(cuda_lib.ctypes, "CDLL", fake_cdll)
    got = []
    threads = [threading.Thread(target=lambda: got.append(cuda_lib.library()))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(builds) == 1 and loads == ["libfake.so"]
    assert len(got) == 4 and all(lib is got[0] for lib in got)
    lib = got[0]
    for name, (res, args) in cuda_lib.SIGNATURES.items():
        fn = getattr(lib, name)
        assert fn.restype is res and fn.argtypes == args, name
    # pointers and the stream are void pointers, never 32-bit ints
    for name in ("beam_search_launch", "finish_bundle_launch",
                 "plan_runs_launch", "plan_probe_launch"):
        args = cuda_lib.SIGNATURES[name][1]
        assert args[0] is cuda_lib.ctypes.c_void_p
        assert args[2] is cuda_lib.ctypes.c_void_p
        assert args[-1] is cuda_lib.ctypes.c_void_p


def test_nvcc_flags_keep_float_math_exact():
    """The beam kernel's float32 scores must round as PyTorch's do: no FMA
    contraction, no fast-math division."""
    from ratatosk_tpu_torch.ops import cuda_lib
    assert "-fmad=false" in cuda_lib.NVCC_FLAGS
    assert not any("fast_math" in f or "fast-math" in f
                   for f in cuda_lib.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in cuda_lib.NVCC_FLAGS


def test_every_kernel_source_is_built():
    """build_library compiles every csrc/*.cu: the three kernels' sources
    are there, and each defines the entry points registered for it."""
    from ratatosk_tpu_torch.ops import cuda_lib
    srcs = {p.name: p.read_text() for p in cuda_lib.SRC_DIR.glob("*.cu")}
    assert {"sprint.cu", "beam.cu", "finish.cu"} <= set(srcs)
    text = "".join(srcs.values())
    for name in cuda_lib.SIGNATURES:
        assert f'extern "C" int {name}(' in text, name


@pytest.mark.parametrize("fault, exc, match", [
    ("device", ValueError, "x is on meta, expected cpu"),
    ("dtype", TypeError, "x must be torch.int32"),
    ("shape", ValueError, r"x has shape \(4, 6\), expected \(4, 3\)"),
    ("stride", ValueError, "x must be contiguous"),
])
def test_check_tensor_names_the_fault(fault, exc, match):
    """The three wrappers' one input check: a tensor that is fine passes,
    each fault raises with the wrapper's and the argument's names."""
    from ratatosk_tpu_torch.ops import cuda_lib
    cpu = torch.device("cpu")
    ok = torch.zeros((4, 3), dtype=torch.int32)
    cuda_lib.check_tensor("fn", "x", ok, torch.int32, (4, 3), cpu)
    cuda_lib.check_tensor("fn", "x", ok, torch.int32, None, cpu)
    bad = {"device": ok.to("meta"), "dtype": ok.long(),
           "shape": torch.zeros((4, 6), dtype=torch.int32),
           "stride": torch.zeros((4, 6), dtype=torch.int32)[:, ::2]}[fault]
    with pytest.raises(exc, match=f"fn: {match}"):
        cuda_lib.check_tensor("fn", "x", bad, torch.int32, (4, 3), cpu)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sprint kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("W", [257, 192, 336])
def test_sprint_kernel_matches_ref_on_card(cuda_device, W):
    R, B, smax = 512, 16, 8
    arrs = _torch(_inputs(W, R, B, W, smax, ws_hi=400), cuda_device)
    before = SP.sprint_rows.launches
    kr, kb = SP.sprint_rows(*arrs, smax=smax)
    torch.cuda.synchronize()
    assert SP.sprint_rows.launches == before + 1
    rr, rbt = SP.sprint_rows_ref(*arrs, smax=smax)
    assert torch.equal(kr, rr)
    assert torch.equal(kb, rbt)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 128, 512])
@pytest.mark.parametrize("B", [1, 16, 33])
@pytest.mark.parametrize("W", [1, 32, 33, 257, 512, 513, 1024])
def test_sprint_kernel_shapes_on_card(cuda_device, W, B, R):
    """Every lane count (W=1: one lane, 32: one column a lane, 33: two),
    the old cap and one past it, the widest band; one entry, a warp's
    worth and more; one region and the engine's paddings."""
    smax = 8
    arrs = _torch(_inputs(W * 1000 + B * 10 + R, R, B, W, smax, ws_hi=400),
                  cuda_device)
    kr, kb = SP.sprint_rows(*arrs, smax=smax)
    torch.cuda.synchronize()
    rr, rbt = SP.sprint_rows_ref(*arrs, smax=smax)
    assert torch.equal(kr, rr)
    assert torch.equal(kb, rbt)


def _edge_inputs(kind, smax, R=64, B=16, W=257):
    """Band state with every entry dead, every m_reg 0, or every window
    starting at column 0 (the DP's column 0 set in each substep); or rows
    that are no DP rows: up to +-2^27 beside BIG with windows before
    column 0 (no value wraps), or from BIG up to 2^31 - 1 (values wrap)."""
    arrs = list(_inputs(len(kind) * smax, R, B, W, smax, ws_hi=400))
    if kind == "all_dead":
        arrs[6][:] = 0
    elif kind == "no_substeps":
        arrs[5][:] = 0
    elif kind == "window_at_zero":
        arrs[4] -= arrs[4][:, :1]
        arrs[5][:] = smax - 1
        arrs[6][:] = 1
    elif kind == "large_rows":
        rng = np.random.default_rng(smax)
        arrs[0] = rng.integers(-2**27, 2**27, arrs[0].shape,
                               dtype=np.int64).astype(np.int32)
        arrs[0][:, :, ::3] = SP.BIG
        arrs[7] = rng.integers(-2**27, 2**27, arrs[7].shape,
                               dtype=np.int64).astype(np.int32)
        arrs[4] -= 30
    elif kind == "big_rows":
        rng = np.random.default_rng(smax)
        arrs[0] = rng.integers(SP.BIG - 3, 2**31 - 1, arrs[0].shape,
                               dtype=np.int64).astype(np.int32)
        arrs[0][:, :, ::7] = SP.BIG
    return arrs


@pytest.mark.cuda
@pytest.mark.parametrize("smax", [2, 8])
@pytest.mark.parametrize("kind", ["all_dead", "no_substeps",
                                  "window_at_zero", "large_rows",
                                  "big_rows"])
def test_sprint_kernel_edge_batches_on_card(cuda_device, kind, smax):
    arrs = _torch(_edge_inputs(kind, smax), cuda_device)
    kr, kb = SP.sprint_rows(*arrs, smax=smax)
    torch.cuda.synchronize()
    rr, rbt = SP.sprint_rows_ref(*arrs, smax=smax)
    assert torch.equal(kr, rr)
    assert torch.equal(kb, rbt)
    if kind in ("all_dead", "no_substeps"):
        assert torch.equal(kr, arrs[0])


@pytest.mark.parametrize("kind", ["all_dead", "no_substeps",
                                  "window_at_zero", "large_rows",
                                  "big_rows"])
def test_sprint_edge_batches_match_jax(kind):
    """The card's edge batches, on the CPU: the plain version against the
    JAX kernel in interpret mode (int32 throughout, as both packages wrap;
    the NumPy oracle widens to int64 on rows near 2^31). Windows that
    start before column 0 (large_rows) never occur in a beam search, and
    there the JAX kernel parts from its own NumPy oracle: that case is
    held to the oracle."""
    import jax.numpy as jnp
    from ratatosk_tpu.ops.sprint_pallas import sprint_rows as jax_sprint_rows
    from tests import test_sprint_pallas as ORACLE
    arrs = _edge_inputs(kind, 8, R=4, B=3, W=40)
    got_r, got_b = SP.sprint_rows(*_torch(arrs, "cpu"), smax=8)
    if kind == "large_rows":
        want_r, want_b = ORACLE._ref_sprint(*arrs, 8)
    else:
        want_r, want_b = jax_sprint_rows(*map(jnp.asarray, arrs), smax=8,
                                         interpret=True, block_r=4)
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))


@pytest.mark.cuda
def test_sprint_wrapper_rejects_bad_inputs_on_card(cuda_device):
    arrs = _torch(_inputs(5, 4, 2, 64, 8), cuda_device)
    with pytest.raises(TypeError, match="int32"):
        SP.sprint_rows(arrs[0].long(), *arrs[1:], smax=8)
    strided = torch.empty((4, 2, 128), dtype=torch.int32,
                          device=cuda_device)[..., ::2]
    strided.copy_(arrs[0])
    with pytest.raises(ValueError, match="contiguous"):
        SP.sprint_rows(strided, *arrs[1:], smax=8)
    with pytest.raises(ValueError, match="is on cpu"):
        SP.sprint_rows(*arrs[:-1], arrs[-1].cpu(), smax=8)
    with pytest.raises(ValueError, match="shape"):
        SP.sprint_rows(*arrs, smax=7)
