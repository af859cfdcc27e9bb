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


def test_library_builds_once_under_concurrent_first_use(monkeypatch):
    """Mesh slots reach their first launch from several threads at once:
    the library is built and loaded once, and every thread gets it."""
    import threading
    import time
    import types

    builds, loads = [], []

    def slow_build():
        builds.append(threading.get_ident())
        time.sleep(0.05)
        return "libfake.so"

    def fake_cdll(path):
        loads.append(path)
        return types.SimpleNamespace(
            sprint_rows_launch=types.SimpleNamespace(),
            sprint_rows_max_width=types.SimpleNamespace())

    monkeypatch.setattr(SP, "_lib", None)
    monkeypatch.setattr(SP, "build_library", slow_build)
    monkeypatch.setattr(SP.ctypes, "CDLL", fake_cdll)
    got = []
    threads = [threading.Thread(target=lambda: got.append(SP._library()))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(builds) == 1 and loads == ["libfake.so"]
    assert len(got) == 4 and all(lib is got[0] for lib in got)


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
