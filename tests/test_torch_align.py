"""The port's batched edit distance (ratatosk_tpu_torch/ops/align.py)
against the JAX package's ops/align.py, tolerance 0: edit_distance in the
three modes, row_init, extend_rows carried row by row and
best_prefix_from_row, on the same seeded inputs (IUPAC masks, zero and
arbitrary padding, a_len 0 and past M, b_len 0, past N and negative: NW
reads column b_len as JAX's take_along_axis does, a negative index once
from the end and INT32_MIN outside the row). Then the
kernel wrapper (ops/align_kernel.py): what it refuses, that a CUDA tensor
never takes the plain version, and its launch tables; and, on the card,
the kernel against its plain version (this file imports JAX only inside
its CPU tests: the card's machine has none)."""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from ratatosk_tpu_torch import dna
from ratatosk_tpu_torch.ops import align as A
from ratatosk_tpu_torch.ops import align_kernel as AK
from ratatosk_tpu_torch.ops import cuda_lib

MODES = {"NW": A.NW, "SHW": A.SHW, "HW": A.HW}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

R_MASK, N_MASK = 1 | 4, 15            # IUPAC R (A/G) and N


def pairs(seed, B, M, N, *, junk=False):
    """Seeded pairs: ACGT masks with some R and N, the target a mutated
    copy of the query on odd rows; padding zero (or arbitrary bytes when
    `junk`); lengths covering 0, M or N, and past them."""
    rng = np.random.default_rng(seed)
    a = dna.codes_to_masks(rng.integers(0, 4, (B, M)).astype(np.uint8))
    b = dna.codes_to_masks(rng.integers(0, 4, (B, N)).astype(np.uint8))
    L = min(M, N)
    b[1::2, :L] = a[1::2, :L]
    flip = rng.random((B, N)) < 0.15
    b[flip] = dna.codes_to_masks(rng.integers(0, 4, int(flip.sum())).astype(
        np.uint8))
    for x in (a, b):
        x[rng.random(x.shape) < 0.05] = R_MASK
        x[rng.random(x.shape) < 0.03] = N_MASK
    a_len = rng.integers(0, M + 1, B).astype(np.int32)
    b_len = rng.integers(0, N + 1, B).astype(np.int32)
    a_len[:4] = [0, M, M + 3, -1][:min(B, 4)]
    b_len[-5:] = [-(N + 3), 0, N, N + 5, -2][-min(B, 5):]
    for x, n in ((a, a_len), (b, b_len)):
        pad = np.arange(x.shape[1])[None, :] >= n[:, None]
        x[pad] = (rng.integers(0, 256, int(pad.sum())).astype(np.uint8)
                  if junk else 0)
    return a, a_len, b, b_len


def _jax_align():
    import jax.numpy as jnp
    from ratatosk_tpu.ops import align as JA
    return jnp, JA


def _jax(mode, a, al, b, bl):
    jnp, JA = _jax_align()
    r = JA.edit_distance(jnp.asarray(a), jnp.asarray(al), jnp.asarray(b),
                         jnp.asarray(bl), mode=mode)
    return [np.asarray(x) for x in r]


def _torch(mode, a, al, b, bl, **kw):
    r = A.edit_distance(torch.tensor(a), torch.tensor(al), torch.tensor(b),
                        torch.tensor(bl), mode, **kw)
    for x in r:
        assert x.dtype == torch.int32
    return [x.numpy() for x in r]


@pytest.mark.parametrize("junk", [False, True], ids=["zero_pad", "junk_pad"])
@pytest.mark.parametrize("shape", [(16, 24, 32), (8, 64, 17), (12, 5, 64),
                                   (4, 1, 1), (3, 1, 9), (5, 7, 0)],
                         ids=lambda s: "B{}_M{}_N{}".format(*s))
@pytest.mark.parametrize("mode", list(MODES), ids=list(MODES))
def test_edit_distance_matches_jax(mode, shape, junk):
    args = pairs(sum(shape) + junk, *shape, junk=junk)
    want = _jax(MODES[mode], *args)
    for impl in ("auto", "torch"):
        got = _torch(MODES[mode], *args, impl=impl)
        for g, w, name in zip(got, want, A.AlignResult._fields):
            np.testing.assert_array_equal(g, w, err_msg=f"{name} {impl}")


@pytest.mark.parametrize("mode", list(MODES), ids=list(MODES))
def test_row_init_and_extend_rows_carried_match_jax(mode):
    """Rows carried one query base at a time, as the beam engine carries
    them, equal the JAX package's after every step."""
    jnp, JA = _jax_align()
    a, _, b, b_len = pairs(5, 8, 40, 48)
    m = MODES[mode]
    jrow = JA.row_init(8, 48, m)
    trow = A.row_init(8, 48, m)
    assert trow.dtype == torch.int32
    np.testing.assert_array_equal(trow.numpy(), np.asarray(jrow))
    for i in range(a.shape[1]):
        num = np.full(8, i + 1, np.int32)
        jrow = JA.extend_rows(jrow, jnp.asarray(a[:, i]), jnp.asarray(b),
                              jnp.asarray(num))
        trow = A.extend_rows(trow, torch.tensor(a[:, i]), torch.tensor(b),
                             torch.tensor(num))
        np.testing.assert_array_equal(trow.numpy(), np.asarray(jrow))
    want = JA.best_prefix_from_row(jrow, jnp.asarray(b_len))
    got = A.best_prefix_from_row(trow, torch.tensor(b_len))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_best_prefix_from_row_is_the_shw_answer():
    a, al, b, bl = pairs(9, 16, 30, 40)
    al[:] = np.clip(al, 0, 30)
    res = A.edit_distance(*map(torch.tensor, (a, al, b, bl)), A.SHW)
    full = A.edit_distance(*map(torch.tensor, (a, al, b, bl + 100)), A.SHW)
    got = A.best_prefix_from_row(full.last_row, torch.tensor(bl))
    for g, w in zip(got, res[:3]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mode", list(MODES), ids=list(MODES))
def test_empty_query_takes_row_zero(mode):
    """M = 0 (a shape the JAX scan does not trace): a_len 0 takes row 0,
    any other a_len is never captured."""
    b = np.array([[1, 2, 4], [8, 0, 15]], np.uint8)
    got = A.edit_distance(torch.zeros((2, 0), dtype=torch.uint8),
                          torch.tensor([0, 1], dtype=torch.int32),
                          torch.tensor(b), torch.tensor([2, 3],
                                                        dtype=torch.int32),
                          MODES[mode])
    row0 = A.row_init(1, 3, MODES[mode])[0].tolist()
    assert got.last_row.tolist() == [row0[:3] + [A._BIG], [A._BIG] * 4]
    assert got.dist.tolist()[1] == A._BIG


def test_zero_mask_matches_nothing_and_n_matches_every_base():
    a = np.array([[0, 0], [N_MASK, N_MASK]], np.uint8)
    b = np.array([[0, 0], [1, 8]], np.uint8)
    ln = np.array([2, 2], np.int32)
    got = _torch(A.NW, a, ln, b, ln)
    np.testing.assert_array_equal(got[0], [2, 0])
    np.testing.assert_array_equal(got[0], _jax(A.NW, a, ln, b, ln)[0])


def test_refuses_unknown_impl_and_mode():
    args = [torch.tensor(x) for x in pairs(1, 2, 3, 3)]
    with pytest.raises(ValueError, match="impl"):
        A.edit_distance(*args, impl="triton")
    with pytest.raises(ValueError, match="mode"):
        A.edit_distance(*args, mode=7)


# ---- the kernel's wrapper off the card ----

def _fake_cuda(a, al, b, bl, **dtypes):
    """Fake CUDA tensors of the inputs' shapes (no card needed): what the
    wrapper sees before it launches."""
    with FakeTensorMode():
        return [torch.empty(x.shape, dtype=dtypes.get(n, d), device="cuda")
                for n, x, d in (("a_masks", a, torch.uint8),
                                ("a_len", al, torch.int32),
                                ("b_masks", b, torch.uint8),
                                ("b_len", bl, torch.int32))]


@pytest.fixture
def no_library(monkeypatch, tmp_path):
    """A machine without nvcc and without a built library."""
    def missing():
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    monkeypatch.setattr(cuda_lib, "_lib", None)
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_lib, "nvcc", missing)


@pytest.mark.parametrize("impl_call", ["wrapper", "edit_distance_auto"])
def test_cuda_tensor_without_library_raises(no_library, impl_call):
    """A CUDA tensor gets the kernel or an error, never the plain version."""
    args = _fake_cuda(*pairs(2, 4, 8, 8))
    before = AK.edit_distance_kernel.launches
    with pytest.raises(RuntimeError, match="nvcc not found"):
        if impl_call == "wrapper":
            AK.edit_distance_kernel(*args, mode=A.SHW)
        else:
            A.edit_distance(*args, A.SHW)
    assert AK.edit_distance_kernel.launches == before


@pytest.mark.parametrize("bad,exc,match", [
    (dict(a_len=torch.int64), TypeError, "a_len must be torch.int32"),
    (dict(b_masks=torch.int32), TypeError, "b_masks must be torch.uint8"),
], ids=["a_len_int64", "b_masks_int32"])
def test_wrapper_refuses_wrong_dtypes(no_library, bad, exc, match):
    with pytest.raises(exc, match=match):
        AK.edit_distance_kernel(*_fake_cuda(*pairs(2, 4, 8, 8), **bad))


def test_wrapper_refuses_wrong_shapes_devices_and_width(no_library):
    a, al, b, bl = _fake_cuda(*pairs(2, 4, 8, 8))
    with FakeTensorMode():
        short = torch.empty(2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="shape"):
        AK.edit_distance_kernel(a, short, b, bl)
    with pytest.raises(ValueError, match="is on cpu"):
        AK.edit_distance_kernel(a, torch.zeros(4, dtype=torch.int32), b, bl)
    with pytest.raises(ValueError, match="mode"):
        AK.edit_distance_kernel(a, al, b, bl, mode=3)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        AK.edit_distance_kernel(*(x.to("meta") for x in map(
            torch.tensor, pairs(2, 4, 8, 8))))
    wide = _fake_cuda(*pairs(2, 2, 4, 4))
    with FakeTensorMode():
        wide[2] = torch.empty((2, AK.MAX_WIDTH + 1), dtype=torch.uint8,
                              device="cuda")
    with pytest.raises(ValueError, match=f"at most {AK.MAX_WIDTH}"):
        AK.edit_distance_kernel(*wide)
    assert AK.refuses(5376, 5376) is None
    assert AK.refuses(4, AK.MAX_WIDTH) is None


class _FakeLib:
    def __init__(self, errors):
        self.calls, self._errors = [], list(errors)

    def edit_distance_launch(self, ptrs, n_ptrs, ints, n_ints, *rest):
        self.calls.append(([ptrs[i] for i in range(n_ptrs)],
                           [ints[i] for i in range(n_ints)], rest))
        return self._errors.pop(0)


def test_launch_passes_the_tables_in_order_and_raises_on_error():
    arrays = dict(zip(("a_masks", "a_len", "b_masks", "b_len"),
                      map(torch.tensor, pairs(3, 6, 10, 12))))
    counted = []
    lib = _FakeLib([0])
    out = AK.enqueue(lib, arrays, mode=A.HW, index=0, stream=None,
                     counted=lambda: counted.append(1))
    (ptrs, ints, rest), = lib.calls
    assert counted == [1] and rest == (0, None)
    assert dict(zip(AK.INTS, ints)) == dict(B=6, M=10, N=12, mode=A.HW)
    assert ptrs == [arrays[n].data_ptr() for n in AK.PTRS[:4]] + [
        out.dist.data_ptr(), out.end.data_ptr(), out.end_min.data_ptr(),
        out.last_row.data_ptr()]
    assert tuple(out.last_row.shape) == (6, 13)
    assert all(x.dtype == torch.int32 for x in out)
    with pytest.raises(RuntimeError, match="align kernel launch failed"):
        AK.enqueue(_FakeLib([1]), arrays, mode=A.NW, index=0, stream=None,
                   counted=lambda: counted.append(1))
    assert counted == [1]
    empty = {n: t[:0] for n, t in arrays.items()}
    lib = _FakeLib([])
    AK.enqueue(lib, empty, mode=A.NW, index=0, stream=None,
               counted=lambda: counted.append(1))
    assert lib.calls == [] and counted == [1]


def test_library_registers_the_align_entry_points():
    assert "edit_distance_launch" in cuda_lib.SIGNATURES
    args = cuda_lib.SIGNATURES["edit_distance_launch"][1]
    assert args[0] is cuda_lib.ctypes.c_void_p
    assert args[2] is cuda_lib.ctypes.c_void_p
    assert args[-1] is cuda_lib.ctypes.c_void_p
    src = (cuda_lib.SRC_DIR / "align.cu").read_text()
    assert f"kMaxK = {AK.MAX_WIDTH // 1024};" in src


# ---- on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("junk", [False, True], ids=["zero_pad", "junk_pad"])
@pytest.mark.parametrize("shape", [(64, 256, 256), (16, 300, 2048),
                                   (8, 100, 5376), (5, 7, 0), (6, 40, 1),
                                   (3, 0, 9), (4, 20, 16384)],
                         ids=lambda s: "B{}_M{}_N{}".format(*s))
@pytest.mark.parametrize("mode", list(MODES), ids=list(MODES))
def test_kernel_matches_plain_on_card(cuda_device, mode, shape, junk):
    args = [torch.tensor(x, device=cuda_device)
            for x in pairs(sum(shape), *shape, junk=junk)]
    before = AK.edit_distance_kernel.launches
    got = A.edit_distance(*args, MODES[mode])
    torch.cuda.synchronize()
    assert AK.edit_distance_kernel.launches == before + 1
    want = A.edit_distance(*args, MODES[mode], impl="torch")
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w)
