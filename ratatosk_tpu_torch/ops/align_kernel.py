"""The batched edit distance in one hand-written CUDA kernel
(csrc/align.cu), and its wrapper.

`edit_distance_kernel` takes what ops.align.edit_distance_ref takes and
returns the same AlignResult, bit for bit. On a CPU tensor it runs that
plain version; on a CUDA tensor it launches the kernel or raises.
ops.align.edit_distance(impl="auto") calls it and leaves it the choice.

The reference computes it in plain JAX (ratatosk_tpu/ops/align.py: a
lax.scan over the query's bases, one lax.cummin per row); the plain torch
version loops over the query's bases in Python. The kernel gives each pair
one warp that runs the DP rows 1..a_len, bit-parallel over the target's
columns (csrc/align.cu says how). It takes targets of up to MAX_WIDTH
columns (registers: 16 words of 32 columns a lane) and any query length
with M + N below BIG.
"""

from __future__ import annotations

import torch

from ratatosk_tpu_torch.ops import align as A
from ratatosk_tpu_torch.ops import cuda_lib

# the pointer table of csrc/align.cu's edit_distance_launch, in its order
PTRS = ("a_masks", "a_len", "b_masks", "b_len", "dist", "end", "end_min",
        "last_row")
INTS = ("B", "M", "N", "mode")
# the widest target the kernel takes (csrc/align.cu: kMaxN, 16 words a
# lane; cuda_lib checks the library's export against it once, at load)
MAX_WIDTH = 16384


def refuses(M: int, N: int):
    """Why the kernel cannot take M query and N target columns, or None:
    the one test of its limits, which the wrapper makes."""
    if N > MAX_WIDTH:
        return f"a {N}-column target (at most {MAX_WIDTH})"
    if M + N >= A._BIG:
        return f"M + N = {M + N} (values must stay below {A._BIG})"
    return None


@cuda_lib.counted
def edit_distance_kernel(a_masks, a_len, b_masks, b_len,
                         mode: int = A.NW) -> A.AlignResult:
    """ops.align.edit_distance_ref in one kernel launch on the current
    stream; a CPU tensor takes the plain version."""
    dev = a_masks.device
    if dev.type == "cpu":
        return A.edit_distance_ref(a_masks, a_len, b_masks, b_len, mode)
    if dev.type != "cuda":
        raise ValueError(f"edit_distance_kernel: no kernel for device {dev}")
    if mode not in (A.NW, A.SHW, A.HW):
        raise ValueError(f"edit_distance_kernel: mode is NW, SHW or HW, "
                         f"not {mode}")
    if a_masks.dim() != 2 or b_masks.dim() != 2:
        raise ValueError("edit_distance_kernel: a_masks and b_masks are "
                         "[B, M] and [B, N]")
    B, M = a_masks.shape
    N = b_masks.shape[1]
    arrays = dict(a_masks=a_masks, a_len=a_len, b_masks=b_masks, b_len=b_len)
    shapes = dict(a_masks=(B, M), a_len=(B,), b_masks=(B, N), b_len=(B,))
    for name, t in arrays.items():
        cuda_lib.check_tensor(
            "edit_distance_kernel", name, t,
            torch.uint8 if name.endswith("masks") else torch.int32,
            shapes[name], dev)
    why = refuses(M, N)
    if why:
        raise ValueError(f"edit_distance_kernel: unsupported shape B={B} "
                         f"M={M} N={N}: {why}")
    lib = cuda_lib.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    return enqueue(lib, arrays, mode=mode, index=cuda_lib.device_index(dev),
                   stream=stream,
                   counted=lambda: cuda_lib.add_launches(edit_distance_kernel,
                                                         stream))


def enqueue(lib, arrays, *, mode, index, stream, counted) -> A.AlignResult:
    """Allocate the outputs beside the (checked) inputs and enqueue the
    kernel on CUDA device `index`, stream `stream`; counted() after the
    launch (none for an empty batch)."""
    dev = arrays["a_masks"].device
    B, M = arrays["a_masks"].shape
    N = arrays["b_masks"].shape[1]
    out = A.AlignResult(
        *(torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3)),
        torch.empty((B, N + 1), dtype=torch.int32, device=dev))
    if B == 0:
        return out
    ptrs = dict(arrays, dist=out.dist, end=out.end, end_min=out.end_min,
                last_row=out.last_row)
    ints = dict(B=B, M=M, N=N, mode=mode)
    err = cuda_lib.call_on(
        index, lib.edit_distance_launch,
        cuda_lib.pointer_table([ptrs[n] for n in PTRS]), len(PTRS),
        cuda_lib.int_table([ints[n] for n in INTS]), len(INTS), index, stream)
    if err != 0:
        raise RuntimeError(f"align kernel launch failed: CUDA error {err} "
                           f"(B={B} M={M} N={N} mode={mode})")
    counted()
    return out
