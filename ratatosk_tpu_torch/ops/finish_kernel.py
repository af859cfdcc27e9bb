"""The finish bundle in one hand-written CUDA kernel (csrc/finish.cu), and
its wrapper.

`finish_bundle_kernel` takes what correct.finish.finish_bundle takes and
returns the same FinishOut: the 11 int32 decision scalars per region and the
2-bit-packed winner. On a CPU tensor it runs that plain version; on a CUDA
tensor it launches the kernel or raises.

The reference computes it in plain JAX (ratatosk_tpu/correct/finish.py: a
lax.scan over every target row of the bucket, then the gates); the plain
torch version loops over those rows in Python. The kernel gives each region
one warp that runs the banded target x path DP row by row, bit-parallel
over the band's columns (csrc/finish.cu says how), and stops at the
region's own last needed row, max(tgt_len, best_end): the decisions read
the per-prefix minima only at tgt_len, at best_end and at the first argmax
of i - 2*dmin[i] over i <= tgt_len, so it keeps those and nothing per row.
It takes band widths up to MAX_WIDTH columns. The wrapper passes one
constant table beside the inputs: the least prefix sum of each pair of
difference bytes (int8 [65536], made once per device).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ratatosk_tpu_torch.correct import finish as FN
from ratatosk_tpu_torch.ops import cuda_lib

# the pointer table of csrc/finish.cu's finish_bundle_launch, in its order
PTRS = ("tgt_masks", "tgt_len", "tgt_qual", "best_seq", "best_len",
        "best_dist", "best_end", "second_dist", "completed", "scalars",
        "seq_packed", "minpre")
INTS = ("R", "NT", "L", "w", "qv_max", "min_k")
# the widest band the kernel takes (csrc/finish.cu: kMaxW, 8 words a lane;
# cuda_lib checks the library's export against it once, at load)
MAX_WIDTH = 8192
# shared memory of a block (the card's limit, checked in csrc/finish.cu)
MAX_SHARED = 227 * 1024


def refuses(NT: int, L: int, W: int):
    """Why the kernel cannot take a launch of NT target rows, paths of L
    bases and a W-column band, or None: the one test of its limits, which
    the wrapper and engine.check_kernel_widths make. Shared memory (as
    csrc/finish.cu's finish_bundle_launch lays it out) holds the 64 KiB
    table, then for each of the block's 4 warps the two bit-planes of the
    path's codes and the target's masks."""
    if not 1 <= W <= MAX_WIDTH:
        return f"a {W}-column finish band (at most {MAX_WIDTH})"
    smem = (1 << 16) + 4 * 4 * (2 * (L // 32 + 2) + (NT + 3) // 4)
    if smem > MAX_SHARED:
        return (f"{L}-base paths at NT={NT} ({smem} bytes of shared memory, "
                f"at most {MAX_SHARED})")
    return None


_tables: dict = {}
_tables_lock = threading.Lock()


def min_prefix_table() -> np.ndarray:
    """int8 [65536]: at p | m << 8, the least of the 8 prefix sums (after
    1..8 steps) of a byte of +1 differences p and -1 differences m."""
    bits = (np.arange(256)[:, None] >> np.arange(8)) & 1
    cum = np.cumsum(bits, axis=1)                       # [byte, step]
    return (cum[None, :, :] - cum[:, None, :]).min(axis=2).astype(
        np.int8).ravel()                                # [m, p] -> m*256+p


def _table(dev) -> torch.Tensor:
    """min_prefix_table() on device dev, made once (the copy is complete
    when this returns, so any stream may read it)."""
    with _tables_lock:
        t = _tables.get(dev)
        if t is None:
            t = _tables[dev] = torch.tensor(min_prefix_table(), device=dev)
        return t


@cuda_lib.counted
def finish_bundle_kernel(tgt_masks, tgt_len, tgt_qual, qv_max: int,
                         min_k: int, res, *, w: int,
                         min_score_open: float) -> FN.FinishOut:
    """correct.finish.finish_bundle in one kernel launch on the current
    stream; a CPU tensor takes the plain version."""
    dev = tgt_masks.device
    if dev.type == "cpu":
        return FN.finish_bundle(tgt_masks, tgt_len, tgt_qual, qv_max, min_k,
                                res, w=w, min_score_open=min_score_open)
    if dev.type != "cuda":
        raise ValueError(f"finish_bundle_kernel: no kernel for device {dev}")
    R, NT = tgt_masks.shape
    L = res.best_seq.shape[-1]
    arrays = dict(tgt_masks=tgt_masks, tgt_len=tgt_len, tgt_qual=tgt_qual,
                  best_seq=res.best_seq, best_len=res.best_len,
                  best_dist=res.best_dist, best_end=res.best_end,
                  second_dist=res.second_dist, completed=res.completed)
    types = dict(tgt_masks=torch.uint8, tgt_qual=torch.int32,
                 best_seq=torch.uint8, completed=torch.bool)
    for name, t in arrays.items():
        shape = ((R, NT) if name in ("tgt_masks", "tgt_qual")
                 else (R, L) if name == "best_seq" else (R,))
        cuda_lib.check_tensor("finish_bundle_kernel", name, t,
                              types.get(name, torch.int32), shape, dev)
    lib = cuda_lib.library()
    why = ("an empty target or path" if NT < 1 or L < 1
           else refuses(NT, L, L + 1 if w <= 0 or w >= L + 1 else w))
    if why:
        raise ValueError(f"finish_bundle_kernel: unsupported shape R={R} "
                         f"NT={NT} L={L} w={w}: {why}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    return enqueue(lib, arrays, qv_max=qv_max, min_k=min_k, w=w,
                   min_score_open=min_score_open,
                   index=cuda_lib.device_index(dev), stream=stream,
                   counted=lambda: cuda_lib.add_launches(finish_bundle_kernel,
                                                         stream))


def enqueue(lib, arrays, *, qv_max, min_k, w, min_score_open, index, stream,
            counted) -> FN.FinishOut:
    """Allocate the outputs beside the (checked) inputs and enqueue the
    kernel on CUDA device `index`, stream `stream`; counted() after the
    launch."""
    dev = arrays["tgt_masks"].device
    R, NT = arrays["tgt_masks"].shape
    L = arrays["best_seq"].shape[-1]
    out = FN.FinishOut(
        scalars=torch.empty((R, len(FN.SCALAR_FIELDS)), dtype=torch.int32,
                            device=dev),
        seq_packed=torch.empty((R, -(-L // 16)), dtype=torch.int32,
                               device=dev))
    if R == 0:
        return out
    arrays = dict(arrays, scalars=out.scalars, seq_packed=out.seq_packed,
                  minpre=_table(dev))
    ints = dict(R=R, NT=NT, L=L, w=w, qv_max=qv_max, min_k=min_k)
    err = lib.finish_bundle_launch(
        cuda_lib.pointer_table([arrays[n] for n in PTRS]), len(PTRS),
        cuda_lib.int_table([ints[n] for n in INTS]), len(INTS),
        float(min_score_open), index, stream)
    if err != 0:
        raise RuntimeError(f"finish kernel launch failed: CUDA error {err} "
                           f"(R={R} NT={NT} L={L} w={w})")
    counted()
    return out
