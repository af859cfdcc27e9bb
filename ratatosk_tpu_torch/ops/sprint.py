"""Sprint band update of the beam search: the hand-written CUDA kernel
(csrc/sprint.cu) and its plain PyTorch version.

Counterpart of ratatosk_tpu/ops/sprint_pallas.py. `sprint_rows` keeps the JAX
signature: it advances every region's band rows by up to smax-1 masked
row updates of the E-transformed banded edit DP and returns (rwin', btgt').

A CPU tensor goes to `sprint_rows_ref`, the plain version. A CUDA tensor
launches the kernel, or raises: nothing falls back from the card. The kernel
library is built with nvcc from `ratatosk_tpu_torch/csrc/*.cu` at first use,
into `ratatosk_tpu_torch/build/`, and rebuilt when a source changes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

BIG = 1 << 20

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib: Optional[ctypes.CDLL] = None


def sprint_rows_ref(rwin, btgt, nb_all, newcols, wsall, m_reg, live, plen, *,
                    smax: int):
    """Plain PyTorch sprint: the XLA fori-loop of beam._sprint_advance
    (ratatosk_tpu/correct/beam.py:282-322) over explicit substep masks."""
    R, B, W = rwin.shape
    cols0 = torch.arange(W, dtype=torch.int32, device=rwin.device)
    big = torch.full_like(rwin[..., :1], BIG)
    livem = live != 0
    for j in range(smax - 1):
        adv_r = j < m_reg                                        # [R]
        ws_n = wsall[:, j + 1]
        shift = (ws_n - wsall[:, j]) == 1                        # [R]
        shifted = torch.cat([btgt[:, 1:], newcols[:, j:j + 1]], dim=1)
        btgt = torch.where((shift & adv_r)[:, None], shifted, btgt)
        s3 = shift[:, None, None]
        shift_l = torch.cat([rwin[..., 1:], big], dim=-1)
        shift_r = torch.cat([big, rwin[..., :-1]], dim=-1)
        prev_j = torch.where(s3, shift_l, rwin)
        prev_jm1 = torch.where(s3, rwin, shift_r)
        bm = 1 << nb_all[:, :, j]
        sub = ((bm[..., None] & btgt[:, None, :]) == 0).to(torch.int32)
        cols = (ws_n[:, None] + cols0)[:, None, :]               # [R, 1, W]
        dd = torch.minimum(prev_jm1 + sub, prev_j + 1)
        dd = torch.where(cols == 0, (plen + (j + 1))[..., None], dd)
        dd = dd.clamp_max(BIG)
        ee = (cols + torch.cummin(dd - cols, dim=2).values).clamp_max(BIG)
        adv = livem & adv_r[:, None]
        rwin = torch.where(adv[..., None], ee, rwin)
    return rwin, btgt


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the sprint kernel "
                           "is built from source at first use")
    return found


def build_library() -> Path:
    """Compile csrc/*.cu into one shared library, named by the hash of the
    sources and flags, unless it exists already. Raises with nvcc's stderr
    when the build fails; the compiler's register/spill report is kept
    beside the library (.log)."""
    sources = sorted(SRC_DIR.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libratatosk_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.sprint_rows_launch.restype = ctypes.c_int
        lib.sprint_rows_launch.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        lib.sprint_rows_max_width.restype = ctypes.c_int
        lib.sprint_rows_max_width.argtypes = []
        _lib = lib
    return _lib


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"sprint_rows: {name} is on {t.device}, rwin on "
                         f"{device}")
    if t.dtype != torch.int32:
        raise TypeError(f"sprint_rows: {name} must be int32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"sprint_rows: {name} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"sprint_rows: {name} must be contiguous")


def sprint_rows(rwin, btgt, nb_all, newcols, wsall, m_reg, live, plen, *,
                smax: int):
    """Run the smax-1 masked band-row updates of one sprint.

    rwin [R,B,W] int32; btgt [R,W] int32 4-bit masks; nb_all [R,B,smax-1]
    int32 bases; newcols [R,smax-1] int32; wsall [R,smax] int32 window starts
    at path lengths pcount+j; m_reg [R] int32 sprint emissions per region;
    live [R,B] int32; plen [R,B] int32. Returns (rwin', btgt').
    """
    dev = rwin.device
    if dev.type == "cpu":
        return sprint_rows_ref(rwin, btgt, nb_all, newcols, wsall, m_reg,
                               live, plen, smax=smax)
    if dev.type != "cuda":
        raise ValueError(f"sprint_rows: no kernel for device {dev}")
    R, B, W = rwin.shape
    S1 = smax - 1
    for name, t, shape in (
            ("rwin", rwin, (R, B, W)), ("btgt", btgt, (R, W)),
            ("nb_all", nb_all, (R, B, S1)), ("newcols", newcols, (R, S1)),
            ("wsall", wsall, (R, smax)), ("m_reg", m_reg, (R,)),
            ("live", live, (R, B)), ("plen", plen, (R, B))):
        _check(name, t, shape, dev)
    lib = _library()
    if not (1 <= W <= lib.sprint_rows_max_width()) or S1 < 1 or B < 1:
        raise ValueError(f"sprint_rows: unsupported shape R={R} B={B} W={W} "
                         f"smax={smax}")
    rwin_out = torch.empty_like(rwin)
    btgt_out = torch.empty_like(btgt)
    if R == 0:
        return rwin_out, btgt_out
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.sprint_rows_launch(
        rwin.data_ptr(), btgt.data_ptr(), nb_all.data_ptr(),
        newcols.data_ptr(), wsall.data_ptr(), m_reg.data_ptr(),
        live.data_ptr(), plen.data_ptr(), rwin_out.data_ptr(),
        btgt_out.data_ptr(), R, B, W, S1,
        torch.cuda.current_device() if dev.index is None else dev.index,
        stream)
    if err != 0:
        raise RuntimeError(f"sprint_rows kernel launch failed: CUDA error "
                           f"{err} (R={R} B={B} W={W} smax={smax})")
    sprint_rows.launches += 1
    return rwin_out, btgt_out


sprint_rows.launches = 0
