"""The port's CUDA kernel library: built from csrc/*.cu with nvcc at first
use, loaded once per process with ctypes, every entry point's signature
registered here.

The library is compiled into `ratatosk_tpu_torch/build/` (git-ignored),
named by the hash of the sources and flags, and rebuilt when either
changes. Flags: `sm_90a` (Hopper), `-O3`, and `-fmad=false` so that no
float multiply and add is contracted into an FMA: the beam kernel's float32
scores are compared exactly against the plain PyTorch version, which rounds
after every operation. Never `--use_fast_math`: `/` stays IEEE.

Every launcher has a plain C interface: pointers and the CUDA stream as
`c_void_p`, sizes as `c_int`/`c_longlong`. A launcher enqueues on the given
stream, never synchronises, and returns `cudaGetLastError()`; the Python
wrappers raise when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

_PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# entry point -> (restype, argtypes)
SIGNATURES = {
    # csrc/sprint.cu: 10 arrays, R B W S1 device, stream
    "sprint_rows_launch": (_I, [_P] * 10 + [_I] * 5 + [_P]),
    "sprint_rows_max_width": (_I, []),
    # csrc/beam.cu: pointer table, its length, int table, its length,
    # phase, device, stream
    "beam_search_launch": (_I, [_P, _I, _P, _I, _I, _I, _P]),
    "beam_search_max_width": (_I, []),
    # csrc/finish.cu: pointer table, its length, int table, its length,
    # min_score_open, device, stream
    "finish_bundle_launch": (_I, [_P, _I, _P, _I, ctypes.c_float, _I, _P]),
    "finish_bundle_max_width": (_I, []),
    # csrc/plan.cu: pointer table, its length, int table, its length,
    # device, stream
    "plan_runs_launch": (_I, [_P, _I, _P, _I, _I, _P]),
    "plan_probe_launch": (_I, [_P, _I, _P, _I, _I, _P]),
}

_lib: Optional[ctypes.CDLL] = None
# mesh slots launch from several threads at once: the first launches must
# build and load the library once
_lib_lock = threading.Lock()


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the kernels are "
                           "built from source at first use")
    return found


def build_library() -> Path:
    """Compile csrc/*.cu into one shared library, named by the hash of the
    sources and flags, unless it exists already. Each source compiles in its
    own nvcc process, all started together, then one link. Raises with
    nvcc's stderr when the build fails; the compiler's register/spill
    report is kept beside the library (.log)."""
    sources = sorted(SRC_DIR.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out = BUILD_DIR / f"libratatosk_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # processes sharing a checkout may build at once: each writes its own
    # files and the last rename wins (the builds are identical)
    tag = f"{os.getpid()}.{threading.get_ident()}"
    tool = nvcc()
    objs, procs = [], []
    for src in sources:
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [tool, *[f for f in NVCC_FLAGS if f != "-shared"], "-c",
               "-o", str(obj), str(src)]
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        objs.append(obj)
    report = []
    failed = None
    for cmd, p in procs:
        so, se = p.communicate()
        report.append(so + se)
        if p.returncode != 0 and failed is None:
            failed = (p.returncode, cmd, se)
    if failed is not None:
        for o in objs:
            o.unlink(missing_ok=True)
        rc, cmd, se = failed
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{se}")
    tmp = out.with_suffix(f".{tag}.tmp")
    cmd = [tool, *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    out.with_suffix(".log").write_text("".join(report) + proc.stdout
                                       + proc.stderr)
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The kernel library, built and loaded once per process, with every
    entry point's signature set. Each kernel's widest band, a constant of
    its source, must equal its wrapper module's MAX_WIDTH (what the wrapper
    and the Corrector test against): checked here, once."""
    global _lib
    from ratatosk_tpu_torch.ops import beam_kernel, finish_kernel, sprint
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library()))
            for name, (res, args) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = res
                fn.argtypes = args
            for export, mod in (("beam_search_max_width", beam_kernel),
                                ("finish_bundle_max_width", finish_kernel),
                                ("sprint_rows_max_width", sprint)):
                if getattr(lib, export)() != mod.MAX_WIDTH:
                    raise RuntimeError(
                        f"{export}() is {getattr(lib, export)()}, "
                        f"{mod.__name__}.MAX_WIDTH {mod.MAX_WIDTH}")
            _lib = lib
        return _lib


def device_index(dev) -> int:
    """The CUDA ordinal of a torch device (the current one when unset)."""
    import torch
    return torch.cuda.current_device() if dev.index is None else dev.index


def call_on(index: int, launcher, *args) -> int:
    """launcher(*args), a C launcher of the library, which sets the calling
    thread's CUDA device to `index` (cudaSetDevice), with the thread's
    current device restored after it: a launch on another card must not
    move where the caller's next allocation on "cuda" lands. (Without
    CUDA, as under a CPU emulation of the library, there is none to
    restore.)"""
    import torch
    if not torch.cuda.is_available():
        return launcher(*args)
    with torch.cuda.device(index):
        return launcher(*args)


def check_tensor(fn: str, name: str, t, dtype, shape, device) -> None:
    """Raise unless wrapper fn's argument `name` is a contiguous tensor of
    `dtype` on `device`, of `shape` (any shape when None)."""
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def pointer_table(tensors) -> ctypes.Array:
    """data_ptr() of each tensor as a C array of void pointers."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def int_table(values) -> ctypes.Array:
    return (ctypes.c_longlong * len(values))(*[int(v) for v in values])


_count_lock = threading.Lock()


def counted(fn):
    """Give a wrapper its launch counts: `fn.launches` in all and
    `fn.launches_by_stream` per raw CUDA stream handle (a mesh slot's share:
    Mesh.stream(i).cuda_stream)."""
    fn.launches = 0
    fn.launches_by_stream = {}
    return fn


def add_launches(fn, stream: int, n: int = 1) -> None:
    """Count n kernel launches of wrapper fn on `stream` (thread-safe)."""
    with _count_lock:
        fn.launches += n
        fn.launches_by_stream[stream] = fn.launches_by_stream.get(stream, 0) + n
