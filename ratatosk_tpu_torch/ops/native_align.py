"""ctypes bindings for the native banded aligner (native/align.cpp).

Host-side companion to the device DP (ops/align.py): the engine aligns only
chosen winners on host (per-base quality classes, partial trims, splice
distances — reference getScorePath string overload GraphTraversal.cpp:722-772
and generateConsensus Alignment.cpp:309-470). Lazily builds
native/libralign.so; callers fall back to the NumPy DP (ops/cigar.py) when no
toolchain is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libralign.so")
_lib = None
_lib_failed = False

_U8P = ctypes.POINTER(ctypes.c_uint8)
_I32P = ctypes.POINTER(ctypes.c_int32)

_OP_CHARS = np.frombuffer(b"=XID", dtype="S1")


def _load():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    src = os.path.join(_NATIVE_DIR, "align.cpp")
    try:
        if (not os.path.exists(_LIB_PATH)
                or os.path.getmtime(_LIB_PATH) < os.path.getmtime(src)):
            subprocess.run(
                ["sh", os.path.join(_NATIVE_DIR, "build.sh"), "align"],
                check=True, capture_output=True)
        lib = ctypes.CDLL(_LIB_PATH)
        lib.aln_one.restype = ctypes.c_int32
        lib.aln_one.argtypes = [
            _U8P, ctypes.c_int32, _U8P, ctypes.c_int32, ctypes.c_int32,
            _I32P, _I32P, _U8P, _I32P, _I32P, ctypes.c_int32,
        ]
        lib.aln_dist_batch.restype = None
        lib.aln_dist_batch.argtypes = [
            _U8P, ctypes.POINTER(ctypes.c_int64),
            _U8P, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int32, _I32P, ctypes.c_int32,
        ]
        _lib = lib
    except (subprocess.CalledProcessError, OSError):
        _lib_failed = True
    return _lib


def available() -> bool:
    return _load() is not None


def _u8(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint8)


def align(a_masks: np.ndarray, b_masks: np.ndarray, mode: int,
          want_qclass: bool = False, want_cigar: bool = False,
          ) -> Tuple[int, int, int, Optional[np.ndarray], Optional[list]]:
    """Returns (dist, b_start, b_end, qclass, cigar).

    qclass: uint8 [len(a)] per-query-base class 0/1/2 = match/mismatch/ins
    (None unless requested). cigar: [(op, run)] list (None unless requested).
    """
    lib = _load()
    assert lib is not None
    a = _u8(a_masks)
    b = _u8(b_masks)
    la, lb = len(a), len(b)
    bs = ctypes.c_int32(0)
    be = ctypes.c_int32(0)
    qc = np.zeros(max(la, 1), dtype=np.uint8) if (want_qclass or want_cigar) else None
    cig_buf = cig_n = None
    cap = 0
    if want_cigar:
        cap = la + lb + 2
        cig_buf = np.zeros(cap, dtype=np.int32)
        cig_n = ctypes.c_int32(0)
    dist = lib.aln_one(
        a.ctypes.data_as(_U8P), la, b.ctypes.data_as(_U8P), lb, mode,
        ctypes.byref(bs), ctypes.byref(be),
        qc.ctypes.data_as(_U8P) if qc is not None else None,
        cig_buf.ctypes.data_as(_I32P) if cig_buf is not None else None,
        ctypes.byref(cig_n) if cig_n is not None else None, cap)
    cigar = None
    if want_cigar:
        n = min(int(cig_n.value), cap)
        ops = cig_buf[:n][::-1]        # native emits in reverse order
        cigar = []
        for op in ops:
            ch = "=XID"[op]
            if cigar and cigar[-1][0] == ch:
                cigar[-1] = (ch, cigar[-1][1] + 1)
            else:
                cigar.append((ch, 1))
    return (int(dist), int(bs.value), int(be.value),
            qc[:la] if want_qclass else None, cigar)


def align_dist_batch(pairs, mode: int = 0):
    """NW distances of many (a_masks, b_masks) pairs in ONE native call
    (threaded; native/align.cpp aln_dist_batch). Falls back to per-pair
    align() when the library is unavailable."""
    n = len(pairs)
    out = np.zeros(n, dtype=np.int32)
    if n == 0:
        return out
    lib = _load()
    if lib is None:
        from ratatosk_tpu_torch.ops import cigar as CG
        for i, (a, b) in enumerate(pairs):
            out[i] = CG.aln_dist(a, b, mode)
        return out
    aoff = np.zeros(n + 1, dtype=np.int64)
    boff = np.zeros(n + 1, dtype=np.int64)
    for i, (a, b) in enumerate(pairs):
        aoff[i + 1] = aoff[i] + len(a)
        boff[i + 1] = boff[i] + len(b)
    acat = np.concatenate([_u8(a) for a, _ in pairs]) if n else \
        np.zeros(0, np.uint8)
    bcat = np.concatenate([_u8(b) for _, b in pairs]) if n else \
        np.zeros(0, np.uint8)
    nt = min(os.cpu_count() or 1, 16)
    lib.aln_dist_batch(
        acat.ctypes.data_as(_U8P),
        aoff.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        bcat.ctypes.data_as(_U8P),
        boff.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, mode, out.ctypes.data_as(_I32P), nt)
    return out
