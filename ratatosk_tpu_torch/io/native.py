"""ctypes bindings for the native FASTA/FASTQ parser (native/fastx.cpp).

Lazily builds native/libfastx.so with native/build.sh on first use; falls
back to the pure-Python parser (io/fastx.py) if no toolchain is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Iterator, Optional

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libfastx.so")
_lib = None
_lib_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    src = os.path.join(_NATIVE_DIR, "fastx.cpp")
    try:
        if (not os.path.exists(_LIB_PATH)
                or os.path.getmtime(_LIB_PATH) < os.path.getmtime(src)):
            subprocess.run(["sh", os.path.join(_NATIVE_DIR, "build.sh")],
                           check=True, capture_output=True)
        lib = ctypes.CDLL(_LIB_PATH)
        lib.fx_open.restype = ctypes.c_void_p
        lib.fx_open.argtypes = [ctypes.c_char_p]
        lib.fx_next_batch.restype = ctypes.c_int64
        lib.fx_next_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
        ]
        lib.fx_close.argtypes = [ctypes.c_void_p]
        lib.fx_format.restype = ctypes.c_int
        lib.fx_format.argtypes = [ctypes.c_void_p]
        _lib = lib
    except (subprocess.CalledProcessError, OSError):
        _lib_failed = True
    return _lib


def available() -> bool:
    return _load() is not None


def read_batches(path: str, batch_bp: int = 1 << 24, max_records: int = 1 << 16
                 ) -> Iterator[tuple]:
    """Yields (names, codes_concat, offsets, quals_concat_or_None) batches.

    codes_concat: uint8 [total_bp] 2-bit codes; offsets: int64 [n+1];
    quals: uint8 Phred33 chars aligned with codes (None for FASTA).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native fastx library unavailable")
    h = lib.fx_open(path.encode())
    if not h:
        raise IOError(f"cannot open {path} as FASTA/FASTQ")
    is_fastq = lib.fx_format(h) == 2
    seq_buf = np.empty(batch_bp, dtype=np.uint8)
    qual_buf = ctypes.create_string_buffer(batch_bp)
    offs = np.empty(max_records + 1, dtype=np.int64)
    name_cap = max_records * 256
    name_buf = ctypes.create_string_buffer(name_cap)
    try:
        while True:
            n = lib.fx_next_batch(
                h,
                seq_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                batch_bp, qual_buf,
                offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                name_buf, name_cap, max_records)
            if n == 0:
                return
            if n == -1:
                raise IOError(f"{path}: malformed FASTA/FASTQ record")
            if n == -2:
                raise IOError(f"{path}: record larger than batch buffer "
                              f"({batch_bp} bp) — raise batch_bp")
            n = int(n)
            total = int(offs[n])
            names = bytes(name_buf.raw[:]).split(b"\0")[:n]
            codes = seq_buf[:total].copy()
            quals = (np.frombuffer(qual_buf.raw[:total], dtype=np.uint8).copy()
                     if is_fastq else None)
            yield ([x.decode() for x in names], codes, offs[:n + 1].copy(), quals)
    finally:
        lib.fx_close(h)


def read_records(path: str, **kw):
    """Record-by-record generator matching fastx.read_fastx's interface."""
    from ratatosk_tpu_torch.io.fastx import Record
    for names, codes, offs, quals in read_batches(path, **kw):
        for i, name in enumerate(names):
            a, b = int(offs[i]), int(offs[i + 1])
            yield Record(name, codes[a:b],
                         None if quals is None else quals[a:b])
