"""ctypes bindings for the native k-mer kernels (native/kmers.cpp).

Host-runtime companions to the numpy formulations in ops/kmers.py,
graph/keys.py and correct/seeds.py: rolling canonical packing, sorted-index
exact lookup, and the batched 1-edit seed probe. These are the host hot paths
of planning and index construction (the roles Bifrost's KmerHashIterator and
CompactedDBG::find/searchSequence play in the reference, SURVEY.md §2.3).
Builds libkmers.so on first use, into the port's own build directory
(native_build.py). Callers fall back to the numpy implementations when no
toolchain is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

from ratatosk_tpu_torch.native_build import build_native

_lib = None
_lib_failed = False

_U8P = ctypes.POINTER(ctypes.c_uint8)
_U64P = ctypes.POINTER(ctypes.c_uint64)
_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)


def _n_threads() -> int:
    return min(os.cpu_count() or 1, 16)


def _load():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    if os.environ.get("RATATOSK_NO_NATIVE"):
        _lib_failed = True
        return None
    try:
        lib = ctypes.CDLL(build_native("kmers"))
        lib.rt_canonical.restype = None
        lib.rt_canonical.argtypes = [
            _U8P, ctypes.c_int64, ctypes.c_int32,
            _U64P, _U64P, _U8P, _U8P, ctypes.c_int32]
        lib.rt_lookup.restype = None
        lib.rt_lookup.argtypes = [
            _U8P, ctypes.c_int64, ctypes.c_int32,
            _U64P, _U64P, ctypes.c_int64,
            _I64P, _U8P, ctypes.c_int32]
        lib.rt_bucket_count.restype = None
        lib.rt_bucket_count.argtypes = [
            _U64P, _U64P, _U8P, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, _I64P]
        lib.rt_bucket_scatter.restype = None
        lib.rt_bucket_scatter.argtypes = [
            _U64P, _U64P, _U8P, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, _I64P, _U64P, _U64P]
        lib.rt_radix_sort.restype = None
        lib.rt_radix_sort.argtypes = [
            _U64P, _U64P, _U64P, _U64P, ctypes.c_int64]
        lib.rt_rle_filter.restype = ctypes.c_int64
        lib.rt_rle_filter.argtypes = [
            _U64P, _U64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            _U64P, _U64P, _I64P]
        lib.rt_lookup_hash.restype = None
        lib.rt_lookup_hash.argtypes = [
            _U8P, ctypes.c_int64, ctypes.c_int32,
            _U64P, _U64P, _I64P, _I32P, ctypes.c_int32,
            _I64P, _U8P, ctypes.c_int32]
        lib.rt_find_keys.restype = None
        lib.rt_find_keys.argtypes = [
            _U64P, _U64P, ctypes.c_int64,
            _U64P, _U64P, _I64P, _I32P, ctypes.c_int32,
            _I64P, ctypes.c_int32]
        lib.rt_seed_probe.restype = ctypes.c_int64
        lib.rt_seed_probe.argtypes = [
            _U8P, ctypes.c_int64, ctypes.c_int32,
            _I64P, ctypes.c_int64,
            _U64P, _U64P, ctypes.c_int64,
            _I64P, _I32P, ctypes.c_int32,
            _U8P, ctypes.c_int32,
            _U8P, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            _I64P, _I64P, _U8P, _U8P,
            ctypes.c_int64, ctypes.c_int32]
        _lib = lib
    except (subprocess.CalledProcessError, OSError):
        _lib_failed = True
    return _lib


def available() -> bool:
    return _load() is not None


def _u64p(a: Optional[np.ndarray]):
    if a is None:
        return None
    return a.ctypes.data_as(_U64P)


def canonical(codes: np.ndarray, k: int
              ) -> Tuple[Optional[np.ndarray], np.ndarray, np.ndarray,
                         np.ndarray]:
    """Canonical keys of every k-window. Returns (hi|None, lo, valid, is_fw)."""
    lib = _load()
    assert lib is not None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    P = max(len(codes) - k + 1, 0)
    lo = np.zeros(P, dtype=np.uint64)
    hi = np.zeros(P, dtype=np.uint64) if k > 32 else None
    valid = np.zeros(P, dtype=np.uint8)
    is_fw = np.zeros(P, dtype=np.uint8)
    if P:
        lib.rt_canonical(codes.ctypes.data_as(_U8P), len(codes), k,
                         _u64p(hi), _u64p(lo),
                         valid.ctypes.data_as(_U8P),
                         is_fw.ctypes.data_as(_U8P), _n_threads())
    return hi, lo, valid.astype(bool), is_fw.astype(bool)


def hash_dir(index):
    """Host hash directory over an index's canonical keys (cached).

    Mirror of the device directory (ops/hash_index.py) for the C kernels:
    keys re-ordered by the top `bits` of their splitmix64 hash, a bucket-
    start array dir0[2^bits + 1], and hrows[slot] = value-order row. Probes
    become O(1 + bucket) instead of log2(n) binary-search rounds
    (native/kmers.cpp find_key_hash).
    """
    cached = getattr(index, "_host_hash_dir", None)
    if cached is not None:
        return cached
    import ratatosk_tpu_torch.ops.kmers as K
    n = int(index.n)
    if n >= (1 << 31) - 1:
        return None   # int32 slot offsets; callers fall back to the
                      # sorted binary search at this scale
    lo = np.ascontiguousarray(index.keys_lo, np.uint64)
    hi = (np.ascontiguousarray(index.keys_hi, np.uint64)
          if index.two_word else None)
    bits = min(28, max(16, int(np.ceil(np.log2(max(2 * n, 2))))))
    h = K.hash_kmer2(hi, lo, np) if index.two_word else K.hash_kmer(lo, np)
    buck = (h >> np.uint64(64 - bits)).astype(np.int64)
    order = np.argsort(buck, kind="stable")
    dir0 = np.zeros((1 << bits) + 1, np.int32)
    dir0[1:] = np.cumsum(np.bincount(buck, minlength=1 << bits)
                         ).astype(np.int32)
    cached = (np.ascontiguousarray(lo[order]),
              np.ascontiguousarray(hi[order]) if hi is not None else None,
              np.ascontiguousarray(order.astype(np.int64)),
              np.ascontiguousarray(dir0), bits)
    try:
        setattr(index, "_host_hash_dir", cached)
    except AttributeError:
        pass
    return cached


def index_lookup(codes: np.ndarray, k: int, index
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Exact value-order index row of every k-window via the hash directory
    (-1 = miss). Returns (rows, is_fw). Drop-in for lookup(...) on an index
    object."""
    lib = _load()
    assert lib is not None
    hd = hash_dir(index)
    if hd is None:
        return lookup(codes, k, np.asarray(index.keys_lo),
                      np.asarray(index.keys_hi) if index.two_word else None)
    hk_lo, hk_hi, hrows, dir0, bits = hd
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    P = max(len(codes) - k + 1, 0)
    rows = np.full(P, -1, dtype=np.int64)
    is_fw = np.zeros(P, dtype=np.uint8)
    if P and len(hk_lo):
        lib.rt_lookup_hash(codes.ctypes.data_as(_U8P), len(codes), k,
                           _u64p(hk_hi), _u64p(hk_lo),
                           hrows.ctypes.data_as(_I64P),
                           dir0.ctypes.data_as(_I32P), bits,
                           rows.ctypes.data_as(_I64P),
                           is_fw.ctypes.data_as(_U8P), _n_threads())
    return rows, is_fw.astype(bool)


def lookup(codes: np.ndarray, k: int, keys_lo: np.ndarray,
           keys_hi: Optional[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Exact index row of every k-window (-1 = miss). Returns (rows, is_fw)."""
    lib = _load()
    assert lib is not None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    keys_lo = np.ascontiguousarray(keys_lo, dtype=np.uint64)
    if keys_hi is not None:
        keys_hi = np.ascontiguousarray(keys_hi, dtype=np.uint64)
    P = max(len(codes) - k + 1, 0)
    rows = np.full(P, -1, dtype=np.int64)
    is_fw = np.zeros(P, dtype=np.uint8)
    if P and len(keys_lo):
        lib.rt_lookup(codes.ctypes.data_as(_U8P), len(codes), k,
                      _u64p(keys_hi), _u64p(keys_lo), len(keys_lo),
                      rows.ctypes.data_as(_I64P),
                      is_fw.ctypes.data_as(_U8P), _n_threads())
    return rows, is_fw.astype(bool)


def seed_probe(concat: np.ndarray, k: int, span_starts: np.ndarray,
               keys_lo: np.ndarray, keys_hi: Optional[np.ndarray],
               pf_tbl: Optional[np.ndarray], pf_bits: int,
               *, stride: int = 1, near_exact_skip: int = 16,
               subs: bool = True, indels: bool = True,
               hf_tbl: Optional[np.ndarray] = None, hf_bits: int = 0,
               half_len: int = 0, index=None):
    """1-edit probe of all spans. Returns (pos, row, is_fw, kind) arrays;
    kind: 0 exact, 1 sub, 2 del (k+1 read window), 3 ins (k-1).

    hf_tbl/hf_bits/half_len: optional pigeonhole half-k-mer occupancy table
    (correct/seeds._half_filter) — prunes windows with both halves absent
    and restricts edit positions to the certified side; bit-identical
    results (no false negatives)."""
    lib = _load()
    assert lib is not None
    concat = np.ascontiguousarray(concat, dtype=np.uint8)
    span_starts = np.ascontiguousarray(span_starts, dtype=np.int64)
    keys_lo = np.ascontiguousarray(keys_lo, dtype=np.uint64)
    if keys_hi is not None:
        keys_hi = np.ascontiguousarray(keys_hi, dtype=np.uint64)
    pf = None
    if pf_tbl is not None:
        pf = np.ascontiguousarray(pf_tbl, dtype=np.uint8)
    hf = None
    if hf_tbl is not None and half_len > 0:
        hf = np.ascontiguousarray(hf_tbl, dtype=np.uint8)
    # with a hash directory, the key table handed to C is the hash-ordered
    # one and lookups go through the directory (find_key_hash)
    hrows = dir0 = None
    dir_bits = 0
    hd = hash_dir(index) if index is not None else None
    if hd is not None:
        keys_lo, keys_hi, hrows, dir0, dir_bits = hd
    cap = max(len(concat) // 8, 1 << 14)
    while True:
        pos = np.zeros(cap, dtype=np.int64)
        row = np.zeros(cap, dtype=np.int64)
        fw = np.zeros(cap, dtype=np.uint8)
        kind = np.zeros(cap, dtype=np.uint8)
        n = lib.rt_seed_probe(
            concat.ctypes.data_as(_U8P), len(concat), k,
            span_starts.ctypes.data_as(_I64P), len(span_starts),
            _u64p(keys_hi), _u64p(keys_lo), len(keys_lo),
            hrows.ctypes.data_as(_I64P) if hrows is not None else None,
            dir0.ctypes.data_as(_I32P) if dir0 is not None else None,
            dir_bits,
            pf.ctypes.data_as(_U8P) if pf is not None else None,
            pf_bits,
            hf.ctypes.data_as(_U8P) if hf is not None else None,
            hf_bits, half_len if hf is not None else 0,
            stride, near_exact_skip,
            1 if subs else 0, 1 if indels else 0,
            pos.ctypes.data_as(_I64P), row.ctypes.data_as(_I64P),
            fw.ctypes.data_as(_U8P), kind.ctypes.data_as(_U8P),
            cap, _n_threads())
        if n >= 0:
            return (pos[:n], row[:n], fw[:n].astype(bool), kind[:n])
        cap = int(-n) + 1024


# ---------------------------------------------------------------------------
# bucketed counting kernels (large-scale index construction; see
# native/kmers.cpp and graph/build.py count_kmers_bucketed)
# ---------------------------------------------------------------------------

def bucket_count(hi: Optional[np.ndarray], lo: np.ndarray, valid: np.ndarray,
                 k: int, bbits: int, counts: np.ndarray) -> None:
    """Accumulate per-bucket key counts of one chunk into counts[2^bbits]."""
    lib = _load()
    assert lib is not None
    lib.rt_bucket_count(_u64p(hi), _u64p(lo),
                        valid.ctypes.data_as(_U8P), len(lo), k, bbits,
                        counts.ctypes.data_as(_I64P))


def bucket_scatter(hi: Optional[np.ndarray], lo: np.ndarray,
                   valid: np.ndarray, k: int, bbits: int,
                   offsets: np.ndarray, out_hi: Optional[np.ndarray],
                   out_lo: np.ndarray) -> None:
    """Scatter one chunk's keys into bucket regions; offsets advance."""
    lib = _load()
    assert lib is not None
    lib.rt_bucket_scatter(_u64p(hi), _u64p(lo),
                          valid.ctypes.data_as(_U8P), len(lo), k, bbits,
                          offsets.ctypes.data_as(_I64P),
                          _u64p(out_hi), _u64p(out_lo))


def radix_sort(hi: Optional[np.ndarray], lo: np.ndarray,
               thi: Optional[np.ndarray], tlo: np.ndarray) -> None:
    """In-place LSD radix sort of (hi, lo) keys; t* are same-size temps."""
    lib = _load()
    assert lib is not None
    lib.rt_radix_sort(_u64p(hi), _u64p(lo), _u64p(thi), _u64p(tlo), len(lo))


def rle_filter(hi: Optional[np.ndarray], lo: np.ndarray, min_count: int,
               max_count: int, out_hi: Optional[np.ndarray],
               out_lo: np.ndarray, out_cnt: np.ndarray) -> int:
    """Run-length filter of a sorted key range; returns emitted count."""
    lib = _load()
    assert lib is not None
    return lib.rt_rle_filter(_u64p(hi), _u64p(lo), len(lo), min_count,
                             max_count, _u64p(out_hi), _u64p(out_lo),
                             out_cnt.ctypes.data_as(_I64P))


def hash_dir_for_keys(lo: np.ndarray, hi: Optional[np.ndarray]):
    """Build a (non-cached) hash directory over bare sorted canonical key
    arrays — hash_dir() for callers without an index object (e.g. unitig
    compaction's successor lookups over the solid set)."""
    import ratatosk_tpu_torch.ops.kmers as K
    n = len(lo)
    if n >= (1 << 31) - 1:
        return None
    lo = np.ascontiguousarray(lo, np.uint64)
    hi = np.ascontiguousarray(hi, np.uint64) if hi is not None else None
    bits = min(28, max(16, int(np.ceil(np.log2(max(2 * n, 2))))))
    h = K.hash_kmer2(hi, lo, np) if hi is not None else K.hash_kmer(lo, np)
    buck = (h >> np.uint64(64 - bits)).astype(np.int64)
    order = np.argsort(buck, kind="stable")
    dir0 = np.zeros((1 << bits) + 1, np.int32)
    dir0[1:] = np.cumsum(np.bincount(buck, minlength=1 << bits)
                         ).astype(np.int32)
    return (np.ascontiguousarray(lo[order]),
            np.ascontiguousarray(hi[order]) if hi is not None else None,
            np.ascontiguousarray(order.astype(np.int64)),
            np.ascontiguousarray(dir0), bits)


def find_keys(q_lo: np.ndarray, q_hi: Optional[np.ndarray], hd
              ) -> np.ndarray:
    """Value-order rows of already-canonical packed keys via a hash
    directory (hash_dir / hash_dir_for_keys tuple); -1 at misses."""
    lib = _load()
    assert lib is not None
    hk_lo, hk_hi, hrows, dir0, bits = hd
    q_lo = np.ascontiguousarray(q_lo, np.uint64)
    q_hi = (np.ascontiguousarray(q_hi, np.uint64)
            if q_hi is not None else None)
    rows = np.full(len(q_lo), -1, dtype=np.int64)
    if len(q_lo) and len(hk_lo):
        lib.rt_find_keys(_u64p(q_hi), _u64p(q_lo), len(q_lo),
                         _u64p(hk_hi), _u64p(hk_lo),
                         hrows.ctypes.data_as(_I64P),
                         dir0.ctypes.data_as(_I32P), bits,
                         rows.ctypes.data_as(_I64P), _n_threads())
    return rows
