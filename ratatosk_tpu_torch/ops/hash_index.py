"""Device hash-directory k-mer lookup: O(1) gathers per probe, no per-query
canonicalization.

Port of ratatosk_tpu/ops/hash_index.py (plain JAX there, plain torch here).

- build (host, NumPy): every canonical key is entered TWICE, in canonical
  (forward) form and in reverse-complement form, so the device probes a
  window in its READ orientation directly; the matched entry's flag says
  whether the window equals the canonical form (the `is_fw` the planner
  needs). k is odd in both passes (31/63), so no k-mer is its own reverse
  complement and the 2N keys stay unique. The tables are then uploaded.
- keys are hashed with 32-bit-word mixing (FNV-1a accumulate + lowbias32
  finalizer) and sorted by hash with a bucket directory on the top `bits`
  hash bits.
- probe (device): h = hash(words); d0 = dir[h >> shift]; `dmax` fixed
  iterations gather one key row each and test equality.

Payload `row` is the key's rank in the VALUE-sorted order (ops/kmer_index.py
rows), so device hits are interchangeable with host KeyArray.find results.

Word layout. torch's uint32/uint64 support is partial, so a 32-bit word is
an int64 holding a value in [0, 2^32), and a packed k-mer word is an int64
holding the bits of a uint64. A wrapping uint32 multiply is
`(a * b) & 0xFFFFFFFF`: the low 32 bits of the wrapped int64 product are
exact. The hash functions take NumPy int64 arrays (host build) and torch
int64 tensors (device probe) alike. Stored tables hold uint32 words as the
int32 of their bits.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ratatosk_tpu_torch.ops import kmers as K

_M32 = 0xFFFFFFFF
_FNV_OFF = 0x811C9DC5
_FNV_P = 0x01000193
_LB1 = 0x7FEB352D
_LB2 = 0x846CA68B


def _lowbias32(h):
    h = h ^ (h >> 16)
    h = (h * _LB1) & _M32
    h = h ^ (h >> 15)
    h = (h * _LB2) & _M32
    return h ^ (h >> 16)


def hash_words(w0, w1, w2=None, w3=None):
    """32-bit hash of 2 or 4 words in [0, 2^32) (FNV-1a + lowbias32)."""
    h = ((_FNV_OFF ^ w0) * _FNV_P) & _M32
    h = ((h ^ w1) * _FNV_P) & _M32
    if w2 is not None:
        h = ((h ^ w2) * _FNV_P) & _M32
        h = ((h ^ w3) * _FNV_P) & _M32
    return _lowbias32(h)


def split64(x):
    """int64-held uint64 words -> (lo32, hi32) words in [0, 2^32)."""
    return x & _M32, (x >> 32) & _M32


def hash_key64(lo, hi=None):
    """Hash of one- or two-word packed k-mers (int64-held uint64 words)."""
    l0, l1 = split64(lo)
    if hi is None:
        return hash_words(l0, l1)
    h0, h1 = split64(hi)
    return hash_words(l0, l1, h0, h1)


def _i64(x: np.ndarray) -> np.ndarray:
    """uint64 array -> the int64 array of its bits."""
    return np.ascontiguousarray(np.asarray(x, np.uint64)).view(np.int64)


def _as_i32(w):
    """Words in [0, 2^32) -> the int32 of their bits."""
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


def _both_orientations(index):
    """(lo, hi) uint64 keys of both orientations; hi is None when k <= 32."""
    lo = np.asarray(index.keys_lo, dtype=np.uint64)
    if index.two_word:
        hi = np.asarray(index.keys_hi, dtype=np.uint64)
        rhi, rlo = K.revcomp_kmer2(hi, lo, index.k, np)
        return np.concatenate([lo, rlo]), np.concatenate([hi, rhi])
    return np.concatenate([lo, K.revcomp_kmer(lo, index.k, np)]), None


@dataclasses.dataclass
class HashKmerIndex:
    """Hash-ordered two-orientation key table + bucket directory (device)."""

    key_tbl: torch.Tensor          # [2N, 2] or [2N, 4] int32 (uint32 bits)
    dir0: torch.Tensor             # [2^bits] int64 bucket starts
    rowflag: torch.Tensor          # [2N] int32: (value-order row << 1) | is_fw
    upa: torch.Tensor              # [2N, 2] int32: (unitig_id, pos<<1|strand)
    k: int = 0
    n: int = 0
    bits: int = 0
    dmax: int = 1
    two_word: bool = False

    @staticmethod
    def build(index, device) -> "HashKmerIndex":
        """From a value-sorted ops/kmer_index.KmerIndex (host arrays), built
        on the host and uploaded to `device`."""
        n = index.n
        two = index.two_word
        alo, ahi = _both_orientations(index)
        h = hash_key64(_i64(alo), None if ahi is None else _i64(ahi))
        n2 = 2 * n
        # is_fw=1 for the canonical-form entry, 0 for the rc-form entry
        flag = np.concatenate([np.ones(n, np.int32), np.zeros(n, np.int32)])
        rows = np.concatenate([np.arange(n, dtype=np.int32)] * 2)
        bits = max(int(np.ceil(np.log2(max(2 * n2, 2)))), 4)
        bits = min(bits, 28)
        order = np.argsort(h, kind="stable").astype(np.int64)
        buck = h[order] >> (32 - bits)
        counts = np.bincount(buck, minlength=1 << bits)
        dmax = int(counts.max()) if n else 1
        dir0 = np.zeros(1 << bits, np.int64)
        dir0[1:] = np.cumsum(counts[:-1])
        words = [split64(_i64(alo[order]))]
        if two:
            words.append(split64(_i64(ahi[order])))
        key_tbl = np.stack([w for pair in words for w in pair], axis=1)
        rowflag = (rows[order] << 1) | flag[order]
        uid_h = np.asarray(index.unitig_id, np.int32)
        posstr = ((np.asarray(index.pos, np.int32) << 1)
                  | np.asarray(index.strand, np.int32))
        rr = rows[order]
        upa = np.stack([uid_h[rr], posstr[rr]], axis=1)

        def put(x, dtype):
            return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(device)

        return HashKmerIndex(
            k=index.k, n=n, bits=bits, dmax=max(dmax, 1),
            key_tbl=put(key_tbl.astype(np.uint32).view(np.int32), np.int32),
            dir0=put(dir0, np.int64), rowflag=put(rowflag, np.int32),
            upa=put(upa, np.int32), two_word=two)


def probe_slots_raw(hx: HashKmerIndex, w_lo, w_hi=None, valid=None):
    """Hash-order slot of each READ-ORIENTATION window (-1 = absent)."""
    ql0, ql1 = split64(w_lo)
    q = [ql0, ql1]
    if hx.two_word:
        q += list(split64(w_hi))
    h = hash_words(*q)
    hit = torch.full(w_lo.shape, -1, dtype=torch.int64, device=w_lo.device)
    if hx.n == 0:
        return hit
    d0 = hx.dir0[h >> (32 - hx.bits)]
    nn = max(2 * hx.n, 1)
    q32 = [_as_i32(w) for w in q]
    for i in range(hx.dmax):
        idx = torch.clamp(d0 + i, max=nn - 1)
        kr = hx.key_tbl[idx]
        m = kr[:, 0] == q32[0]
        for j in range(1, len(q32)):
            m = m & (kr[:, j] == q32[j])
        hit = torch.where(m, idx, hit)
    if valid is not None:
        hit = torch.where(valid, hit, -1)
    return hit


def probe_rowflag(hx: HashKmerIndex, w_lo, w_hi=None, valid=None):
    """(row, is_fw, slot) of each read-orientation window; row = -1 at
    misses. row is the value-sorted index row; is_fw says the window equals
    the canonical key (the find_runs `is_fw`)."""
    slot = probe_slots_raw(hx, w_lo, w_hi, valid)
    rf = hx.rowflag[torch.clamp(slot, min=0)].long()
    row = torch.where(slot >= 0, rf >> 1, -1)
    return row, (rf & 1).bool(), slot


def probe_upa_raw(hx: HashKmerIndex, w_lo, w_hi=None, valid=None):
    """(uid, pos, strand, is_fw) per read-orientation window; uid=-1 miss."""
    slot = probe_slots_raw(hx, w_lo, w_hi, valid)
    safe = torch.clamp(slot, min=0)
    pa = hx.upa[safe].long()
    rf = hx.rowflag[safe].long()
    found = slot >= 0
    uid = torch.where(found, pa[:, 0], -1)
    pos = torch.where(found, pa[:, 1] >> 1, 0)
    strand = torch.where(found, pa[:, 1] & 1, 0)
    return uid, pos, strand, (rf & 1).bool()


def probe_rows(hx: HashKmerIndex, q_lo, q_hi=None, valid=None):
    """Value-sorted row of CANONICAL queries — drop-in for KeyArray.find.

    A canonical query matches its forward-form entry directly.
    """
    row, _, _ = probe_rowflag(hx, q_lo, q_hi, valid)
    return row


def _bitmap(h: np.ndarray, bits: int, device):
    """Occupancy bitmap of 32-bit hashes under a second lowbias pass,
    packed into uint32 words (held as int32) and uploaded."""
    idx = _lowbias32(h) >> (32 - bits)
    tbl = np.zeros(1 << max(bits - 5, 0), np.uint32)
    np.bitwise_or.at(tbl, idx >> 5,
                     np.uint32(1) << (idx & 31).astype(np.uint32))
    return torch.from_numpy(tbl.view(np.int32)).to(device)


def make_prefilter_bitmap(index, device, bits: Optional[int] = None):
    """Hashed occupancy bitmap over BOTH orientations.

    One word gather + bit test rejects most absent 1-edit variant keys before
    the hash-table probe; no false negatives (tested). Uses a SECOND lowbias
    pass over the same 32-bit hash so the bitmap decorrelates from the
    directory's top bits.
    """
    n = max(int(index.n), 1)
    if bits is None:
        # ~0.7% occupancy over the 2n two-orientation entries: the survivor
        # buffers in ops/plan_device.py are sized for a ~1% pass rate, and
        # every false positive costs a phase-B probe (~10 gathers)
        bits = min(30, max(20, int(np.ceil(np.log2(256 * n)))))
    alo, ahi = _both_orientations(index)
    h = hash_key64(_i64(alo), None if ahi is None else _i64(ahi))
    return _bitmap(h, bits, device), bits


def prefilter_test(tbl, bits: int, h):
    """True = 32-bit hash may be present (one word gather per query)."""
    idx = _lowbias32(h) >> (32 - bits)
    w = tbl[idx >> 5]
    return ((w >> (idx & 31)) & 1).bool()


def make_half_bitmap(index, h: int, device, bits: Optional[int] = None):
    """Pigeonhole half-k-mer bitmap: h-prefixes and h-suffixes of every key
    in BOTH orientations.

    A 1-edit variant of a window keeps at least one of (first h bases,
    last h bases) intact, so a window whose h-prefix AND h-suffix are both
    absent from this table has NO 1-edit hit. Exact (no false negatives):
    false positives only cost enumeration work downstream. h <= 31 so each
    half packs into one word.
    """
    k = index.k
    alo, ahi = _both_orientations(index)
    if ahi is not None:
        # value = ahi * 2^64 + alo, bases big-endian (2k bits used)
        sh = 2 * (k - h)
        if sh >= 64:
            pre = ahi >> np.uint64(sh - 64)
        else:
            pre = ((ahi << np.uint64(64 - sh)) | (alo >> np.uint64(sh)))
            pre &= np.uint64((1 << (2 * h)) - 1)
    else:
        pre = alo >> np.uint64(2 * (k - h))
    suf = alo & np.uint64((1 << (2 * h)) - 1)
    halves = np.concatenate([pre, suf])
    if bits is None:
        bits = min(30, max(20, int(np.ceil(np.log2(128 * len(halves))))))
    return _bitmap(hash_key64(_i64(halves)), bits, device), bits
