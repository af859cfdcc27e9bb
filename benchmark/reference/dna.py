"""DNA codec: 2-bit base codes, 4-bit IUPAC masks, entropy.

Base codes: A=0, C=1, G=2, T=3, invalid/N=4 (code 4 never packs into a k-mer).
IUPAC masks: bit0=A, bit1=C, bit2=G, bit3=T — the same bit order the reference
uses for its ambiguity table (src/Common.hpp:259 ambiguity_c[16]) and feeds to
edlib as 28 equality pairs (src/Common.hpp:262-276). Two mask bytes "match"
under IUPAC iff (a & b) != 0, which gives us the whole equality table as one
AND in the alignment kernel.
"""

from __future__ import annotations

import numpy as np

A, C, G, T, INVALID = 0, 1, 2, 3, 4

_BASES = np.frombuffer(b"ACGTN", dtype=np.uint8)

# index = 4-bit IUPAC mask, value = character (src/Common.hpp:259)
IUPAC_CHARS = np.frombuffer(b".ACMGRSVTWYHKDBN", dtype=np.uint8)

# --- lookup tables (host-side; built once) ---


def _build_code_table() -> np.ndarray:
    t = np.full(256, INVALID, dtype=np.uint8)
    for ch, code in zip(b"ACGT", (A, C, G, T)):
        t[ch] = code
        t[ch + 32] = code  # lowercase
    return t


def _build_mask_table() -> np.ndarray:
    t = np.zeros(256, dtype=np.uint8)
    for mask in range(1, 16):
        ch = IUPAC_CHARS[mask]
        t[ch] = mask
        t[ch + 32] = mask
    return t


_CODE_TABLE = _build_code_table()
_MASK_TABLE = _build_mask_table()
_CODE_TO_MASK = np.array([1, 2, 4, 8, 15], dtype=np.uint8)  # code 4 (N) -> N mask


def encode(seq: bytes | str | np.ndarray) -> np.ndarray:
    """ASCII sequence -> uint8 base codes (0-3; 4 for anything not ACGT)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, bytes) else seq
    return _CODE_TABLE[arr]


def encode_masks(seq: bytes | str | np.ndarray) -> np.ndarray:
    """ASCII sequence -> uint8 4-bit IUPAC masks (0 for non-IUPAC chars)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, bytes) else seq
    return _MASK_TABLE[arr]


def codes_to_masks(codes: np.ndarray) -> np.ndarray:
    return _CODE_TO_MASK[np.minimum(codes, 4)]


def decode(codes: np.ndarray) -> str:
    """uint8 base codes -> ASCII string (code>=4 -> 'N')."""
    return _BASES[np.minimum(codes, 4)].tobytes().decode("ascii")


def decode_masks(masks: np.ndarray) -> str:
    """uint8 IUPAC masks -> ASCII string ('.' for 0)."""
    return IUPAC_CHARS[masks & 15].tobytes().decode("ascii")


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a base-code array (INVALID stays INVALID)."""
    out = codes[::-1].copy()
    valid = out < 4
    out[valid] = 3 - out[valid]
    return out


def revcomp_str(seq: str) -> str:
    return decode(revcomp_codes(encode(seq)))


def revcomp_mask(mask: int) -> int:
    """Complement a 4-bit IUPAC mask (A<->T, C<->G)."""
    m = int(mask)
    return (((m & 1) << 3) | ((m & 8) >> 3) | ((m & 2) << 1) | ((m & 4) >> 1))


def entropy(codes: np.ndarray) -> float:
    """Base-composition Shannon entropy in bits (reference Common.cpp:5-33).

    Divides counts by total length (including non-ACGT), as the reference does.
    """
    n = codes.size
    if n == 0:
        return 0.0
    counts = np.bincount(codes[codes < 4], minlength=4).astype(np.float64) / n
    nz = counts > 0
    return float(-(counts[nz] * np.log2(counts[nz])).sum())


def get_qual_char(score: float, qv_min: int = 0, qv_max: int = 40) -> int:
    """Linear-scale Phred33 quality char for a score in [0,1].

    Reference Common.hpp:410-418 (getQual): chr(33 + qv_min + min(score,1)*(qv_max-qv_min)).
    """
    return int(min(score, 1.0) * (qv_max - qv_min)) + 33 + qv_min


def get_score(qual_char: int, qv_min: int = 0, qv_max: int = 40) -> float:
    """Inverse of get_qual_char (reference Common.hpp:420-428)."""
    return min((qual_char - 33 - qv_min) / float(qv_max - qv_min), 1.0)
