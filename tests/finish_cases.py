"""Synthetic inputs for the finish bundle (NumPy, no JAX): region targets and
winning paths shaped to reach every case of the banded DP's window. Shared
by the CPU parity tests and the card's kernel tests."""

from __future__ import annotations

import numpy as np

# (NT, L, w) of the cases: the engine's buckets' finish widths (the exact
# 256 bucket's full path row, the 192 and 336 bands), narrow and wide bands
# that clamp at both ends, one column, and bands past 1024 columns (several
# 32-bit words a lane in the kernel)
SHAPES = {"full_389": (256, 388, 0), "band_192": (600, 904, 192),
          "band_336": (700, 1054, 336), "band_33": (300, 454, 33),
          "band_1": (40, 64, 1), "band_600": (900, 1354, 600),
          "full_1100": (300, 1099, 0), "band_2100": (2400, 3604, 2100)}


def _mutate(rng, codes, err):
    """codes with substitutions, insertions and deletions at rate err."""
    out = []
    for c in codes:
        x = rng.random()
        if x < err / 3:                 # deletion
            continue
        if x < 2 * err / 3:             # insertion before c
            out += [int(rng.integers(0, 4)), int(c)]
        elif x < err:                   # substitution
            out.append(int(rng.integers(0, 4)))
        else:
            out.append(int(c))
    return np.array(out, dtype=np.uint8)


def finish_case(seed: int, NT: int, L: int, R: int = 12) -> dict:
    """Arrays for finish_bundle (tgt_masks, tgt_len, tgt_qual and the
    BeamResult fields) of R regions. Rows: 0 an empty path, 1 a path of 5
    bases under a long target (best_len + 1 < W), 2 a path filling L, 3 a
    target shorter than most bands, 4 a full-length target under a longer
    path (the window clamps at both ends), 5 N masks (15) every 3rd base,
    6 two-base masks every 4th base and empty masks every 9th; the rest
    random. Paths are mutated copies of their targets, so the DP
    rows follow a diagonal; masks past tgt_len are 0, as the engine writes
    them."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((R, NT), dtype=np.uint8)
    qual = rng.integers(0, 60, (R, NT)).astype(np.int32)
    tlen = rng.integers(1, NT + 1, R).astype(np.int32)
    tlen[3] = min(NT, 17)
    tlen[4] = NT
    seq = rng.integers(0, 4, (R, L)).astype(np.uint8)
    blen = np.zeros(R, dtype=np.int32)
    for r in range(R):
        tgt = rng.integers(0, 4, tlen[r]).astype(np.uint8)
        masks[r, :tlen[r]] = 1 << tgt
        if r == 5:
            masks[r, :tlen[r]:3] = 15
        if r == 6:   # two-base IUPAC masks, and a few masks that match nothing
            masks[r, 1:tlen[r]:4] |= (1 << ((tgt[1::4] + 2) % 4)).astype(
                np.uint8)
            masks[r, 2:tlen[r]:9] = 0
        path = _mutate(rng, np.concatenate(
            [tgt, rng.integers(0, 4, NT).astype(np.uint8)]), 0.1)
        n = {0: 0, 1: 5, 2: L, 4: min(L, int(tlen[r] * 1.3))}.get(
            r, int(rng.integers(0, min(L, int(tlen[r] * 1.4)) + 1)))
        n = min(n, len(path), L)
        seq[r, :n] = path[:n]
        blen[r] = n
    completed = rng.random(R) < 0.5
    completed[:3] = False
    best_end = np.where(completed, tlen,
                        rng.integers(0, tlen + 1)).astype(np.int32)
    return dict(tgt_masks=masks, tgt_len=tlen, tgt_qual=qual, best_seq=seq,
                best_len=blen,
                best_dist=rng.integers(0, 50, R).astype(np.int32),
                best_end=best_end,
                second_dist=rng.integers(0, 1 << 20, R).astype(np.int32),
                completed=completed,
                n_done=completed.astype(np.int32))
