"""The exact k-mer runs of a whole batch of reads in one pass.

`find_runs_batch(cdbg, colors, reads)` equals, list for list and field for
field, `[filter_runs_by_color(find_runs(cdbg, r), colors) for r in reads]`
(correct/seeds.py) on the host index with the native library, but does the
work once per batch instead of once per read:

1. the reads are concatenated with the code 4 between them, which breaks the
   native rolling window (native/kmers.cpp), so no window spans two reads,
   and every window is looked up in ONE native call on the calling thread;
2. the chain of colinear hits (same unitig, same direction, oriented offset
   +1) is found over the hits of the whole concatenation at once, with the
   expressions of `find_runs`, and run starts map back to (read, position)
   with one searchsorted over the read offsets;
3. the junctions between adjacent runs of one read are colour-checked in one
   `intersect_count` call and killed by `filter_runs_by_color`'s rules;
4. SolidRun objects are built only for the runs that survive.

The per-read path costs ~25 NumPy calls and two native or colour calls a
read, each of which may hand the GIL to another thread and wait to get it
back; the planner thread runs beside the thread that drives the card.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ratatosk_tpu_torch.correct.seeds import SolidRun
from ratatosk_tpu_torch.graph.build import Cdbg
from ratatosk_tpu_torch.graph.colors import GraphColors
from ratatosk_tpu_torch.ops import colorset as CS
from ratatosk_tpu_torch.ops import native_kmers as NK

_SEP = np.array([4], np.uint8)


def _lookup(concat: np.ndarray, k: int, index):
    """(rows, is_fw) of every k-window of `concat`: NK.index_lookup's
    hash-directory lookup, on the calling thread alone."""
    hd = NK.hash_dir(index)
    if hd is None:
        return NK.lookup(concat, k, np.asarray(index.keys_lo),
                         np.asarray(index.keys_hi) if index.two_word else None)
    hk_lo, hk_hi, hrows, dir0, bits = hd
    P = len(concat) - k + 1
    rows = np.full(P, -1, dtype=np.int64)
    is_fw = np.zeros(P, dtype=np.uint8)
    if len(hk_lo):
        NK._load().rt_lookup_hash(
            concat.ctypes.data_as(NK._U8P), len(concat), k,
            NK._u64p(hk_hi), NK._u64p(hk_lo), hrows.ctypes.data_as(NK._I64P),
            dir0.ctypes.data_as(NK._I32P), bits,
            rows.ctypes.data_as(NK._I64P), is_fw.ctypes.data_as(NK._U8P), 1)
    return rows, is_fw


def find_runs_batch(cdbg: Cdbg, colors: GraphColors,
                    reads: Sequence[np.ndarray], min_cov: int = 2
                    ) -> List[List[SolidRun]]:
    """Colour-filtered solid runs of every read (see the module docstring);
    needs the native library (NK.available())."""
    k = cdbg.k
    n = len(reads)
    out: List[List[SolidRun]] = [[] for _ in range(n)]
    lens = np.fromiter((len(r) for r in reads), np.int64, n)
    if not (lens >= k).any():
        return out
    # read i at offs[i], a separator after each
    offs = np.zeros(n, np.int64)
    np.cumsum(lens[:-1] + 1, out=offs[1:])
    parts = []
    for r in reads:
        parts.append(np.asarray(r, np.uint8))
        parts.append(_SEP)
    concat = np.concatenate(parts[:-1])
    rows, is_fw = _lookup(concat, k, cdbg.index)
    del concat

    # only the hit windows: a chain links two hits at adjacent positions
    hp = np.flatnonzero(rows >= 0)
    if not hp.size:
        return out
    r = rows[hp]
    fw = is_fw[hp].astype(bool)
    del rows, is_fw
    index = cdbg.index
    uid = np.asarray(index.unitig_id)[r].astype(np.int32)
    pos = np.asarray(index.pos)[r]
    strand = np.asarray(index.strand)[r]
    # read k-mer maps forward on the unitig iff its canonical orientation
    # agrees with the stored canonical-vs-forward flag
    direction = np.where(fw == strand, 0, 1).astype(np.int8)
    nk = cdbg.nkmers[uid]
    o = np.where(direction == 0, pos, nk - 1 - pos).astype(np.int32)
    chain = ((hp[1:] == hp[:-1] + 1) & (uid[:-1] == uid[1:])
             & (direction[:-1] == direction[1:]) & (o[1:] == o[:-1] + 1))
    starts = np.flatnonzero(np.concatenate(([True], ~chain)))
    ends = np.flatnonzero(np.concatenate((~chain, [True])))
    g_s = hp[starts]
    rd = np.searchsorted(offs, g_s, side="right") - 1
    s = g_s - offs[rd]
    e = hp[ends] - offs[rd]
    ruid = uid[starts]
    rdir = direction[starts]
    ro = o[starts]

    # junctions between adjacent runs of one read on different unitigs
    sel = np.flatnonzero((rd[:-1] == rd[1:]) & (ruid[:-1] != ruid[1:]))
    if sel.size:
        cnt = CS.intersect_count(colors.rows[ruid[sel]],
                                 colors.rows[ruid[sel + 1]], np)
        bad = sel[cnt < min_cov]
        if bad.size:
            # a 0-length side next to a run longer than 2 dies alone,
            # otherwise both sides die
            la = e[bad] - s[bad]
            lb = e[bad + 1] - s[bad + 1]
            kill = np.zeros(len(rd), dtype=bool)
            kill[bad[~((lb == 0) & (la > 2))]] = True
            kill[bad[~((la == 0) & (lb > 2))] + 1] = True
            keep = ~kill
            rd, s, e, ruid, rdir, ro = (rd[keep], s[keep], e[keep],
                                        ruid[keep], rdir[keep], ro[keep])

    runs = [SolidRun(a, b, u, d, q)     # s, e, uid, direction, o_s
            for a, b, u, d, q in zip(s.tolist(), e.tolist(), ruid.tolist(),
                                     rdir.tolist(), ro.tolist())]
    bounds = np.searchsorted(rd, np.arange(n + 1)).tolist()
    for i in np.unique(rd).tolist():
        out[i] = runs[bounds[i]:bounds[i + 1]]
    return out
