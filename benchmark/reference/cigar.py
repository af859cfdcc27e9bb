"""Host-side CIGAR traceback (NumPy) for chosen candidates.

The device DP (ops/align.py) ranks candidates; only the winner needs a path,
so an O(M*N) NumPy fill + O(M+N) traceback per region is cheap. Used by
consensus merging and per-base quality assignment (reference:
GraphTraversal.cpp:722-772 string overload of getScorePath;
Alignment.cpp:309-470 generateConsensus CIGAR walks).

CIGAR ops: '=' match, 'X' mismatch (both consume query+target),
'I' insertion (consumes query only), 'D' deletion (consumes target only) —
edlib's extended-CIGAR convention (edlib.h task EDLIB_TASK_PATH).
"""

from __future__ import annotations

import numpy as np

NW, SHW, HW = 0, 1, 2


def aln_stats(a_masks: np.ndarray, b_masks: np.ndarray, mode: int = NW,
              want_qclass: bool = False):
    """(dist, b_start, b_end, qclass) by the NumPy DP below.

    qclass (only when requested): uint8 [len(a)] per-query-base op class
    0/1/2 = '='/'X'/'I' — what per-base quality assignment needs
    (GraphTraversal.cpp:722-772).
    """
    dist, cig, b0, b1 = traceback(a_masks, b_masks, mode)
    qc = None
    if want_qclass:
        qc = np.zeros(len(a_masks), dtype=np.uint8)
        i = 0
        for op, ln in cig:
            if op in "=XI":
                qc[i:i + ln] = 0 if op == "=" else (1 if op == "X" else 2)
                i += ln
    return dist, b0, b1, qc


def aln_dist(a_masks: np.ndarray, b_masks: np.ndarray, mode: int = NW) -> int:
    """Distance only."""
    m = dp_matrix(a_masks, b_masks, mode)
    return int(m[-1, -1] if mode == NW else m[-1].min())


def aln_cigar(a_masks: np.ndarray, b_masks: np.ndarray, mode: int = NW):
    """(dist, cigar, b_start, b_end)."""
    return traceback(a_masks, b_masks, mode)


def dp_matrix(a_masks: np.ndarray, b_masks: np.ndarray, mode: int = NW) -> np.ndarray:
    """Full edit DP matrix [M+1, N+1] (int32). IUPAC via 4-bit masks."""
    m, n = len(a_masks), len(b_masks)
    E = np.empty((m + 1, n + 1), dtype=np.int32)
    E[0] = 0 if mode == HW else np.arange(n + 1)
    j = np.arange(n + 1, dtype=np.int32)
    for i in range(1, m + 1):
        sub = ((a_masks[i - 1] & b_masks) == 0).astype(np.int32)
        d = np.concatenate(([i], np.minimum(E[i - 1, :-1] + sub, E[i - 1, 1:] + 1)))
        E[i] = j + np.minimum.accumulate(d - j)
    return E


def traceback(a_masks: np.ndarray, b_masks: np.ndarray, mode: int = NW):
    """Returns (dist, cigar, b_start, b_end); cigar = list[(op, run_len)].

    End column: max tie among minimal last-row entries (the reference takes the
    max end location, Correction.cpp:733-740); NW ends at column N.
    """
    E = dp_matrix(a_masks, b_masks, mode)
    m, n = len(a_masks), len(b_masks)
    if mode == NW:
        jend = n
    else:
        last = E[m]
        jend = int(np.flatnonzero(last == last.min()).max())
    dist = int(E[m, jend])
    ops = []
    i, j = m, jend
    while i > 0 or j > 0:
        if i == 0:
            if mode == HW:
                break  # free target prefix
            ops.append("D")
            j -= 1
            continue
        if j == 0:
            ops.append("I")
            i -= 1
            continue
        match = (a_masks[i - 1] & b_masks[j - 1]) != 0
        if E[i, j] == E[i - 1, j - 1] + (0 if match else 1):
            ops.append("=" if match else "X")
            i -= 1
            j -= 1
        elif E[i, j] == E[i - 1, j] + 1:
            ops.append("I")
            i -= 1
        else:
            ops.append("D")
            j -= 1
    b_start = j if mode == HW else 0
    ops.reverse()
    cigar = []
    for op in ops:
        if cigar and cigar[-1][0] == op:
            cigar[-1][1] += 1
        else:
            cigar.append([op, 1])
    return dist, [(op, ln) for op, ln in cigar], b_start, jend


def cigar_to_str(cigar) -> str:
    return "".join(f"{ln}{op}" for op, ln in cigar)


def query_target_map(cigar, m: int, b_start: int = 0) -> np.ndarray:
    """Per-query-base target index from a CIGAR: int32 [m], -1 where the
    query base is an insertion (consumes no target)."""
    out = np.full(m, -1, dtype=np.int32)
    i, j = 0, b_start
    for op, ln in cigar:
        if op in "=X":
            out[i:i + ln] = np.arange(j, j + ln)
            i += ln
            j += ln
        elif op == "I":
            i += ln
        else:  # D
            j += ln
    return out
