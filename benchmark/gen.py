"""The benchmark's data: a genome, its short reads and a pool of long reads,
all drawn from one `numpy.random.default_rng(seed)` in that order.

The draw is bench_torch.py's (simulate_short, then write_long_reads), whose
pieces are the port's testing.random_genome / short_reads / noisy_read:
seed 1234 with bench.py's sizes gives bench.py's genome, short reads and
long reads, and any seed gives what bench.py's loops would draw from it.
Those loops ask the generator for one number at a time (a few million
calls for the long reads). Here the short and long reads are worked out
from the generator's raw 64-bit words instead (`Stream`), as numpy's
Generator turns them into numbers, a block at a time. A configuration
file fixes the genome and the short reads, a traffic file the long reads.
"""

from __future__ import annotations

import numpy as np

M32 = np.uint64(0xFFFFFFFF)
UNIT = 1.0 / 9007199254740992.0     # 2**-53: random() = (word >> 11) * UNIT
SUB, INS, DEL, MATCH = 0, 1, 2, 3


class Stream:
    """The words of a Generator's bit generator, as its scalar draws use
    them: `double()` (random()) takes a whole word; a bounded integer
    (integers(0, n) with n < 2**32) takes 32-bit halves, the low half of a
    fresh word and then the high half that the bit generator keeps, and
    draws again while Lemire's test rejects. Words are read ahead in
    blocks, so the Generator must not draw once a Stream holds it."""

    def __init__(self, rng, block: int = 1 << 20):
        self.bitgen = rng.bit_generator
        st = self.bitgen.state
        self.has_half = bool(st["has_uint32"])
        self.half = int(st["uinteger"])
        self.buf = np.zeros(0, np.uint64)
        self.pos = 0
        self.block = block

    def peek(self, n: int) -> np.ndarray:
        """The next n words, not taken."""
        if self.pos + n > len(self.buf):
            rest = self.buf[self.pos:]
            more = self.bitgen.random_raw(max(n - len(rest), self.block))
            self.buf = np.concatenate([rest, more])
            self.pos = 0
        return self.buf[self.pos:self.pos + n]

    def take(self) -> int:
        w = int(self.peek(1)[0])
        self.pos += 1
        return w

    def u32(self) -> int:
        if self.has_half:
            self.has_half = False
            return self.half
        w = self.take()
        self.has_half, self.half = True, w >> 32
        return w & 0xFFFFFFFF

    def bounded(self, n: int) -> int:
        """integers(0, n), 0 < n < 2**32."""
        thr = ((1 << 32) - n) % n
        while True:
            m = self.u32() * n
            if (m & 0xFFFFFFFF) >= thr:
                return m >> 32

    def double(self) -> float:
        return (self.take() >> 11) * UNIT


def random_genome(rng, length: int, repeat_frac: float = 0.0,
                  repeat_len: int = 200) -> np.ndarray:
    """Uniform bases, then repeat_frac of the genome overwritten by copies of
    repeat_len-long segments of itself."""
    g = rng.integers(0, 4, size=length).astype(np.uint8)
    n_rep = int(length * repeat_frac / max(repeat_len, 1))
    for _ in range(n_rep):
        src = rng.integers(0, length - repeat_len)
        dst = rng.integers(0, length - repeat_len)
        g[dst:dst + repeat_len] = g[src:src + repeat_len]
    return g


def _starts_and_flips(st: Stream, n: int, hi: int, block: int = 1 << 14):
    """For each of n reads, integers(0, hi) and then random() < 0.5, a block
    of reads at a time: each block is worked out as if no draw were
    rejected, and taken up to its first rejected draw, which is redrawn
    one number at a time."""
    thr = np.uint64(((1 << 32) - hi) % hi)
    starts = np.empty(n, np.int64)
    flips = np.empty(n, bool)
    k = 0
    while k < n:
        m = min(n - k, block)
        j = np.arange(m)
        fresh = (j + st.has_half) % 2 == 0      # this draw takes a new word
        before = np.cumsum(fresh) - fresh        # new words before read j
        w = st.peek(2 * m)
        at = j + before                          # read j's first word
        own = w[at] & M32
        prev_hi = np.concatenate([[np.uint64(st.half)], w[at[:-1]] >> 32])
        u = np.where(fresh, own, prev_hi)
        prod = u * np.uint64(hi)
        ok = (prod & M32) >= thr
        good = m if ok.all() else int(np.argmin(ok))
        starts[k:k + good] = (prod[:good] >> 32).astype(np.int64)
        flips[k:k + good] = (w[at[:good] + fresh[:good]] >> 11) * UNIT < 0.5
        if good:
            last = good - 1
            st.pos += int(good + before[last] + fresh[last])
            if st.has_half != (good % 2 == 1):
                st.has_half, st.half = True, int(w[at[last]] >> 32)
            else:
                st.has_half = False
        k += good
        if good < m:
            starts[k] = st.bounded(hi)
            flips[k] = st.double() < 0.5
            k += 1
    return starts, flips


def short_reads(st: Stream, genome: np.ndarray, coverage: float,
                read_len: int = 120) -> list:
    """Error-free reads at uniform positions, random strand."""
    n = int(len(genome) * coverage / read_len)
    starts, flips = _starts_and_flips(st, n, len(genome) - read_len + 1)
    rows = np.lib.stride_tricks.sliding_window_view(genome, read_len)[starts]
    rows[flips] = 3 - rows[flips, ::-1]
    return list(rows)


def noisy_read(st: Stream, genome: np.ndarray, start: int, length: int,
               err: float, mix=(0.5, 0.25, 0.25)) -> np.ndarray:
    """One ONT-like read of genome[start:start+length]: each base is
    substituted, preceded by an inserted base or deleted with probability
    err split by mix = (sub, ins, del). The draw is a random() for each
    step, then an integer for the new base of a substitution or insertion.
    Every word ahead is read as a random(); a walk from one substitution or
    insertion to the next finds where the read ends and which words the
    integers take in between."""
    true = genome[start:start + length].astype(np.int64)
    p_sub, p_ins, _ = mix
    t_sub, t_ins = err * p_sub, err * (p_sub + p_ins)
    n = int(length * 1.25) + 256
    while True:
        w = st.peek(n)
        r = (w >> 11) * UNIT
        kind = np.full(n, MATCH, np.int8)
        kind[r < err] = DEL
        kind[r < t_ins] = INS
        kind[r < t_sub] = SUB
        idx = np.where(kind <= INS, np.arange(n), n)
        next_sp = np.minimum.accumulate(idx[::-1])[::-1].tolist()
        walk = _walk(w, kind, next_sp, length, st.has_half, st.half)
        if walk is not None:
            break
        n *= 2
    p, taken, us, st.has_half, st.half = walk
    st.pos += p
    steps = np.ones(p, bool)
    steps[taken] = False
    k = kind[np.flatnonzero(steps)]
    adv = k != INS
    at = np.cumsum(adv) - adv
    out = true[at]
    u = np.array(us, np.uint64)
    sp = k <= INS
    new = np.where(k[sp] == SUB,
                   (true[at[sp]] + 1 + (u * np.uint64(3) >> np.uint64(32))
                    .astype(np.int64)) % 4,
                   (u >> np.uint64(30)).astype(np.int64))
    out[sp] = new
    return out[k != DEL].astype(np.uint8)


def _walk(w, kind, next_sp, length, has_half, half):
    """(words the read takes, the words its integers take, the integers'
    32-bit draws, the bit generator's half word after it), or None when the
    read runs past the words given."""
    n = len(next_sp)
    p = i = 0
    taken, us = [], []
    while True:
        if p >= n:
            return None
        q = next_sp[p]
        if i + q - p >= length:                 # ends before the next one
            p += length - i
            return (p, taken, us, has_half, half) if p <= n else None
        if q >= n:
            return None
        i += q - p
        p = q + 1
        while True:
            if has_half:
                u, has_half = half, False
            elif p < n:
                word = int(w[p])
                u, half, has_half = word & 0xFFFFFFFF, word >> 32, True
                taken.append(p)
                p += 1
            else:
                return None
            if kind[q] == INS or u:             # integers(1, 4) redraws 0
                break
        us.append(u)
        if kind[q] == SUB:
            i += 1
            if i == length:
                return p, taken, us, has_half, half


def simulate(config: dict, traffic: dict, seed: int):
    """(short reads, long reads) of a run: the configuration's genome and
    short reads, then the traffic's pool of long reads, from one rng."""
    rng = np.random.default_rng(seed)
    genome = random_genome(rng, config["genome_bp"],
                           repeat_frac=config["repeat_frac"],
                           repeat_len=config["repeat_len"])
    st = Stream(rng)
    sreads = short_reads(st, genome, config["short_coverage"],
                         config["short_read_len"])
    rl = traffic["read_len"]
    lreads = [noisy_read(st, genome, st.bounded(len(genome) - rl), rl,
                         traffic["error"], tuple(traffic["mix"]))
              for _ in range(traffic["pool_reads"])]
    return sreads, lreads
