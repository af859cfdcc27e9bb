"""Small synthetic setups shared by chip_smoke.py and the tests."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ratatosk_tpu_torch import dna
from ratatosk_tpu_torch.config import CorrectOpt
from ratatosk_tpu_torch.correct.engine import Corrector, RegionSpec
from ratatosk_tpu_torch.correct.planner import _Call
from ratatosk_tpu_torch.correct.seeds import filter_runs_by_color, find_runs
from ratatosk_tpu_torch.graph import build as B
from ratatosk_tpu_torch.graph.colors import color_graph


def random_genome(rng, length: int, repeat_frac: float = 0.0,
                  repeat_len: int = 200) -> np.ndarray:
    g = rng.integers(0, 4, size=length).astype(np.uint8)
    n_rep = int(length * repeat_frac / max(repeat_len, 1))
    for _ in range(n_rep):
        src = rng.integers(0, length - repeat_len)
        dst = rng.integers(0, length - repeat_len)
        g[dst:dst + repeat_len] = g[src:src + repeat_len]
    return g


def short_reads(rng, genome: np.ndarray, coverage: float,
                read_len: int = 120, err: float = 0.0) -> List[np.ndarray]:
    """Uniformly sampled short reads, random strand, optional errors."""
    n = int(len(genome) * coverage / read_len)
    out = []
    for _ in range(n):
        s = rng.integers(0, len(genome) - read_len + 1)
        r = genome[s:s + read_len].copy()
        if err > 0:
            mask = rng.random(read_len) < err
            r[mask] = (r[mask] + rng.integers(1, 4, size=int(mask.sum()))) % 4
        if rng.random() < 0.5:
            r = dna.revcomp_codes(r)
        out.append(r.astype(np.uint8))
    return out


def noisy_read(rng, genome: np.ndarray, start: int, length: int,
               err: float, mix=(0.5, 0.25, 0.25)
               ) -> Tuple[np.ndarray, np.ndarray]:
    """One ONT-like read: (noisy codes, true codes). mix = (sub, ins, del)."""
    true = genome[start:start + length]
    out = []
    i = 0
    p_sub, p_ins, _ = mix
    while i < len(true):
        r = rng.random()
        if r < err * p_sub:
            out.append((true[i] + rng.integers(1, 4)) % 4)
            i += 1
        elif r < err * (p_sub + p_ins):
            out.append(rng.integers(0, 4))     # insertion: no i advance
        elif r < err:
            i += 1                             # deletion
        else:
            out.append(true[i])
            i += 1
    return np.array(out, dtype=np.uint8), true.astype(np.uint8)


def long_reads(rng, genome: np.ndarray, n: int, min_len: int = 2000,
               max_len: int = 8000, err: float = 0.10):
    """n noisy long reads; returns list of (noisy, true, start)."""
    out = []
    for _ in range(n):
        length = int(rng.integers(min_len, min(max_len, len(genome)) + 1))
        start = int(rng.integers(0, len(genome) - length + 1))
        noisy, true = noisy_read(rng, genome, start, length, err)
        out.append((noisy, true, start))
    return out


def error_rate(a: np.ndarray, b: np.ndarray) -> float:
    """Edit distance / len(b) via numpy row DP (oracle; also used in tests)."""
    if len(a) == 0:
        return 1.0 if len(b) else 0.0
    n = len(b)
    j_idx = np.arange(n + 1, dtype=np.int64)
    prev = j_idx.copy()
    for i in range(len(a)):
        d = np.concatenate((
            [i + 1],
            np.minimum(prev[:-1] + (b != a[i]), prev[1:] + 1),
        ))
        prev = j_idx + np.minimum.accumulate(d - j_idx)
    return float(prev[-1]) / max(n, 1)


def build_toy_corrector(seed: int = 0, glen: int = 6000, k: int = 17,
                        coverage: float = 30.0,
                        opt: Optional[CorrectOpt] = None, *, device,
                        impl: str = "auto"):
    """Tiny colored cDBG + Corrector on `device`."""
    rng = np.random.default_rng(seed)
    genome = random_genome(rng, glen, repeat_frac=0.1, repeat_len=120)
    sreads = short_reads(rng, genome, coverage)
    cdbg = B.build_cdbg(sreads, k, min_count=2)
    colors = color_graph(cdbg, sreads)
    opt = opt or CorrectOpt(small_k=k, k=63, beam_width=8, batch_regions=32)
    return genome, Corrector(cdbg, colors, opt, device=device,
                             impl=impl)


def toy_region_specs(corr: Corrector, genome: np.ndarray, rng,
                     n_regions: int, err: float = 0.10) -> List[RegionSpec]:
    """Plan real weak regions from noisy reads over the toy graph."""
    specs: List[RegionSpec] = []
    tries = 0
    while len(specs) < n_regions and tries < 50:
        tries += 1
        start = int(rng.integers(0, max(len(genome) - 1200, 1)))
        noisy, _ = noisy_read(rng, genome, start, min(1000, len(genome) - start), err)
        runs = filter_runs_by_color(find_runs(corr.cdbg, noisy), corr.colors)
        corr.planner._plan_read(_Call(), 0, noisy, specs, runs, [], -1, None)
    return specs[:n_regions]
