"""Phasing: read -> haplotype assignments and haplotype-aware color filtering.

Reference: `HapReads` (Common.hpp:192-223), `addPhasing`
(Graph.cpp:3368-3671) — a TSV `name \t haplotype \t haploblock` (gz ok) maps
each read to a (haploblock << 1 | haplotype) id; a name colliding across
haplotypes becomes unphased. During correction, anchor color sets are
intersected with the read's haplotype partners (chooseColors,
Correction.cpp:256) so a phased long read is corrected with short reads from
its own haplotype plus unphased reads.
"""

from __future__ import annotations

import dataclasses
import gzip
from typing import Dict, List, Optional, Sequence

import numpy as np

from ratatosk_tpu_torch.ops import colorset as CS


@dataclasses.dataclass
class HapReads:
    """Read-name -> haplotype-id mapping plus per-haplotype color sets."""

    read2hap: Dict[str, int]
    block_ids: Dict[str, int]                 # haploblock name -> block index
    n_haps: int                               # number of (block, hap) ids
    hap_colors: Optional[List[np.ndarray]] = None   # color ids per hap id
    unphased_colors: Optional[np.ndarray] = None

    def hap_of(self, name: str) -> int:
        return self.read2hap.get(name, -1)


def _open(path: str):
    return gzip.open(path, "rt") if path.endswith(".gz") else open(path)


def load_phasing(paths: Sequence[str]) -> HapReads:
    """Parse phasing TSVs. Collisions (same read, different hap) -> unphased
    (Graph.cpp:3552-3557)."""
    read2hap: Dict[str, int] = {}
    block_ids: Dict[str, int] = {}
    collided = set()
    for p in paths:
        with _open(p) as f:
            for line in f:
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 3 or not parts[0]:
                    continue
                name, hap, block = parts[0], parts[1], parts[2]
                bid = block_ids.setdefault(block, len(block_ids))
                try:
                    h = int(hap)
                except ValueError:
                    h = abs(hash(hap)) & 1
                hap_id = (bid << 1) | (h & 1)
                prev = read2hap.get(name)
                if prev is not None and prev != hap_id:
                    collided.add(name)
                read2hap[name] = hap_id
    for name in collided:
        del read2hap[name]
    return HapReads(read2hap=read2hap, block_ids=block_ids,
                    n_haps=2 * len(block_ids))


def bind_colors(hap: HapReads, read_names: Sequence[str],
                read_ids: Sequence[int]) -> None:
    """Group short-read color ids by haplotype (reference: per-hap PairIDs,
    Common.hpp:214-216). Unassigned reads form the unphased set."""
    per_hap: Dict[int, list] = {}
    unphased = []
    for name, cid in zip(read_names, read_ids):
        h = hap.hap_of(name)
        if h < 0:
            unphased.append(cid)
        else:
            per_hap.setdefault(h, []).append(cid)
    hap.hap_colors = [np.unique(np.asarray(per_hap.get(h, []), dtype=np.int32))
                      for h in range(hap.n_haps)]
    hap.unphased_colors = np.unique(np.asarray(unphased, dtype=np.int32))


def filter_colors_by_hap(colors_row: np.ndarray, hap: HapReads,
                         hap_id: int) -> np.ndarray:
    """Restrict a padded color row to the given haplotype + unphased reads.

    Mirrors chooseColors' intersection with haplotype partners
    (Correction.cpp:256). Returns a padded sorted row of the same width.
    """
    if hap_id < 0 or hap.hap_colors is None:
        return colors_row
    allowed = np.concatenate([hap.hap_colors[hap_id], hap.unphased_colors])
    keep = np.isin(colors_row, allowed)
    out = np.where(keep, colors_row, CS.PAD)
    return np.sort(out)
