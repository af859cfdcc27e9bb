"""Sharded k-mer index: the sorted keys range-partitioned over a mesh.

Counterpart of ratatosk_tpu/parallel/sharded_index.py. For an index that
outgrows one device (the reference needs a 448 GB node for human), the
sorted canonical-key array is split into equal contiguous ranges: slot i
holds keys [i*per, (i+1)*per) on its device. A lookup binary-searches every
shard for the whole query batch with the reference's fixed step count
(ops/kmer_index.search, as the one-device lookup does); keys
are sorted, so a query hits at most one shard and misses answer -1. The
per-shard answers move to slot 0's device and a max combines them (the
reference's `pmax`).

Both key widths shard: one uint64 word (k <= 32) and two, ordered by
(hi, lo) (the pass-2 k=63 index, the one that outgrows a device).

torch holds the uint64 words as int64 of the same bits. Signed order is not
unsigned order: the all-ones padding key would read as -1 and sort first,
and k=63 `lo` words use bit 63. So keys and queries have bit 63 flipped
before any comparison, which maps unsigned order onto signed order and
leaves equality as it was.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ratatosk_tpu_torch.ops.kmer_index import KmerIndex, search, signed
from ratatosk_tpu_torch.parallel.mesh import Mesh

class ShardedKmerIndex:
    """Sorted key array split into equal contiguous ranges over a mesh's
    slots."""

    def __init__(self, index: KmerIndex, mesh: Mesh):
        self.mesh = mesh
        self.k = index.k
        self.two_word = index.two_word
        n_dev = mesh.size
        n = index.n
        per = -(-n // n_dev)
        self.n = n
        self.per = per
        pad = per * n_dev - n
        maxkey = np.uint64(0xFFFFFFFFFFFFFFFF)

        def shards(x, fill, conv=np.asarray):
            x = conv(np.concatenate([np.asarray(x),
                                     np.full(pad, fill, np.asarray(x).dtype)]))
            return [torch.from_numpy(x[i * per:(i + 1) * per].copy()).to(dev)
                    for i, dev in enumerate(mesh.devices)]

        self.keys = shards(index.keys_lo, maxkey, signed)
        self.keys_hi = (shards(index.keys_hi, maxkey, signed)
                        if self.two_word else None)
        self.uid = shards(index.unitig_id.astype(np.int32), -1)
        self.pos = shards(index.pos.astype(np.int32), 0)
        self.strand = shards(index.strand.astype(np.int32), 0)

    def _local(self, i: int, q_lo: torch.Tensor, q_hi: Optional[torch.Tensor]):
        """Shard i's answers (uid, pos, strand) for the whole batch, -1 where
        the key is not in the shard."""
        safe, found = search(self.keys[i],
                             self.keys_hi[i] if self.two_word else None,
                             q_lo, q_hi)
        safe = safe.long()
        miss = torch.tensor(-1, dtype=torch.int32, device=q_lo.device)
        return tuple(torch.where(found, a[i][safe], miss)
                     for a in (self.uid, self.pos, self.strand))

    def lookup(self, q_lo, q_hi=None):
        """Canonical uint64 queries [Q] (NumPy) -> (uid, pos, strand) int32
        tensors [Q] on slot 0's device, -1 where absent. Two-word indexes
        require q_hi."""
        if self.two_word and q_hi is None:
            raise ValueError("two-word index lookup requires q_hi")
        dev0 = self.mesh.devices[0]
        if self.per == 0:
            miss = torch.full((len(q_lo),), -1, dtype=torch.int32, device=dev0)
            return miss, miss.clone(), miss.clone()
        lo_h = torch.from_numpy(signed(q_lo))
        hi_h = torch.from_numpy(signed(q_hi)) if self.two_word else None
        parts = []
        for i, dev in enumerate(self.mesh.devices):
            res = self._local(i, lo_h.to(dev),
                              hi_h.to(dev) if hi_h is not None else None)
            parts.append([t.to(dev0) for t in res])
        # each key lives in one shard: the max over shards is its answer
        return tuple(torch.stack([p[j] for p in parts]).amax(dim=0)
                     for j in range(3))
