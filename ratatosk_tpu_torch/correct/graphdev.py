"""Device-resident view of the colored cDBG for the correction hot path.

Counterpart of ratatosk_tpu/correct/graphdev.py, with the same fields and the
same padding: the flat 2-bit unitig catalog, the support-masked successor
table and the hashed color signatures, as torch tensors on an explicit
device. Everything else (color rows, the k-mer index) stays host-side.

Edge read-support (UnitigData.shared_pids, Graph.cpp:2003) is folded into the
successor table at build time (unsupported edge => -1). The power-of-two
padding is kept so that the port's arrays equal the JAX package's, field for
field, and both index the same rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ratatosk_tpu_torch.graph.build import Cdbg
from ratatosk_tpu_torch.graph.colors import GraphColors
from ratatosk_tpu_torch.ops import colorset as CS


@dataclasses.dataclass
class DeviceGraph:
    k: int                    # k-mer length of the graph
    useq: torch.Tensor        # uint8 [total_bp] 2-bit codes
    utbl: torch.Tensor        # int32 [N, 2, 6]: per leaving strand d the 4
                              # support-masked successors (packed v<<1|dir,
                              # -1 = absent/unsupported; bit 30 = rescued by
                              # the k2 graph, exempt from the color filter),
                              # then ulen, uoff
    color_sig: torch.Tensor   # int8 [N, SIG_BINS] hashed color indicator

    @staticmethod
    def from_host(cdbg: Cdbg, colors: GraphColors,
                  device: torch.device) -> "DeviceGraph":
        if cdbg.uoff[-1] >= (1 << 31):
            raise ValueError("unitig catalog exceeds int32 addressing; "
                             "shard the index before device upload")

        def pad_n(x, fill, min_size=1 << 14):
            x = np.asarray(x)
            n2 = max(min_size, 1 << int(np.ceil(np.log2(max(len(x), 1)))))
            if n2 == len(x):
                return x
            out = np.full((n2,) + x.shape[1:], fill, dtype=x.dtype)
            out[:len(x)] = x
            return out

        n = cdbg.n_unitigs
        edges_sup = np.where(colors.edge_support, cdbg.edges, -1)
        if colors.edge_rescued is not None:
            edges_sup = np.where((edges_sup >= 0) & colors.edge_rescued,
                                 edges_sup | (1 << 30), edges_sup)
        utbl = np.empty((n, 2, 6), dtype=np.int32)
        utbl[:, :, :4] = edges_sup
        utbl[:, :, 4] = cdbg.ulen.astype(np.int32)[:, None]
        utbl[:, :, 5] = cdbg.uoff[:-1].astype(np.int32)[:, None]
        utbl_p = pad_n(utbl, -1)
        utbl_p[n:, :, 4:] = 0      # padded rows: no successors, empty unitig
        return DeviceGraph.from_numpy(dict(
            k=cdbg.k,
            useq=pad_n(cdbg.useq, 0, min_size=1 << 22),
            utbl=utbl_p,
            color_sig=pad_n(CS.color_signature(colors.rows), 0)), device)

    @staticmethod
    def from_numpy(fields: dict, device: torch.device) -> "DeviceGraph":
        """Upload host arrays: `k` (or the JAX graph's `kval`), `useq`,
        `utbl`, `color_sig` — e.g. np.asarray of each field of a JAX
        DeviceGraph, so both packages search the same graph."""
        k = fields["k"] if "k" in fields else fields["kval"]

        def put(x, dtype):
            return torch.tensor(np.asarray(x, dtype=dtype), device=device)

        return DeviceGraph(
            k=int(k),
            useq=put(fields["useq"], np.uint8),
            utbl=put(fields["utbl"], np.int32),
            color_sig=put(fields["color_sig"], np.int8))

    def to(self, device: torch.device) -> "DeviceGraph":
        """A copy on another device (a mesh replica)."""
        return DeviceGraph(k=self.k, useq=self.useq.to(device),
                           utbl=self.utbl.to(device),
                           color_sig=self.color_sig.to(device))
