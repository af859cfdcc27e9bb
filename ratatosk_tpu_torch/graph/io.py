"""Index serialization: the 4-step `index`/`correct` artifact contract.

The reference persists its graph as gz-FASTA + `.bfi` (Bifrost) and its
annotations as `.rtsk` (writeGraphData/readGraphData, Graph.cpp:722-801),
letting any pass restart on another machine (SURVEY.md §5 checkpoint/resume).
We persist the whole colored cDBG as one compressed .npz per (pass, k):
`<prefix>.index.k<k>.npz`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ratatosk_tpu_torch.graph.build import Cdbg
from ratatosk_tpu_torch.graph.colors import GraphColors
from ratatosk_tpu_torch.ops.kmer_index import KmerIndex

FORMAT_VERSION = 1


def index_path(prefix: str, k: int) -> str:
    return f"{prefix}.index.k{k}.npz"


def save_index(path: str, cdbg: Cdbg, colors: Optional[GraphColors]) -> None:
    arrays = dict(
        version=np.int64(FORMAT_VERSION),
        k=np.int64(cdbg.k),
        useq=cdbg.useq, uoff=cdbg.uoff, edges=cdbg.edges,
        keys_lo=np.asarray(cdbg.index.keys_lo),
        kidx_uid=np.asarray(cdbg.index.unitig_id),
        kidx_pos=np.asarray(cdbg.index.pos),
        kidx_strand=np.asarray(cdbg.index.strand),
    )
    if cdbg.index.two_word:
        arrays["keys_hi"] = np.asarray(cdbg.index.keys_hi)
    if colors is not None:
        arrays.update(
            color_cap=np.int64(colors.cap),
            color_rows=colors.rows, color_card=colors.card,
            coverage=colors.coverage, edge_support=colors.edge_support,
            n_colors=np.int64(colors.n_colors),
        )
        if colors.edge_rescued is not None:
            arrays["edge_rescued"] = colors.edge_rescued
    np.savez_compressed(path, **arrays)


def load_index(path: str) -> Tuple[Cdbg, Optional[GraphColors]]:
    z = np.load(path)
    if int(z["version"]) != FORMAT_VERSION:
        raise ValueError(f"{path}: unsupported index version {int(z['version'])}")
    k = int(z["k"])
    index = KmerIndex(
        k=k,
        keys_lo=z["keys_lo"],
        keys_hi=z["keys_hi"] if "keys_hi" in z.files else None,
        unitig_id=z["kidx_uid"], pos=z["kidx_pos"], strand=z["kidx_strand"],
    )
    cdbg = Cdbg(k=k, useq=z["useq"], uoff=z["uoff"], index=index, edges=z["edges"])
    colors = None
    if "color_rows" in z.files:
        colors = GraphColors(
            cap=int(z["color_cap"]), rows=z["color_rows"], card=z["color_card"],
            coverage=z["coverage"], edge_support=z["edge_support"],
            n_colors=int(z["n_colors"]),
            edge_rescued=(z["edge_rescued"] if "edge_rescued" in z.files
                          else None),
        )
    return cdbg, colors
