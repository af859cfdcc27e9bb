"""CPU tests of the pass-2 cell, ecoli4m_p2.p1out_4k: it reports the
per-layer metrics of the pass-1 cell, a traced run of it at a tiny size
reads the host layers and holds the program's `index` span tree inside the
set-up's index time, and the program agrees with the reference on pass-2
reads whose qualities mark spans already corrected at maximal quality (the
max-quality skip, which the cell's '!' qualities never reach). Run from
the repository root:

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import cells, gen, job
from benchmark.fastq import decode, read_fastq

CELL = "ecoli4m_p2.p1out_4k"
# the readers that need no device trace
HOST = ("wait_share_pct", "plan_s_per_mbp", "launch_s_per_mbp",
        "finish_s_per_mbp", "index_build_s")


def test_cell_reports_the_pass1_cells_metrics():
    cell = cells.load_cell(CELL)
    assert cell.config["pass"] == 2 and cell.chips == 1
    p1 = cells.load_cell("ecoli4m_p1.ont_r9_4k")
    assert [m.name for m in cell.per_layer] == [m.name for m in p1.per_layer]
    assert set(HOST) < {m.name for m in cell.per_layer}
    assert [m.name for m in cell.end_to_end] == [
        "bases_per_s", "peak_rss_gb", "setup_s"]


def tiny_cell(read_len: int = 3200) -> cells.Cell:
    """The cell at a size the CPU runs in seconds: a 30 kbp genome, reads
    long enough to colour the graph (min_len_2nd_pass 3,000), four-read
    jobs, beam 8, 32 regions a launch."""
    cell = cells.load_cell(CELL)
    cell.config["genome_bp"] = 30000
    cell.config["options"].update(beam_width=8, batch_regions=32,
                                  read_batch_bp=8192)
    cell.traffic.update(read_len=read_len, pool_reads=8, job_reads=4,
                        warm_reads=2, check_reads=6)
    return cell


class NoProfile:
    """torch.profiler.profile's place in a traced run on the CPU: turning
    the plain route's many small ops into events takes minutes there, and
    the host readers read none of it."""

    def __init__(self, **kw):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_traced_tiny_cell_reads_the_host_layers(tmp_path, monkeypatch):
    """A traced run of the tiny cell inside the program's recording: the
    host readers read the pass-2 window, and the program's `index` tree
    (graph, then colour) lies inside the set-up's `index_build_s`."""
    from benchmark import trace as TRB
    from ratatosk_tpu_torch import trace as TR
    monkeypatch.setattr(torch.profiler, "profile", NoProfile)
    monkeypatch.setattr(TRB, "read_profile", lambda prof, clock: {})
    got = {}

    def per_layer(rec):
        got["metrics"] = cells.read_metrics(cell.per_layer, rec)

    cell = tiny_cell()
    with TR.recording() as prog:
        r = job.run_cell(cell, 7, 0.5, True, torch.device("cpu"), tmp_path,
                         time.time(), per_layer=per_layer)
    assert r.jobs
    m = got["metrics"]
    assert set(m) == set(HOST)
    assert all(v["value"] > 0 for v in m.values())
    assert m["wait_share_pct"]["value"] <= 100
    graph, colour, index = [s for s in prog.spans
                            if s.name.startswith("index")]
    assert (graph.name, colour.name, index.name) == (
        "index.graph", "index.colour", "index")
    assert index.fields["k"] == 63
    assert index.fields["reads"] == cell.traffic["pool_reads"]
    assert graph.parent == colour.parent == index.id
    assert graph.t1 <= colour.t0
    assert index.seconds() <= m["index_build_s"]["value"]


def pass1_qualities(rng, reads, max_q: int) -> list:
    """Pass-1 output's qualities, drawn: stretches of 150-900 bp, every
    other one at maximal quality (corrected), the rest at 5-20."""
    quals = []
    for r in reads:
        q = np.empty(len(r), np.uint8)
        a, top = 0, bool(rng.integers(0, 2))
        while a < len(r):
            b = min(a + int(rng.integers(150, 900)), len(r))
            q[a:b] = (33 + max_q if top
                      else rng.integers(33 + 5, 33 + 21, b - a))
            a, top = b, not top
        quals.append(q)
    return quals


def test_program_and_reference_agree_on_max_quality_spans(tmp_path):
    """Pass 2 on reads carrying pass-1 style qualities: the program's FASTQ
    and the reference's records agree read for read, and the skip fires
    (the plan spans' maxq_bp)."""
    from benchmark.reference import engine as E
    from benchmark.reference import index as I
    from benchmark.reference.config import CorrectOpt as RefOpt
    from ratatosk_tpu_torch import pipeline
    from ratatosk_tpu_torch import trace as TR
    from ratatosk_tpu_torch.config import CorrectOpt
    from ratatosk_tpu_torch.correct import engine

    cell = tiny_cell()
    sreads, reads = gen.simulate(cell.config, cell.traffic, 11)
    opt = CorrectOpt(**cell.config["options"])
    quals = pass1_qualities(np.random.default_rng(11), reads, opt.max_qual)
    path = Path(tmp_path) / "p1out.fq"
    with open(path, "w") as f:
        for i, (r, q) in enumerate(zip(reads, quals)):
            f.write(f"@L{i}\n{decode(r)}\n+\n{q.tobytes().decode()}\n")

    o2 = pipeline._pass_opt(opt, 2)
    cdbg, colors = pipeline.build_pass2_index(
        opt, zip(reads, quals), sreads, list(range(len(sreads))))
    corr = engine.Corrector(cdbg, colors, o2, device="cpu")
    out = str(Path(tmp_path) / "p2.fq")
    with TR.recording() as rec:
        pipeline.correct_file(corr, o2, [str(path)], out, 2)
    assert sum(s.fields["maxq_bp"] for s in rec.spans
               if s.name == "plan") > 0
    got = {name: (seq, q) for name, seq, q in read_fastq(out)}

    ropt = RefOpt(**cell.config["options"])
    rcdbg, rcolors = I.build_index(ropt, 2, sreads, zip(reads, quals))
    ref = E.Corrector(rcdbg, rcolors, I.pass_opt(ropt, 2), device="cpu")
    want = {f"L{i}": (cr.seq, cr.qual_str)
            for i, cr in enumerate(ref.correct_batch(reads, quals))}
    assert list(got) == [f"L{i}" for i in range(len(reads))]
    assert got == want
