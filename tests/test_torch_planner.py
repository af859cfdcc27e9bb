"""The host planner (ratatosk_tpu_torch/correct/planner.py) keeps each
plan's state inside the call: two threads planning different batches at
once on one Planner each get the plan of their batch planned alone, field
for field, with the plan span's maxq_bp, in pass 1 and in pass 2 with
qualities (the max-quality skip) and haplotypes, over 20 rounds."""

from __future__ import annotations

import dataclasses
import sys
import threading

import numpy as np
import pytest

from ratatosk_tpu_torch import pipeline
from ratatosk_tpu_torch import testing as T
from ratatosk_tpu_torch import trace as TR
from ratatosk_tpu_torch.config import CorrectOpt
from ratatosk_tpu_torch.correct.planner import Planner
from ratatosk_tpu_torch.graph import phasing as PH

ROUNDS = 20


@pytest.fixture(scope="module")
def planners():
    """{pass: (Planner, [batch A, batch B])} over a 20 kbp genome whose
    repeats make gap regions between anchors on different unitigs: pass 1's
    k=31 graph and twelve long reads at 10% error, pass 2's k=63 graph
    coloured by twelve reads at 1.2% with qualities, the first half of each
    at the maximal quality; a batch is (reads, quals, names), and half the
    short reads and a third of the long reads are phased."""
    rng = np.random.default_rng(2222)
    genome = T.random_genome(rng, 20000, repeat_frac=0.1, repeat_len=120)
    sreads = T.short_reads(rng, genome, coverage=30.0, read_len=100)
    ids = list(range(len(sreads)))
    snames = [f"s{i}" for i in ids]
    hap = PH.HapReads(
        read2hap={**{n: i % 2 for i, n in enumerate(snames[::2])},
                  **{f"r{i}": i % 2 for i in range(0, 12, 3)}},
        block_ids={"b": 0}, n_haps=2)
    PH.bind_colors(hap, snames, ids)
    opt = CorrectOpt(small_k=31, k=63, beam_width=8, batch_regions=32,
                     weak_seed_min_gap=80)
    names = [f"r{i}" for i in range(12)]
    p1 = [n for n, _, _ in T.long_reads(rng, genome, n=12, min_len=1500,
                                        max_len=2500, err=0.10)]
    p2 = [n for n, _, _ in T.long_reads(rng, genome, n=12, min_len=1500,
                                        max_len=2500, err=0.012)]
    quals = []
    for r in p2:
        q = rng.integers(33 + 5, 33 + 30, len(r)).astype(np.uint8)
        q[:len(r) // 2] = 33 + opt.max_qual
        quals.append(q)
    o1, o2 = pipeline._pass_opt(opt, 1), pipeline._pass_opt(opt, 2)
    cdbg1, col1 = pipeline.build_pass1_index(o1, sreads, ids)
    cdbg2, col2 = pipeline.build_pass2_index(o2, zip(p2, quals), sreads, ids)
    out = {}
    for pass_no, o, cdbg, col, reads, qs in ((1, o1, cdbg1, col1, p1, None),
                                             (2, o2, cdbg2, col2, p2, quals)):
        batches = [(reads[a:b], None if qs is None else qs[a:b], names[a:b])
                   for a, b in ((0, 6), (6, 12))]
        out[pass_no] = (Planner(cdbg, col, o, hap), batches)
    return out


def _plan(planner, batch, rec):
    """The batch's plan on this thread and its plan span's maxq_bp, from
    `rec`, the recording open around it."""
    got = planner.plan_batch(*batch, {"plan": 0.0})
    plan, = [s for s in rec.spans if s.name == "plan"
             and s.thread == threading.get_native_id()]
    return got, plan.fields["maxq_bp"]


def _same(a, b, where="plan"):
    """Equal, arrays by dtype and value, dataclasses field by field."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    elif dataclasses.is_dataclass(a):
        assert type(a) is type(b), where
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    else:
        assert type(a) is type(b) and a == b, where


@pytest.mark.parametrize("pass_no", [1, 2])
def test_two_threads_plan_on_one_planner_as_alone(planners, pass_no):
    planner, batches = planners[pass_no]
    alone = []
    for batch in batches:
        with TR.recording() as rec:
            alone.append(_plan(planner, batch, rec))
    for (reads_np, plans, regions), maxq in alone:
        assert regions and (maxq > 0) == (pass_no == 2)
    haps = {planner.hap.hap_of(n) for _, _, names in batches for n in names}
    assert haps == {-1, 0, 1}
    # switch threads often, so that the two plans interleave finely
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for r in range(ROUNDS):
            start = threading.Barrier(2)
            got, errors = [None, None], []

            def run(i):
                try:
                    start.wait()
                    got[i] = _plan(planner, batches[i], rec)
                except BaseException as e:   # reported below
                    errors.append(e)

            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(2)]
            with TR.recording() as rec:
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
            assert not errors, errors
            for i in range(2):
                _same(got[i], alone[i], f"round {r}, batch {i}")
    finally:
        sys.setswitchinterval(interval)
