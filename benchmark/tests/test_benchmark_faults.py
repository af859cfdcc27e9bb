"""The comparison that decides `correct` catches what it must, at a tiny
size on the CPU: a run with the timed path broken underneath comes out not
correct, once for each fault a correction job can have, and the control
(the reference with its scores in bfloat16, in the program's place) fails
where the program passes. The look for a card is skipped: the run is driven
through run.run on the CPU. (A job runs on one card: there is no exchange
between cards to leave out.)"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from benchmark import control
from benchmark.tests.test_benchmark_harness import CELLS, run_tiny, tiny


def _raw(corrected, codes):
    return corrected.__class__(codes=codes.copy(),
                               qual=np.full(len(codes), 33, np.uint8),
                               n_solid=0, n_regions=0, n_corrected=0)


def state_unchanged(orig):
    """Every read comes back as it went in."""
    def assemble(self, reads_np, quals, plans, regions):
        out = orig(self, reads_np, quals, plans, regions)
        return [_raw(cr, r) for cr, r in zip(out, reads_np)]
    return assemble


def half_left_out(orig):
    """Only the first half of each batch's reads comes back."""
    def assemble(self, reads_np, quals, plans, regions):
        out = orig(self, reads_np, quals, plans, regions)
        return out[:len(out) // 2]
    return assemble


def answer_altered(orig):
    """Each corrected read's first base is changed where it is made."""
    def assemble(self, reads_np, quals, plans, regions):
        out = orig(self, reads_np, quals, plans, regions)
        for cr in out:
            cr.codes = cr.codes.copy()
            cr.codes[0] = (cr.codes[0] + 1) % 4
        return out
    return assemble


@pytest.mark.parametrize("fault", [state_unchanged, half_left_out,
                                   answer_altered])
@pytest.mark.parametrize("name", CELLS)
def test_broken_path_is_not_correct(monkeypatch, name, fault):
    from ratatosk_tpu_torch.correct.engine import Corrector
    monkeypatch.setattr(Corrector, "assemble_batch",
                        fault(Corrector.assemble_batch))
    out = run_tiny(tiny(name), seconds=0.1)
    assert out["correct"] is False
    assert out["failed"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_program_passes(name):
    cell = tiny(name, genome_bp=60000)
    cell.traffic.update(check_reads=8)
    row = control.readings(cell, 4, 3.0, torch.device("cpu"), time.time())
    assert row["program"] == {"reads_missing": 0, "reads_differ": 0}
    assert row["control"]["reads_differ"] >= 1
