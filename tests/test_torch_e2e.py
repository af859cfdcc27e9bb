"""The port end to end on the CPU against the JAX package: Corrector
.correct_batch on the tests/test_correct_e2e.py fixtures, and the two-pass
correct_file flow on a tests/test_pipeline.py-style dataset, with and
without the planning double buffer. Codes, qualities and FASTQ bytes must be
identical (tolerance 0)."""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from ratatosk_tpu import pipeline as JP
from ratatosk_tpu.config import CorrectOpt as JOpt
from ratatosk_tpu.correct.engine import Corrector as JCorrector
from ratatosk_tpu.graph import build as JB
from ratatosk_tpu.graph.colors import color_graph as j_color_graph
from ratatosk_tpu.io import fastx as JFX
from ratatosk_tpu_torch import dna
from ratatosk_tpu_torch import pipeline as TP
from ratatosk_tpu_torch.config import CorrectOpt as TOpt
from ratatosk_tpu_torch.correct.engine import Corrector as TCorrector
from ratatosk_tpu_torch.graph import build as TB
from ratatosk_tpu_torch.graph.colors import color_graph as t_color_graph
from ratatosk_tpu_torch.io import fastx as TFX
from tests import sim
from tests.torch_parity import one_torch_thread  # noqa: F401

K = 21
K1, K2 = 17, 31


@pytest.mark.parametrize("seed,glen,repeat_frac", [
    (100, 12000, 0.0),   # test_correct_simple_genome
    (101, 15000, 0.2),   # test_correct_repetitive_genome
])
def test_correct_batch_matches_jax(seed, glen, repeat_frac):
    rng = np.random.default_rng(seed)
    genome = sim.random_genome(rng, glen, repeat_frac=repeat_frac,
                               repeat_len=200)
    sreads = sim.short_reads(rng, genome, coverage=40.0, read_len=120)
    lreads = sim.long_reads(rng, genome, n=3, min_len=1500, max_len=2500,
                            err=0.10)
    reads = [x[0] for x in lreads]
    cdbg = JB.build_cdbg(sreads, K, min_count=2)
    want = JCorrector(cdbg, j_color_graph(cdbg, sreads),
                      JOpt(small_k=K, k=63, beam_width=8, batch_regions=32)
                      ).correct_batch(reads)
    tcdbg = TB.build_cdbg(sreads, K, min_count=2)
    corr = TCorrector(tcdbg, t_color_graph(tcdbg, sreads),
                      TOpt(small_k=K, k=63, beam_width=8, batch_regions=32),
                      device="cpu")
    got = corr.correct_batch(reads)
    assert corr.timers["launch"] > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.codes, w.codes)
        np.testing.assert_array_equal(g.qual, w.qual)
        assert (g.n_solid, g.n_regions, g.n_corrected) == (
            w.n_solid, w.n_regions, w.n_corrected)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_e2e")
    rng = np.random.default_rng(200)
    genome = sim.random_genome(rng, 10000)
    sreads = sim.short_reads(rng, genome, coverage=40.0, read_len=100)
    lreads = sim.long_reads(rng, genome, n=3, min_len=1500, max_len=2500,
                            err=0.09)
    lr_path = str(tmp / "long.fastq")
    with open(lr_path, "w") as f:
        for i, (noisy, _, _) in enumerate(lreads):
            f.write(f"@lr{i}\n{dna.decode(noisy)}\n+\n{'!' * len(noisy)}\n")
    return tmp, sreads, lreads, lr_path


def _two_pass(pl, Corrector, read_fastx, opt, sreads, lr_path, out, **kw):
    """Pass 1, the pass-2 index and pass 2, through the entry points that
    bench.py calls. Returns the two FASTQ files' bytes."""
    ids = list(range(len(sreads)))
    o1 = pl._pass_opt(opt, 1)
    cdbg, colors = pl.build_pass1_index(opt, sreads, ids)
    pl.correct_file(Corrector(cdbg, colors, o1, **kw), o1, [lr_path],
                    out + ".2.fastq", 1)
    cdbg2, colors2 = pl.build_pass2_index(
        opt, ((r.codes, r.qual) for r in read_fastx(out + ".2.fastq")),
        sreads, ids)
    o2 = pl._pass_opt(opt, 2)
    pl.correct_file(Corrector(cdbg2, colors2, o2, **kw), o2,
                    [out + ".2.fastq"], out + ".fastq", 2)
    return tuple(Path(out + s).read_bytes() for s in (".2.fastq", ".fastq"))


@pytest.fixture(scope="module")
def jax_two_pass(dataset):
    tmp, sreads, _, lr = dataset
    opt = JOpt(small_k=K1, k=K2, beam_width=8, batch_regions=32,
               read_batch_bp=2000)
    return _two_pass(JP, JCorrector, JFX.read_fastx, opt, sreads, lr,
                     str(tmp / "jax"))


@pytest.mark.parametrize("nb_threads", [1, 2])
def test_two_pass_correct_file_matches_jax(dataset, jax_two_pass, nb_threads):
    tmp, sreads, lreads, lr = dataset
    opt = TOpt(small_k=K1, k=K2, beam_width=8, batch_regions=32,
               read_batch_bp=2000, nb_threads=nb_threads)
    got = _two_pass(TP, TCorrector, TFX.read_fastx, opt, sreads, lr,
                    str(tmp / f"torch{nb_threads}"), device="cpu")
    assert got[0] == jax_two_pass[0], "pass-1 FASTQ differs"
    assert got[1] == jax_two_pass[1], "pass-2 FASTQ differs"
    recs = list(TFX.read_fastx(str(tmp / f"torch{nb_threads}.fastq")))
    assert [r.name for r in recs] == [f"lr{i}" for i in range(len(lreads))]
    raw = np.mean([sim.error_rate(n, t) for n, t, _ in lreads])
    cor = np.mean([sim.error_rate(r.codes, t)
                   for r, (_, t, _) in zip(recs, lreads)])
    assert cor < raw / 4, f"{cor:.4f} vs raw {raw:.4f}"


def test_two_pass_device_planner_matches_jax(dataset, jax_two_pass):
    """plan_on_device on the double buffer's worker thread: the planner's
    work and the launches interleave, and the bytes stay the same."""
    tmp, sreads, _, lr = dataset
    opt = TOpt(small_k=K1, k=K2, beam_width=8, batch_regions=32,
               read_batch_bp=2000, nb_threads=2, plan_on_device=True)
    got = _two_pass(TP, TCorrector, TFX.read_fastx, opt, sreads, lr,
                    str(tmp / "torch_devplan"), device="cpu")
    assert got == jax_two_pass


def test_unported_paths_raise(dataset):
    """No device is quietly dropped or swapped: `--devices N` with fewer than
    N visible devices raises, as does a CUDA device torch cannot see. One
    device, or `--devices 0` with one visible, gives no mesh (the mesh and
    the multi-host run are ported: tests/test_torch_parallel.py,
    tests/test_torch_distributed.py)."""
    _, _, _, lr = dataset
    for n_devices in (2, 8):
        opt = TOpt(small_k=K1, k=K2, n_devices=n_devices,
                   filename_seq_in=[lr], filename_long_in=[lr])
        with pytest.raises(RuntimeError, match=f"--devices {n_devices}"):
            TP.run_correct(opt, device="cpu")
    for n_devices in (0, 1):
        assert TP.local_mesh(TOpt(n_devices=n_devices), "cpu") is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TP.local_mesh(TOpt(n_devices=1), "cuda")
    elif torch.cuda.device_count() == 1:
        with pytest.raises(RuntimeError, match="--devices 2"):
            TP.local_mesh(TOpt(n_devices=2), "cuda")
    assert os.path.exists(lr)
