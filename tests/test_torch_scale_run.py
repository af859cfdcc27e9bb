"""scripts/scale_run_torch.py on the CPU against the JAX package (tolerance
0): its simulated data equals scripts/scale_run.py's, and its two passes,
over several read batches with the planning double buffer, write the FASTQ
bytes and score the residual errors that the JAX package's same calls give
on the same data. The beam and the launches are cut (beam 8, 32 regions a
launch) so that the plain versions run in seconds on the CPU; the card
runs the script's own options."""

import importlib.util
import json
import tempfile
from pathlib import Path

import numpy as np
import pytest

from tests.torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
GENOME_BP, N_READS, BATCH_BP = 20_000, 6, 1 << 12   # three read batches
OPT = dict(beam_width=8, batch_regions=32)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def S():
    return _script("scale_run_torch")


def _jax_data(genome_bp, n_reads, lr_path):
    """scripts/scale_run.py:75-97's simulation, step by step."""
    from ratatosk_tpu import dna, testing
    fast_short_reads = _script("scale_run").fast_short_reads
    rng = np.random.default_rng(20)
    genome = testing.random_genome(rng, genome_bp, repeat_frac=0.10,
                                   repeat_len=300)
    sreads = fast_short_reads(rng, genome, coverage=40.0)
    truths = {}
    with open(lr_path, "w") as f:
        for i in range(n_reads):
            start = int(rng.integers(0, genome_bp - 4000))
            noisy, true = testing.noisy_read(rng, genome, start, 4000,
                                             err=0.10)
            if i < 400:
                truths[f"L{i}"] = true
            f.write(f"@L{i}\n{dna.decode(noisy)}\n+\n{'!' * len(noisy)}\n")
    return genome, sreads, truths


def test_simulated_data_equals_scale_run(S, tmp_path):
    genome, sreads, truths = _jax_data(60_000, 24, tmp_path / "jax.fq")
    rng, tgenome, tsreads = S.simulate_short(60_000)
    ttruths, total = S.write_long_reads(rng, tgenome, 24, tmp_path / "t.fq")
    np.testing.assert_array_equal(tgenome, genome)
    assert len(tsreads) == len(sreads) == 24_000
    np.testing.assert_array_equal(np.stack(tsreads), np.stack(sreads))
    assert (tmp_path / "t.fq").read_bytes() == (tmp_path / "jax.fq").read_bytes()
    assert ttruths.keys() == truths.keys()
    for name, t in truths.items():
        np.testing.assert_array_equal(ttruths[name], t)
    assert total == sum(len(r.codes) for r in _read(tmp_path / "t.fq"))


def _read(path):
    from ratatosk_tpu.io import fastx
    return list(fastx.read_fastx(str(path)))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's two passes on scale_run.py's data."""
    from ratatosk_tpu.config import CorrectOpt
    from ratatosk_tpu.correct.engine import Corrector
    from ratatosk_tpu.graph import build as B
    from ratatosk_tpu.graph.colors import color_graph
    from ratatosk_tpu.ops import cigar as CG
    from ratatosk_tpu import dna
    from ratatosk_tpu.pipeline import _pass_opt, build_pass2_index, correct_file
    tmp = tmp_path_factory.mktemp("scale_jax")
    lr = str(tmp / "long.fq")
    _, sreads, truths = _jax_data(GENOME_BP, N_READS, lr)
    opt = CorrectOpt(small_k=31, k=63, nb_threads=2, read_batch_bp=BATCH_BP,
                     **OPT)
    o1, o2 = _pass_opt(opt, 1), _pass_opt(opt, 2)
    cdbg = B.build_cdbg(sreads, 31, min_count=2)
    p1, p2 = str(tmp / "out.2.fastq"), str(tmp / "out.fastq")
    correct_file(Corrector(cdbg, color_graph(cdbg, sreads), o1), o1, [lr],
                 p1, 1)
    cdbg2, colors2 = build_pass2_index(
        opt, ((r.codes, r.qual) for r in _read(p1)), sreads,
        list(range(len(sreads))))
    correct_file(Corrector(cdbg2, colors2, o2), o2, [p1], p2, 2)

    def err(path):
        d = sum(CG.aln_dist(dna.codes_to_masks(r.codes),
                            dna.codes_to_masks(truths[r.name]), CG.NW)
                for r in _read(path))
        return d / sum(len(t) for t in truths.values())

    return dict(p1=Path(p1).read_bytes(), p2=Path(p2).read_bytes(),
                e1=err(p1), e2=err(p2))


@pytest.fixture(scope="module")
def torch_run(S, tmp_path_factory):
    """The script's run on the CPU with --plan-ab: (result, workdir)."""
    work = tmp_path_factory.mktemp("scale_torch")
    return S.run(GENOME_BP, N_READS, device="cpu", workdir=str(work),
                 plan_ab=True, read_batch_bp=BATCH_BP, **OPT), work


def test_two_passes_match_jax(torch_run, jax_run):
    res, work = torch_run
    assert (work / "out.2.fastq").read_bytes() == jax_run["p1"]
    assert (work / "out.fastq").read_bytes() == jax_run["p2"]
    assert res["residual_err_pass1"] == jax_run["e1"]
    assert res["residual_err_pass2"] == jax_run["e2"]
    for p in ("pass1", "pass2"):
        rec = res["passes"][p]
        assert rec["read_batches"] >= 3, rec
        assert rec["reads"] == N_READS
        assert rec["timers_s"]["plan"] > 0 and rec["timers_s"]["launch"] > 0


def test_plan_ab_gives_the_host_planners_bytes(torch_run):
    res, work = torch_run
    for p, host, dev in (("pass1", "out.2.fastq", "out.2.devplan.fastq"),
                         ("pass2", "out.fastq", "out.devplan.fastq")):
        assert (work / dev).read_bytes() == (work / host).read_bytes()
        ab = res["plan_ab"][p]
        assert ab["devplan_built"] and ab["n_fallback"] == 0, ab
        assert ab["fallback_caps"] == {}, ab
        assert ab["read_batches"] == res["passes"][p]["read_batches"]
    assert res["kernel_check"]["identical"]


def test_result_fields_and_files(torch_run):
    """scale_run.py's fields and the port's, and no file but the passes'
    inside the work directory."""
    res, work = torch_run
    for key in ("pass1_s", "pass2_s", "residual_err_pass1",
                "residual_err_pass2", "raw_err", "peak_rss_gb", "value",
                "card", "kernel_check", "peak_rss_gb_after"):
        assert key in res, key
    assert list(res["phases_s"]) == [
        "simulate_sr", "simulate_lr", "p1_cdbg_build", "p1_coloring",
        "p1_init_warmup", "p1_correct", "p1_plan_ab", "p1_kernel_check",
        "p2_index_build", "p2_init_warmup", "p2_correct", "p2_plan_ab",
        "scoring"]
    for rec in (*res["passes"].values(), *res["plan_ab"].values()):
        assert set(rec) >= {"seconds", "read_batches", "launches",
                            "timers_s", "device_memory_bytes"}
        assert set(rec["timers_s"]) == {"plan", "launch", "finish", "wait"}
    assert res["value"] == res["long_read_bp"] / (res["pass1_s"]
                                                  + res["pass2_s"])
    assert res["residual_err_pass2"] < res["raw_err"] / 5
    assert sorted(p.name for p in work.iterdir()) == sorted([
        "long.fq", "out.2.fastq", "out.fastq", "out.2.devplan.fastq",
        "out.devplan.fastq", "long.head.fq", "head.auto.fastq",
        "head.torch.fastq"])
    json.dumps(res)


def test_main_writes_only_its_output(S, tmp_path, monkeypatch, capsys):
    """main() runs in a temporary directory that it removes, and writes the
    result to the given path only (by default a git-ignored file)."""
    seen = {}

    def fake_run(genome_bp, n_long_reads, *, device, workdir, plan_ab):
        seen.update(args=(genome_bp, n_long_reads, device, plan_ab),
                    workdir=workdir)
        Path(workdir, "long.fq").write_text("@L0\nA\n+\n!\n")
        return {"value": 1.5}

    monkeypatch.setattr(S, "run", fake_run)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    out = tmp_path / "o" / "scale.json"
    assert S.main(["1.2e4", "8", str(out), "--device", "cpu",
                   "--plan-ab"]) == 0
    assert seen["args"] == (12_000, 8, "cpu", True)
    assert not Path(seen["workdir"]).exists()
    assert list((tmp_path / "tmp").iterdir()) == []
    assert sorted(p.name for p in tmp_path.rglob("*")) == [
        "o", "scale.json", "tmp"]
    assert json.loads(out.read_text()) == {"value": 1.5}
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == {
        "value": 1.5}
    assert S.DEFAULT_OUT.relative_to(ROOT).parts[0] == "chiprun_out"
    assert "chiprun_out/" in (ROOT / ".gitignore").read_text().split()
