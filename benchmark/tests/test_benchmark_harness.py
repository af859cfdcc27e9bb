"""CPU tests of the benchmark's harness: its data, how it finds a cell's
files, its result line, its import check, and the comparison that decides
`correct`, at a tiny size. Run from the repository root:

    python -m pytest benchmark/tests -q

The case marked `cuda` runs a tiny cell on the card and skips without one.
"""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import cells, gen, run as R

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"
# the benchmark's cell, and the pass-2 job whose files wait for a cell
# (PERF.md: its spread is wider than any bound the benchmark may set)
CELLS = ("ecoli4m_p1.ont_r9_4k", "ecoli4m_p2.p1out_4k")


def tiny(name: str, genome_bp: int = 30000) -> cells.Cell:
    """A configuration under a traffic mix (files found by the names in
    `name`) with the first cell's metrics, at a size the CPU runs in
    seconds: a short genome, 2 kbp reads, four-read jobs, beam 8, 32
    regions a launch."""
    cfg, trf = name.split(".")
    cell = cells.load_cell(CELLS[0])
    cell.name = name
    cell.config = cells.load_json(HERE / "configs" / f"{cfg}.json")
    cell.traffic = cells.load_json(HERE / "traffic" / f"{trf}.json")
    cell.config["genome_bp"] = genome_bp
    cell.config["options"].update(beam_width=8, batch_regions=32,
                                  read_batch_bp=8192)
    cell.traffic.update(read_len=2000, pool_reads=12, job_reads=4,
                        warm_reads=2, check_reads=6)
    return cell


def run_tiny(cell, seconds=2.0, seed=5, trace=False, device="cpu"):
    return R.run(cell, seed, seconds, trace, torch.device(device),
                 t_start=time.time())


def test_generator_is_bench_draw():
    """Seed 1234 at bench.py's sizes gives bench.py's short reads and first
    long reads (bench_torch.simulate_short, write_long_reads)."""
    import bench_torch
    from ratatosk_tpu_torch import dna
    cfg = cells.load_cell(CELLS[0]).config
    trf = dict(cells.load_cell(CELLS[0]).traffic, pool_reads=5)
    sreads, lreads = gen.simulate(cfg, trf, 1234)
    rng, genome, want_s = bench_torch.simulate_short(
        1234, cfg["genome_bp"], cfg["repeat_frac"], cfg["repeat_len"])
    assert len(sreads) == len(want_s)
    assert all(np.array_equal(a, b) for a, b in zip(sreads, want_s))
    for r in lreads:
        start = int(rng.integers(0, len(genome) - trf["read_len"]))
        want, _ = bench_torch.testing.noisy_read(
            rng, genome, start, trf["read_len"], err=trf["error"])
        assert dna.decode(r) == dna.decode(want)


def _loops(seed, cfg, trf):
    """The data as bench.py's loops draw it, one number at a time (the
    port's testing.random_genome / short_reads / noisy_read)."""
    from ratatosk_tpu_torch import testing
    rng = np.random.default_rng(seed)
    g = testing.random_genome(rng, cfg["genome_bp"],
                              repeat_frac=cfg["repeat_frac"],
                              repeat_len=cfg["repeat_len"])
    sreads = testing.short_reads(rng, g, coverage=cfg["short_coverage"],
                                 read_len=cfg["short_read_len"])
    lreads = []
    for _ in range(trf["pool_reads"]):
        start = int(rng.integers(0, len(g) - trf["read_len"]))
        lreads.append(testing.noisy_read(rng, g, start, trf["read_len"],
                                         err=trf["error"],
                                         mix=tuple(trf["mix"]))[0])
    return sreads, lreads


@pytest.mark.parametrize("seed", [0, 5, 1234, 2**31 + 7, 2**40 + 3])
@pytest.mark.parametrize("genome_bp,error,mix", [
    (20000, 0.10, (0.5, 0.25, 0.25)), (30011, 0.30, (0.2, 0.6, 0.2)),
    (5000, 0.012, (0.5, 0.25, 0.25))])
def test_generator_equals_the_loops(seed, genome_bp, error, mix):
    """gen.py's words-at-a-time draw gives what the loops draw, at any seed."""
    cfg = dict(genome_bp=genome_bp, repeat_frac=0.15, repeat_len=250,
               short_coverage=5.0, short_read_len=120)
    trf = dict(pool_reads=20, read_len=1000, error=error, mix=list(mix))
    got_s, got_l = gen.simulate(cfg, trf, seed)
    want_s, want_l = _loops(seed, cfg, trf)
    assert len(got_s) == len(want_s)
    assert all(np.array_equal(a, b) for a, b in zip(got_s, want_s))
    assert all(np.array_equal(a, b) for a, b in zip(got_l, want_l))


@pytest.mark.parametrize("seed", range(4))
def test_stream_redraws_as_numpy_does(seed):
    """A range whose draws numpy rejects a quarter of the time: the block
    draw of starts and strands and a scalar draw after it."""
    hi = 3 * 2**30 + 12345
    rng = np.random.default_rng(seed)
    rng.integers(0, 7)                  # leaves half a word in the generator
    want = [(int(rng.integers(0, hi)), bool(rng.random() < 0.5))
            for _ in range(2000)] + [int(rng.integers(0, hi))]
    rng = np.random.default_rng(seed)
    rng.integers(0, 7)
    st = gen.Stream(rng)
    starts, flips = gen._starts_and_flips(st, 2000, hi, block=64)
    got = [(int(a), bool(b)) for a, b in zip(starts, flips)]
    assert got + [st.bounded(hi)] == want


def test_cells_found_by_name():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for entry in spec["workloads"]:
        cell = cells.load_cell(entry["name"])
        assert cell.config["name"] == entry["config"]
        assert cell.traffic["name"] == entry["traffic"]
        assert [m.name for m in cell.end_to_end] == [
            "bases_per_s", "peak_rss_gb", "setup_s"]
        assert len(cell.per_layer) == 8
    for name in CELLS:
        cfg, trf = name.split(".")
        assert (HERE / "configs" / f"{cfg}.json").exists()
        assert (HERE / "traffic" / f"{trf}.json").exists()
    with pytest.raises(KeyError):
        cells.load_cell("no_such.cell")


def test_added_files_picked_up_without_edit(tmp_path):
    """A configuration, a traffic mix, a metric and a cell added as files
    and entries are found with no change to the harness."""
    where = tmp_path / "benchmark"
    shutil.copytree(HERE / "configs", where / "configs")
    shutil.copytree(HERE / "traffic", where / "traffic")
    shutil.copytree(HERE / "metrics", where / "metrics")
    cfg = json.loads((where / "configs" / "ecoli4m_p1.json").read_text())
    cfg["name"] = "dummy_cfg"
    (where / "configs" / "dummy_cfg.json").write_text(json.dumps(cfg))
    (where / "traffic" / "dummy_mix.json").write_text(json.dumps(
        {"name": "dummy_mix", "read_len": 100}))
    (where / "metrics" / "dummy_metric.py").write_text(
        "def read(rec):\n    return rec.get('dummy')\n")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "dummy_cfg.dummy_mix",
                              "config": "dummy_cfg", "traffic": "dummy_mix",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "dummy_metric", "unit": "s",
                              "better": "lower", "source": "host_clock",
                              "layer": "test", "moves": "setup_s",
                              "workloads": ["dummy_cfg.dummy_mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = cells.load_cell("dummy_cfg.dummy_mix", tmp_path / "BENCHMARK.json",
                           where)
    assert cell.config["name"] == "dummy_cfg"
    assert cell.traffic["read_len"] == 100
    assert [m.name for m in cell.per_layer] == ["dummy_metric"]
    assert cells.read_metrics(cell.per_layer, {"dummy": 2.5}) == {
        "dummy_metric": {"value": 2.5, "unit": "s"}}
    assert cells.read_metrics(cell.per_layer, {}) == {}
    other = cells.load_cell(CELLS[0], tmp_path / "BENCHMARK.json", where)
    assert "dummy_metric" not in [m.name for m in other.per_layer]


def test_import_check_by_whole_top_level_name():
    assert R.forbidden_modules(["ratatosk_tpu_torch", "ratatosk_tpu_torch.x",
                                "jaxtyping", "flaxen", "numpy"]) == []
    assert R.forbidden_modules(["ratatosk_tpu.ops", "jax.numpy", "jaxlib",
                                "flax.linen"]) == [
        "flax", "jax", "jaxlib", "ratatosk_tpu"]


def _imported(path: Path) -> set:
    import ast
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax_and_reference_no_program():
    for path in HERE.rglob("*.py"):
        assert not _imported(path) & set(R.FORBIDDEN), path
        if "reference" in path.parts or path.name in ("work.py", "gen.py",
                                                      "check.py"):
            assert "ratatosk_tpu_torch" not in _imported(path), path


@pytest.mark.parametrize("name", CELLS)
def test_result_line_and_reference_agree(name):
    """The result line's keys, `check` last; the program and the reference
    agree on every sampled read, and no read is missing."""
    out = run_tiny(tiny(name))
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "check"
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"bases_per_s", "peak_rss_gb", "setup_s"}
    assert out["check"] == {"reads_missing": {"value": 0, "limit": 0},
                            "reads_differ": {"value": 0, "limit": 0}}
    assert out["record"]["jobs"] >= 1
    assert out["record"]["host"]["cpu_s"] > 0
    assert all(t > 0 for t in out["record"]["host"]["probe_s"])


def test_traced_line():
    cell = tiny(CELLS[0])
    cell.traffic.update(pool_reads=4)
    out = run_tiny(cell, seconds=0.1, trace=True)
    assert out["correct"] is True
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device op on the CPU: the device readers find nothing to read
    assert set(out["metrics"]) == {"wait_share_pct", "plan_s_per_mbp",
                                   "launch_s_per_mbp", "finish_s_per_mbp",
                                   "index_build_s"}


def test_no_card_exits_without_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert R.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"]) == 1
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_tiny_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = run_tiny(tiny(CELLS[0]), device="cuda")
    assert out["correct"] is True
    assert out["device"]["platform"] == "gpu"
