"""bench_torch.py on the CPU against bench.py and the JAX package (tolerance
0): its size rules and simulated data equal bench.py's, and its two passes,
repeated, and with either planner, write the FASTQ bytes that the JAX
package's Corrector and correct_file write at the same options. The beam,
the launches, the data, the read batches and the warm-ups are cut (beam 8,
32 regions a launch, 20 kbp and 6 reads, 8 KiB batches, one warm-up read) so
that the plain versions run in
seconds on the CPU; the card runs bench.py's own options."""

import hashlib
import json
import math
import statistics
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
SIZE, BATCH_BP = ("20000", "6"), 1 << 13        # two read batches a pass
OPT = dict(beam_width=8, batch_regions=32)
CUT = dict(read_batch_bp=BATCH_BP, warm_reads=1, **OPT)
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "phases_s",
              "pass1_s", "pass2_s", "total_wall_s")


@pytest.fixture(scope="module")
def S():
    import bench_torch
    return bench_torch


def _bench_py_sizes(argv):
    """bench.py:69-80's size rules."""
    if argv and argv[0] == "small":
        return 100_000, 64, 0.1, 300
    if argv:
        glen = int(float(argv[0]))
        return (glen, int(argv[1]) if len(argv) > 1 else max(glen // 800, 8),
                0.15, 250)
    return 4_000_000, 5000, 0.15, 250


def _bench_py_data(argv, lr_path):
    """bench.py:83-140's simulation through ratatosk_tpu.testing, step by
    step: genome, short reads, (the pass-1 graph, which draws nothing), long
    reads. Returns (genome, short reads, truths by read name)."""
    from ratatosk_tpu import dna, testing
    glen, n_reads, repeat_frac, repeat_len = _bench_py_sizes(argv)
    rng = np.random.default_rng(1234)
    genome = testing.random_genome(rng, glen, repeat_frac=repeat_frac,
                                   repeat_len=repeat_len)
    sreads = testing.short_reads(rng, genome, coverage=40.0)
    truths = {}
    with open(lr_path, "w") as f:
        for i in range(n_reads):
            start = int(rng.integers(0, glen - 4000))
            noisy, true = testing.noisy_read(rng, genome, start, 4000,
                                             err=0.10)
            truths[f"L{i}"] = true
            f.write(f"@L{i}\n{dna.decode(noisy)}\n+\n{'!' * len(noisy)}\n")
    return genome, sreads, truths


@pytest.mark.parametrize("argv", [(), ("small",), ("2e5",), ("1e6", "64"),
                                  SIZE])
def test_sizes_follow_bench_py(S, argv):
    assert S.sizes(list(argv)) == _bench_py_sizes(list(argv))


@pytest.mark.parametrize("argv", [("30000", "8"), ("small",)],
                         ids=["custom", "small"])
def test_simulated_data_equals_bench_py(S, argv, tmp_path):
    genome, sreads, truths = _bench_py_data(argv, tmp_path / "jax.fq")
    glen, n_reads, repeat_frac, repeat_len = S.sizes(list(argv))
    rng, tgenome, tsreads = S.simulate_short(1234, glen, repeat_frac,
                                             repeat_len)
    ttruths, total = S.write_long_reads(rng, tgenome, n_reads,
                                        tmp_path / "t.fq")
    np.testing.assert_array_equal(tgenome, genome)
    assert len(tsreads) == len(sreads)
    for a, b in zip(tsreads, sreads):
        np.testing.assert_array_equal(a, b)
    assert (tmp_path / "t.fq").read_bytes() == (tmp_path / "jax.fq").read_bytes()
    assert list(ttruths) == list(truths)[:S.N_TRUTH]
    for name, t in ttruths.items():
        np.testing.assert_array_equal(t, truths[name])
    assert total == sum(len(r.codes) for r in _read(tmp_path / "t.fq"))


def _read(path):
    from ratatosk_tpu.io import fastx
    return list(fastx.read_fastx(str(path)))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's two passes on bench.py's data at the cut options:
    the FASTQ bytes of each pass."""
    from ratatosk_tpu.config import CorrectOpt
    from ratatosk_tpu.correct.engine import Corrector
    from ratatosk_tpu.graph import build as B
    from ratatosk_tpu.graph.colors import color_graph
    from ratatosk_tpu.pipeline import _pass_opt, build_pass2_index, correct_file
    tmp = tmp_path_factory.mktemp("bench_jax")
    lr = str(tmp / "long.fq")
    _, sreads, _ = _bench_py_data(SIZE, lr)
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
    return dict(p1=Path(p1).read_bytes(), p2=Path(p2).read_bytes())


@pytest.fixture(scope="module")
def host_run(S, tmp_path_factory):
    """The script's run on the CPU, host planner, two repeats: (result,
    workdir)."""
    work = tmp_path_factory.mktemp("bench_host")
    return S.run(SIZE, device="cpu", workdir=str(work), repeats=2,
                 plan="host", **CUT), work


@pytest.fixture(scope="module")
def device_run(S, tmp_path_factory):
    """The same with --plan device (the planner's plain versions on CPU
    tensors), one run."""
    work = tmp_path_factory.mktemp("bench_device")
    return S.run(SIZE, device="cpu", workdir=str(work), repeats=1,
                 plan="device", **CUT), work


def test_two_passes_match_jax(host_run, jax_run):
    res, work = host_run
    assert (work / "out.2.fastq").read_bytes() == jax_run["p1"]
    assert (work / "out.fastq").read_bytes() == jax_run["p2"]
    assert res["fastq_sha256"] == {
        "pass1": hashlib.sha256(jax_run["p1"]).hexdigest(),
        "pass2": hashlib.sha256(jax_run["p2"]).hexdigest()}


def test_repeats_are_listed_and_equal(host_run):
    res, _ = host_run
    assert res["repeats"] == 2
    assert len(res["runs_bases_per_s"]) == len(res["pass1_runs_s"]) \
        == len(res["pass2_runs_s"]) == 2
    assert res["value"] == statistics.median_low(res["runs_bases_per_s"])
    assert res["value"] == res["long_read_bp"] / (res["pass1_s"]
                                                  + res["pass2_s"])
    assert res["pass1_s"] in res["pass1_runs_s"]
    for p in ("pass1", "pass2"):
        rec = res["passes"][p]
        assert rec["runs_s"] == res[f"{p}_runs_s"]
        assert rec["read_batches"] == 2, rec
        assert rec["n_fallback"] == [None, None]
        assert rec["timers"]["plan"] > 0 and rec["timers"]["launch"] > 0
        # the plain versions launch no kernel
        assert not any(rec["launches"].values())


def test_device_planner_gives_the_host_planners_bytes(host_run, device_run):
    hres, hwork = host_run
    dres, dwork = device_run
    assert dres["plan"] == "device" and dres["repeats"] == 1
    assert dres["fastq_sha256"] == hres["fastq_sha256"]
    for name in ("out.2.fastq", "out.fastq"):
        assert (dwork / name).read_bytes() == (hwork / name).read_bytes()
    for p in ("pass1", "pass2"):
        assert dres["passes"][p]["n_fallback"] == [0]


def test_json_line_has_bench_py_keys_and_the_ports(host_run):
    res, work = host_run
    line = json.loads(json.dumps(res))
    for key in BENCH_KEYS + (
            "device", "plan", "seed", "repeats", "runs_bases_per_s",
            "pass1_runs_s", "pass2_runs_s", "warmup_s", "passes",
            "peak_rss_gb", "fastq_sha256", "error", "trace"):
        assert key in line, key
    assert res["metric"] in (ROOT / "bench.py").read_text()
    assert res["unit"] == "bases/s"
    assert res["vs_baseline"] == res["value"] / 100_000.0
    assert res["device"] == "cpu" and res["seed"] == 1234
    assert res["trace"] is None
    assert list(res["phases_s"]) == [
        "imports", "simulate", "p1_graph_build", "p1_corrector_init",
        "simulate_long_reads", "p1_warmup", "p1_timed", "p2_graph_build",
        "p2_corrector_init", "p2_warmup", "p2_timed", "score"]
    assert math.isclose(sum(res["phases_s"].values()), res["total_wall_s"],
                        rel_tol=1e-9)
    assert set(res["warmup_s"]) == {"pass1", "pass2"}
    for rec in res["passes"].values():
        assert set(rec["timers"]) == {"plan", "launch", "finish", "wait"}
        assert set(rec["launches"]) == {"fused_beam_search",
                                        "finish_bundle_kernel",
                                        "runs_kernel", "probe_kernel"}
    err = res["error"]
    assert err["pass2"] < err["raw"] / 5 and err["raw"] > 0.07
    assert sorted(p.name for p in work.iterdir()) == [
        "long.fq", "out.2.fastq", "out.fastq", "warm.fq", "warm2.fq"]


def test_main_prints_the_result_last(S, tmp_path, monkeypatch, capsys):
    """main() passes bench.py's arguments and the flags on, runs in a
    temporary directory that it removes, and prints the result last."""
    seen = {}

    def fake_run(size_args, *, device, workdir, repeats, plan, seed, trace,
                 t_start):
        seen.update(args=(list(size_args), device, repeats, plan, seed,
                          trace), workdir=workdir)
        Path(workdir, "long.fq").write_text("@L0\nA\n+\n!\n")
        return {"value": 1.5}

    monkeypatch.setattr(S, "run", fake_run)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    assert S.main(["small", "--repeats", "3", "--plan", "device",
                   "--seed", "7", "--device", "cpu"]) == 0
    assert seen["args"] == (["small"], "cpu", 3, "device", 7, False)
    assert not Path(seen["workdir"]).exists()
    assert list(tmp_path.iterdir()) == []
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == {
        "value": 1.5}
    assert S.main([]) == 0 and seen["args"] == ([], "cuda", 1, "host", 1234,
                                                False)


@pytest.mark.parametrize("kw,exc", [
    (dict(device="cuda"), RuntimeError),
    (dict(device="cpu", trace=True), ValueError),
    (dict(device="cpu", repeats=0), ValueError),
    (dict(device="cpu", plan="gpu"), ValueError)],
    ids=["cuda_without_card", "trace_on_cpu", "no_repeats", "bad_plan"])
def test_refuses_before_any_work(S, tmp_path, monkeypatch, kw, exc):
    """Without a card --device cuda raises (decided here, not at import),
    and nothing is simulated or written first."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(exc):
        S.run(SIZE, workdir=str(tmp_path), **kw)
    assert list(tmp_path.iterdir()) == []


def _event(kind, start, end, name):
    from torch.autograd import DeviceType
    return SimpleNamespace(
        device_type=getattr(DeviceType, kind), name=name,
        time_range=SimpleNamespace(start=start, end=end,
                                   elapsed_us=lambda: end - start))


def test_device_busy_is_the_union_of_the_device_ops(S):
    prof = SimpleNamespace(events=lambda: [
        _event("CUDA", 100, 200, "beam"), _event("CPU", 0, 1000, "host"),
        _event("CUDA", 150, 250, "finish"), _event("CUDA", 400, 500, "beam"),
        _event("CUDA", 420, 440, "copy")])
    got = S.device_busy(prof, wall=0.001)
    assert got["device_ops"] == 4
    assert got["busy_s"] == pytest.approx(250e-6, abs=0)
    assert got["busy_share"] == pytest.approx(0.25, abs=0)
    assert got["top_kernels_ms"] == [["beam", 0.2], ["finish", 0.1],
                                     ["copy", 0.02]]
    with pytest.raises(AssertionError, match="no device op"):
        S.device_busy(SimpleNamespace(events=lambda: [
            _event("CPU", 0, 10, "host")]), wall=1.0)


def _rec(beam=2, finish=1, runs=1, probe=1, fallback=0, batches=3):
    return {"launches": {"fused_beam_search": beam,
                         "finish_bundle_kernel": finish,
                         "runs_kernel": runs, "probe_kernel": probe},
            "n_fallback": fallback, "read_batches": batches}


@pytest.mark.parametrize("rec,on_card,devplan,plan_on_device,ok", [
    (_rec(runs=0, probe=0), True, False, False, True),
    (_rec(), True, True, True, True),
    (_rec(beam=0), True, False, False, False),
    (_rec(finish=0), True, False, False, False),
    (_rec(probe=0), True, True, True, False),
    (_rec(fallback=3), True, True, True, False),
    (_rec(fallback=3), False, True, True, False),
    (_rec(), True, False, True, False),
    (_rec(0, 0, 0, 0), False, False, False, True)],
    ids=["host_plan", "device_plan", "no_beam", "no_finish", "no_probe",
         "all_fell_back", "all_fell_back_cpu", "devplan_missing",
         "cpu_plain"])
def test_check_launches(S, rec, on_card, devplan, plan_on_device, ok):
    if ok:
        S.check_launches(rec, 1, on_card, devplan, plan_on_device)
    else:
        with pytest.raises(AssertionError):
            S.check_launches(rec, 1, on_card, devplan, plan_on_device)
