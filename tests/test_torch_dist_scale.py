"""scripts/dist_scale_torch.py on the CPU: its data is bench_torch.py's, N = 1
and N = 2 gloo processes of the launcher and a mesh of 1 and 2 CPU slots
write the same final FASTQ, which is the JAX package's single-process
`correct` run's byte for byte (tolerance 0), and the figures it reports
come from the pass_done events as documented. The run is cut (20 kbp, 6
reads, beam 8, 32 regions a launch) so that the plain versions run in
seconds; the card runs bench.py's own options. Whether a card is there is
decided inside the tests."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
SIZE = ("20000", "6")
OPT = dict(beam_width=8, batch_regions=32)


@pytest.fixture(scope="module")
def S():
    spec = importlib.util.spec_from_file_location(
        "dist_scale_torch", ROOT / "scripts" / "dist_scale_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("argv", [("30000", "8"), ("small",)],
                         ids=["custom", "small"])
def test_data_equals_bench_torch(S, argv, tmp_path):
    """The script's reads are bench_torch.py's at the same size arguments:
    the long-read FASTQ byte for byte, the short reads in order."""
    import bench_torch
    from ratatosk_tpu_torch.io import fastx
    data = S.simulate(argv, 1234, str(tmp_path))
    glen, n_reads, frac, rlen = bench_torch.sizes(list(argv))
    rng, genome, sreads = bench_torch.simulate_short(1234, glen, frac, rlen)
    truths, total = bench_torch.write_long_reads(rng, genome, n_reads,
                                                 str(tmp_path / "b.fq"))
    assert Path(data["long_fq"]).read_bytes() == \
        (tmp_path / "b.fq").read_bytes()
    assert data["long_read_bp"] == total
    assert (data["genome_bp"], data["n_long_reads"]) == (glen, n_reads)
    assert list(data["truths"]) == list(truths)
    got = [r.codes for r in fastx.read_fastx(data["short_fa"])]
    assert len(got) == len(sreads) == data["n_short_reads"]
    for a, b in zip(got, sreads):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def scale_run(S, tmp_path_factory):
    """The script's run on the CPU: N = 1 and 2 launcher processes, a mesh
    of 1 and 2 slots. (result, workdir)."""
    work = tmp_path_factory.mktemp("dist_scale")
    return S.run(SIZE, procs=[1, 2], mesh_sizes=[1, 2], device="cpu",
                 workdir=str(work), **OPT), work


@pytest.fixture(scope="module")
def jax_final(scale_run):
    """The JAX package's single-process `correct` on the run's inputs and
    options: its final FASTQ bytes."""
    from ratatosk_tpu import cli as JC
    _, work = scale_run
    out = str(work / "jax")
    assert JC.main(["correct", "-s", str(work / "short.fa"), "-l",
                    str(work / "long.fq"), "-o", out, "-c", "2", "-k", "31",
                    "-K", "63", "--beam-width", "8", "--batch-regions", "32",
                    "--devices", "1"]) == 0
    return Path(out + ".fastq").read_bytes()


def test_every_run_writes_the_jax_packages_fastq(scale_run, jax_final):
    import hashlib
    res, work = scale_run
    want = hashlib.sha256(jax_final).hexdigest()
    assert res["fastq_sha256"]["final"] == want
    for r in res["scatter"] + res["mesh"]:
        assert r["sha256"]["final"] == want, r["n"]
    for n in (1, 2):
        assert (work / f"procs{n}" / "out.fastq").read_bytes() == jax_final
    for m in (1, 2):
        assert (work / "mesh" / f"out.mesh{m}.fastq").read_bytes() == \
            jax_final
    assert not list(work.glob("procs2/out.part*"))


def test_result_holds_the_figures(scale_run):
    res, _ = scale_run
    line = json.loads(json.dumps(res))
    assert line["device"] == "cpu" and line["cards"] == []
    assert line["usable_cores"] == len(os.sched_getaffinity(0))
    assert line["options"] == dict(k1=31, k2=63, beam_width=8,
                                   batch_regions=32, cores=2)
    assert res["error"]["final"] < res["error"]["raw"] / 5
    assert [r["n"] for r in res["scatter"]] == [1, 2]
    assert [r["n"] for r in res["mesh"]] == [1, 2]
    bases = res["long_read_bp"]
    for r in res["scatter"]:
        procs = r["processes"]
        assert len(procs) == r["n"]
        assert r["T_s"] == max(p["pass_s"][1] for p in procs) \
            + max(p["pass_s"][2] for p in procs)
        assert r["bases_per_s"] == bases / r["T_s"]
        for p in procs:
            for key in ("first_batch_s", "timers", "launches",
                        "peak_allocated_gb", "peak_reserved_gb"):
                assert set(p[key]) == {1, 2}, key
            assert set(p["timers"][1]) == {"plan", "launch", "finish",
                                           "wait"}
            # the trace's times are in milliseconds
            assert 0 <= p["first_batch_s"][1] <= p["pass_s"][1] + 2e-3
            # CPU tensors take the plain versions: no kernel launches
            assert not any(p["launches"][1].values())
            assert p["peak_rss_gb"] > 0 and p["setup_s"] > 0
            assert p["handoff"]["seconds"] > 0
        steps = procs[0]["handoff"]["steps_s"]
        # the hand-off: pass 2's index and SNPs, and with two processes the
        # all-gather and the merge of pass 1's shards
        assert "_detect_snps" in steps
        assert ("build_pass2_index" in steps if r["n"] == 1 else
                {"allgather_bytes", "merge_parts", "color_graph_dist"}
                <= set(steps))
    one = res["scatter"][0]["bases_per_s"]
    assert res["scatter"][0]["efficiency"] == 1.0
    two = res["scatter"][1]
    assert two["efficiency"] == two["bases_per_s"] / (2 * one)
    for r in res["mesh"]:
        assert r["T_s"] == r["process"]["pass_s"][1] \
            + r["process"]["pass_s"][2]


def _events(pass1, pass2, first=0.5, t0=1000.0):
    """One process's trace: two batches a pass, then pass_done."""
    evs, t = [], t0
    for p, secs in ((1, pass1), (2, pass2)):
        evs += [{"ts": t + first, "ev": "batch", "pass_no": p},
                {"ts": t + secs - 0.1, "ev": "batch", "pass_no": p},
                {"ts": t + secs, "ev": "pass_done", "pass_no": p,
                 "secs": secs}]
        t += secs + 30.0                       # the hand-off in between
    return evs


def test_window_and_efficiency_from_pass_done_events(S):
    """T(N) is the slowest process's pass 1 plus the slowest's pass 2;
    bases/s = bases / T; E(N) = bases/s(N) / (N x bases/s(1))."""
    one = [S.pass_seconds(_events(40.0, 20.0))]
    assert one[0] == {1: (40.0, 0.5), 2: (20.0, 0.5)}
    four = [S.pass_seconds(_events(a, b, first=f)) for a, b, f in
            ((10.0, 6.0, 1.0), (12.0, 5.0, 2.0), (11.0, 4.0, 0.5),
             (9.0, 7.0, 0.25))]
    assert [p[1][1] for p in four] == [1.0, 2.0, 0.5, 0.25]
    rows = []
    for n, procs in ((1, one), (4, four)):
        w = S.pass_window([{p: s[p][0] for p in (1, 2)} for s in procs])
        rows.append({"n": n, **w})
    assert rows[1]["pass1_max_s"] == 12.0 and rows[1]["pass2_max_s"] == 7.0
    S.scaling(rows, 6_000_000)
    assert rows[0]["T_s"] == 60.0 and rows[1]["T_s"] == 19.0
    assert rows[0]["bases_per_s"] == 100_000.0
    assert rows[1]["bases_per_s"] == 6_000_000 / 19.0
    assert rows[0]["efficiency"] == 1.0
    assert rows[1]["efficiency"] == pytest.approx(60.0 / (4 * 19.0),
                                                  rel=1e-12)
    assert S.scaling([{"n": 2, "T_s": 5.0}], 10)[0]["efficiency"] is None


@pytest.mark.parametrize("n", [1, 2, 4])
def test_each_process_sees_its_own_card(S, n):
    """Process i runs the launcher with --process-id i of n, --devices 1,
    and CUDA_VISIBLE_DEVICES=i: read from the launch arguments."""
    cmds = S.launch_commands(n, 29999, lambda i: S.cli_argv(
        "s.fa", "l.fq", "out", f"t{i}.jsonl"), "cuda", lambda i: f"r{i}")
    assert len(cmds) == n
    for i, (cmd, env) in enumerate(cmds):
        assert env["CUDA_VISIBLE_DEVICES"] == str(i)
        assert "OMP_NUM_THREADS" not in env or \
            env["OMP_NUM_THREADS"] == os.environ.get("OMP_NUM_THREADS")
        rest = cmd[cmd.index("--") + 1:]
        assert cmd[cmd.index("--") - 5:cmd.index("--")] == [
            str(i), str(n), "29999", "cuda", f"r{i}"]
        assert rest[rest.index("--devices") + 1] == "1"
        assert rest[rest.index("--trace-json") + 1] == f"t{i}.jsonl"
        for flag, want in (("-k", "31"), ("-K", "63"), ("--beam-width", "16"),
                           ("--batch-regions", "512"), ("-c", "2")):
            assert rest[rest.index(flag) + 1] == want, flag


@pytest.mark.parametrize("argv,visible,exc", [
    (["--procs", "1"], None, RuntimeError),
    (["--procs", "1,2,4", "--mesh", ""], 2, RuntimeError),
    (["--procs", "", "--mesh", "1,2"], 1, RuntimeError),
    (["--procs", "0", "--device", "cpu"], None, ValueError),
    (["--procs", "", "--mesh", "", "--device", "cpu"], None, ValueError)],
    ids=["cuda_without_card", "procs_above_cards", "mesh_above_cards",
         "procs_0", "nothing"])
def test_refuses_before_any_work(S, tmp_path, monkeypatch, argv, visible,
                                 exc):
    """Without a card `cuda` raises, as does an N or M above the visible
    cards (decided here by patching torch.cuda, not by a card), a count of 0
    or nothing to run; nothing is simulated or written first."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: bool(visible))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible or 0)
    monkeypatch.setattr(S, "simulate", lambda *a: pytest.fail("simulated"))
    out = tmp_path / "out.json"
    with pytest.raises(exc):
        S.main(["small", "--out", str(out), *argv])
    assert not out.exists()


def test_script_imports_no_jax():
    code = ("import sys, runpy\n"
            "runpy.run_path('scripts/dist_scale_torch.py')\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'ratatosk_tpu.')))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
