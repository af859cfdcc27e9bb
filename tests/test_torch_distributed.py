"""The port's multi-host layer (ratatosk_tpu_torch/parallel/distributed.py
and the launcher ratatosk_tpu_torch/distributed_correct.py) on the CPU:
the host helpers against the JAX package's, the gloo collectives in a real
2-process group, and the 2-process correct run against the JAX package's
single-host CLI run on tests/test_distributed_mp.py's data (FASTQ bytes,
tolerance 0). Ports are picked free at run time."""

import gzip
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from ratatosk_tpu import cli as JC
from ratatosk_tpu.parallel import distributed as JD
from ratatosk_tpu_torch.parallel import distributed as TD
from tests.test_distributed_mp import _simulate

ROOT = Path(__file__).resolve().parent.parent
K1, K2 = 17, 31


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_pair(code: str, args, timeout: int):
    """Run `python -c code <pid> <port> *args` as processes 0 and 1; returns
    each one's last stdout line."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(pid), str(port), *map(str, args)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(2)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-3000:]
    return [so.strip().splitlines()[-1] for so, _ in outs]


@pytest.mark.parametrize("n,p", [(100, 4), (7, 3), (3, 8), (50, 1), (0, 2)])
def test_shard_records_match_jax(n, p):
    spans = [TD.shard_records(n, i, p) for i in range(p)]
    assert spans == [JD.shard_records(n, i, p) for i in range(p)]
    assert [r for a, b in spans for r in range(a, b)] == list(range(n))
    assert TD.part_path("x/out", p) == JD.part_path("x/out", p)


@pytest.mark.parametrize("final", ["final.fastq", "final.fastq.gz"])
def test_merge_parts_matches_jax(tmp_path, final):
    parts = [b"@r0\nACGT\n+\nIIII\n", b"", b"@r2\nGGTT\n+\n!!!!\n"]
    got = {}
    for name, D in (("jax", JD), ("torch", TD)):
        prefix = str(tmp_path / name)
        for pid, content in enumerate(parts):
            Path(D.part_path(prefix, pid)).write_bytes(content)
            Path(D.part_path(prefix, pid) + ".done").write_text("ok\n")
        out = str(tmp_path / f"{name}.{final}")
        D.merge_parts(prefix, len(parts), out)
        opener = gzip.open if out.endswith(".gz") else open
        with opener(out, "rb") as f:
            got[name] = f.read()
        assert not any(Path(D.part_path(prefix, pid)).exists()
                       or Path(D.part_path(prefix, pid) + ".done").exists()
                       for pid in range(len(parts)))
    assert got["torch"] == got["jax"] == b"".join(parts)


def test_single_process_collectives():
    assert TD.init_distributed(num_processes=1) == (0, 1)
    assert TD.allgather_bytes(b"abc") == [b"abc"]
    assert TD.allgather_bytes(b"abc", max_total=2) is None
    assert TD.allreduce_stats({"reads": 5}) == {"reads": 5}
    TD.barrier()


_COLLECTIVES = r"""
import json, sys
import torch.distributed as dist
from ratatosk_tpu_torch.parallel import distributed as D
pid, port = int(sys.argv[1]), int(sys.argv[2])
assert D.init_distributed(f"localhost:{port}", 2, pid) == (pid, 2)
assert D.init_distributed(f"localhost:{port}", 2, pid) == (pid, 2)
mine = [bytes(range(256)) * 5 + b"tail", b""][pid]
out = dict(
    uneven=[p.hex() for p in D.allgather_bytes(mine)],
    empty=[p.hex() for p in D.allgather_bytes(b"")],
    over=D.allgather_bytes(mine, max_total=2 * 1284 - 1) is None,
    at=D.allgather_bytes(mine, max_total=2 * 1284) is not None,
    stats=D.allreduce_stats({"reads": pid + 1, "bases": 1000 * (pid + 1),
                             "big": (1 << 40) * (pid + 1)}))
D.barrier()
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_collectives_in_two_processes():
    outs = [json.loads(line) for line in _run_pair(_COLLECTIVES, [], 120)]
    payloads = [bytes(range(256)) * 5 + b"tail", b""]
    for o in outs:
        assert [bytes.fromhex(h) for h in o["uneven"]] == payloads
        assert o["empty"] == ["", ""]
        assert o["over"] and o["at"]
        assert o["stats"] == {"reads": 3, "bases": 3000, "big": 3 << 40}


_RUNNER = r"""
import sys
import torch
torch.set_num_threads(1)
from ratatosk_tpu_torch import distributed_correct
from ratatosk_tpu_torch.ops import sprint
pid, port = sys.argv[1], sys.argv[2]
argv = ["--coordinator", f"localhost:{port}", "--num-processes", "2",
        "--process-id", pid, "--"] + sys.argv[3:]
assert distributed_correct.main(argv, device="cpu") == 0
print("sprint_launches", sprint.sprint_rows.launches)
"""


@pytest.mark.parametrize("pass1_only", [True, False])
def test_two_process_run_matches_jax(tmp_path, pass1_only):
    """The launcher in 2 processes (device="cpu", gloo) writes the FASTQ the
    JAX package's single-host `correct` writes; the full run leaves both
    index artifacts (built once, every host taking part)."""
    sr, lr = _simulate(tmp_path, seed=1500 if pass1_only else 1501)
    argv = ["-s", sr, "-l", lr, "-k", str(K1), "-K", str(K2),
            "--beam-width", "8", "--batch-regions", "16", "--devices", "1"]
    if pass1_only:
        argv.append("-1")
    assert JC.main(["correct", *argv, "-o", str(tmp_path / "single")]) == 0
    out = str(tmp_path / "multi")
    lines = _run_pair(_RUNNER, argv + ["-o", out], 600)
    # CPU tensors take the kernel's plain version: no launch
    assert lines == ["sprint_launches 0"] * 2
    assert Path(out + ".fastq").read_bytes() == \
        (tmp_path / "single.fastq").read_bytes()
    assert not list(tmp_path.glob("multi.part*"))
    if not pass1_only:
        for k in (K1, K2):
            assert (tmp_path / f"multi.index.k{k}.npz").exists()
