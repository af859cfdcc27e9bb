"""The port's host modules are the JAX package's, and the port imports no JAX.

(a) Each host module copied into ratatosk_tpu_torch equals its original once
    the package prefix is normalised. Exempt, because the port rewrites them:
    ops/kmer_index.py (host dataclass only) and correct/engine.py (torch
    device parts).
(b) A fresh interpreter imports the port's entry points (the CLI and the
    device planner included) without loading jax.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
COPIED = [
    "config.py", "dna.py", "trace.py",
    "ops/kmers.py", "ops/colorset.py", "ops/cigar.py", "ops/native_kmers.py",
    "ops/native_align.py", "io/native.py", "io/fastx.py",
    "graph/keys.py", "graph/build.py", "graph/colors.py", "graph/cycles.py",
    "correct/seeds.py", "correct/choose.py",
    "graph/rescue_edges.py", "graph/snp.py", "graph/phasing.py",
    "graph/rephase.py", "graph/rescue.py", "graph/io.py", "graph/interop.py",
    "parallel/build_dist.py",
]


@pytest.mark.parametrize("rel", COPIED)
def test_host_module_is_a_copy(rel):
    port = (ROOT / "ratatosk_tpu_torch" / rel).read_text()
    orig = (ROOT / "ratatosk_tpu" / rel).read_text()
    assert port.replace("ratatosk_tpu_torch", "ratatosk_tpu") == orig


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import ratatosk_tpu_torch, ratatosk_tpu_torch.correct.engine\n"
            "import ratatosk_tpu_torch.pipeline, ratatosk_tpu_torch.testing\n"
            "import ratatosk_tpu_torch.ops.sprint, ratatosk_tpu_torch.cli\n"
            "import ratatosk_tpu_torch.ops.plan_device\n"
            "import ratatosk_tpu_torch.ops.hash_index\n"
            "import ratatosk_tpu_torch.parallel.mesh\n"
            "import ratatosk_tpu_torch.parallel.sharded_index\n"
            "import ratatosk_tpu_torch.parallel.distributed\n"
            "import ratatosk_tpu_torch.parallel.build_dist\n"
            "import ratatosk_tpu_torch.distributed_correct\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'ratatosk_tpu.')))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_source_imports_no_jax():
    """Lazy imports inside functions included: no import statement of the
    port names jax or the JAX package."""
    pat = re.compile(r"^\s*(from|import)\s+(jax|ratatosk_tpu)(\.|\s|$)")
    for path in (ROOT / "ratatosk_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            assert not pat.match(line), (path, line)
