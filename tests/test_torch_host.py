"""The port's host modules are the JAX package's, and the port imports no JAX.

(a) Each host module copied into ratatosk_tpu_torch equals its original once
    the package prefix is normalised. Exempt, because the port rewrites them:
    ops/kmer_index.py (host dataclass only) and correct/engine.py (torch
    device parts). The three native loaders equal theirs once the build is
    also left out: the port builds each library alone into its own build
    directory (native_build.py), and four processes doing so at once all
    load the same results.
(b) A fresh interpreter imports the port's entry points (the CLI and the
    device planner included) and scripts/scale_run_torch.py without loading
    jax.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
COPIED = [
    "config.py", "dna.py",
    "ops/kmers.py", "ops/colorset.py", "ops/cigar.py", "io/fastx.py",
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


# the native loaders: module -> the library it builds
NATIVE_LOADERS = {"io/native.py": "fastx", "ops/native_kmers.py": "kmers",
                  "ops/native_align.py": "align"}


def _without_build(text: str, port: bool) -> str:
    """A native loader with its build left out: the module docstring, the
    imports of os and subprocess, the original's library-path constants and
    build statements (native/build.sh when the library is missing or
    stale), and the port's build_native import and call. Each of the last
    must be found exactly once."""
    text = re.sub(r'\A""".*?"""\n', "", text, flags=re.S)
    text = re.sub(r"^import (os|subprocess)\n", "", text, flags=re.M)
    if port:
        text, n1 = re.subn(r"^from ratatosk_tpu\.native_build import "
                           r"build_native\n", "", text, flags=re.M)
        text, n2 = re.subn(r'ctypes\.CDLL\(build_native\("\w+"\)\)',
                           "ctypes.CDLL(LIB)", text)
    else:
        text, n1 = re.subn(r"^_NATIVE_DIR = .*?\n_LIB_PATH = .*?\n", "",
                           text, flags=re.M | re.S)
        text, n2 = re.subn(r"    src = os\.path\.join\(_NATIVE_DIR, .*?"
                           r"lib = ctypes\.CDLL\(_LIB_PATH\)",
                           "    try:\n        lib = ctypes.CDLL(LIB)", text,
                           flags=re.S)
    assert (n1, n2) == (1, 1), (port, n1, n2)
    return re.sub(r"\n{3,}", "\n\n", text)


@pytest.mark.parametrize("rel", sorted(NATIVE_LOADERS))
def test_native_loader_is_a_copy_but_its_build(rel):
    port = (ROOT / "ratatosk_tpu_torch" / rel).read_text()
    orig = (ROOT / "ratatosk_tpu" / rel).read_text()
    assert f'build_native("{NATIVE_LOADERS[rel]}")' in port
    assert "native/build.sh" not in port and "_NATIVE_DIR" not in port
    assert (_without_build(port.replace("ratatosk_tpu_torch", "ratatosk_tpu"),
                           True) == _without_build(orig, False))


_LOAD_ALL = """
import sys
import numpy as np
from ratatosk_tpu_torch.io import native as FX
from ratatosk_tpu_torch.ops import cigar, native_align as NA, native_kmers as NK
assert FX.available() and NA.available() and NK.available()
inp = np.load("inputs.npz")
out = {}
for k in (21, 41):
    hi, lo, valid, is_fw = NK.canonical(inp["codes"], k)
    out[f"lo{k}"], out[f"valid{k}"], out[f"fw{k}"] = lo, valid, is_fw
    if hi is not None:
        out[f"hi{k}"] = hi
pairs = [(inp[f"a{i}"], inp[f"b{i}"]) for i in range(4)]
out["dist"] = np.asarray(NA.align_dist_batch(pairs, cigar.NW))
recs = list(FX.read_records("reads.fq"))
out["codes"] = np.concatenate([r.codes for r in recs])
out["quals"] = np.concatenate([r.qual for r in recs])
np.savez(f"out{sys.argv[1]}.npz", **out)
"""

# the compiler for the build race: g++, but each library is written in two
# halves 3 s apart, so a process that loads the output file in between
# finds a truncated library
_SLOW_CXX = """#!{python}
import os, subprocess, sys, time
args = sys.argv[1:]
i = args.index("-o")
out = args[i + 1]
subprocess.run(["g++", *args[:i + 1], out + ".whole", *args[i + 2:]],
               check=True)
with open(out + ".whole", "rb") as f:
    data = f.read()
os.remove(out + ".whole")
with open(out, "wb") as f:
    f.write(data[:len(data) // 2])
    f.flush()
    time.sleep(3)
    f.write(data[len(data) // 2:])
"""


def test_native_loaders_build_at_once(tmp_path):
    """Four processes, started 1 s apart, load the port's three native
    libraries from a copy of the port with no build directory, through a
    compiler that writes each library in two halves 3 s apart: all four
    load every library (none meets a half-written file) and get the JAX
    package's NumPy and Python results (canonical k-mers at one and two
    words, NW distances, FASTQ records)."""
    from ratatosk_tpu import dna
    from ratatosk_tpu.graph.keys import KeyArray
    from ratatosk_tpu.io.fastx import read_fastx
    from ratatosk_tpu.ops import cigar

    shutil.copytree(ROOT / "ratatosk_tpu_torch", tmp_path / "ratatosk_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copytree(ROOT / "native", tmp_path / "native",
                    ignore=shutil.ignore_patterns("*.so"))
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, 400).astype(np.uint8)
    codes[[50, 51, 300]] = 4                  # N breaks the windows
    inp = {"codes": codes}
    for i in range(4):
        a = rng.integers(0, 4, 60 + 7 * i).astype(np.uint8)
        b = a.copy()
        b[rng.integers(0, len(b), 6)] = rng.integers(0, 4, 6)
        inp[f"a{i}"] = dna.codes_to_masks(a)
        inp[f"b{i}"] = dna.codes_to_masks(np.delete(b, [3, 20]))
    np.savez(tmp_path / "inputs.npz", **inp)
    with open(tmp_path / "reads.fq", "w") as f:
        for i in range(5):
            s = rng.integers(0, 4, 90 + i).astype(np.uint8)
            q = (rng.integers(0, 41, len(s)) + 33).astype(np.uint8)
            f.write(f"@r{i}\n{dna.decode(s)}\n+\n{q.tobytes().decode()}\n")
    cxx = tmp_path / "slow_cxx"
    cxx.write_text(_SLOW_CXX.format(python=sys.executable))
    cxx.chmod(0o755)
    env = dict(os.environ, PYTHONPATH=str(tmp_path), CXX=str(cxx))
    procs = []
    for i in range(4):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _LOAD_ALL, str(i)], cwd=tmp_path, env=env,
            stderr=subprocess.PIPE, text=True))
        time.sleep(1)
    errs = [p.communicate(timeout=240)[1] for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, errs
    assert sorted(x.name for x in (tmp_path / "ratatosk_tpu_torch" / "build"
                                   / "native").glob("*.so")) == [
        "libfastx.so", "libkmers.so", "libralign.so"]
    assert not list((tmp_path / "native").glob("*.so"))

    recs = list(read_fastx(str(tmp_path / "reads.fq"), prefer_native=False))
    dist = [cigar.aln_dist(inp[f"a{i}"], inp[f"b{i}"], cigar.NW)
            for i in range(4)]
    for i in range(4):
        out = np.load(tmp_path / f"out{i}.npz")
        for k in (21, 41):
            keys, valid = KeyArray.from_codes(codes, k)
            can, is_fw = keys.canonical()
            v = out[f"valid{k}"]
            np.testing.assert_array_equal(v, valid)
            np.testing.assert_array_equal(out[f"lo{k}"][v], can.lo[v])
            np.testing.assert_array_equal(out[f"fw{k}"][v], is_fw[v])
            if k > 32:
                np.testing.assert_array_equal(out[f"hi{k}"][v], can.hi[v])
        assert out["dist"].tolist() == dist
        np.testing.assert_array_equal(
            out["codes"], np.concatenate([r.codes for r in recs]))
        np.testing.assert_array_equal(
            out["quals"], np.concatenate([r.qual for r in recs]))


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
            "import runpy\n"
            "runpy.run_path('scripts/scale_run_torch.py')\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m == 'jax' or m.startswith(('jax.', 'ratatosk_tpu.')))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_source_imports_no_jax():
    """Lazy imports inside functions included: no import statement of the
    port or of scripts/scale_run_torch.py names jax or the JAX package."""
    pat = re.compile(r"^\s*(from|import)\s+(jax|ratatosk_tpu)(\.|\s|$)")
    for path in [*(ROOT / "ratatosk_tpu_torch").rglob("*.py"),
                 ROOT / "scripts" / "scale_run_torch.py"]:
        for line in path.read_text().splitlines():
            assert not pat.match(line), (path, line)
