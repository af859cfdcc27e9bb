"""The port's CLI against the JAX package's CLI, on the CPU: the same argv
through `ratatosk_tpu.cli.main` and `ratatosk_tpu_torch.cli.main(...,
device="cpu")` must write the same FASTQ bytes (tolerance 0), on
tests/test_pipeline.py's dataset. The default two-pass run includes the
pass-1 edge rescue and SNP detection."""

import gzip
import os

import numpy as np
import pytest

from ratatosk_tpu import cli as JC
from ratatosk_tpu.graph import io as JGIO
from ratatosk_tpu_torch import cli as TC, dna
from ratatosk_tpu_torch.graph import interop as TIT
from ratatosk_tpu_torch.graph import io as TGIO
from ratatosk_tpu_torch.io import fastx
from tests import sim
from tests.torch_parity import one_torch_thread  # noqa: F401

K1, K2 = 17, 31
# the JAX run stays on one device (no mesh over the test's virtual CPUs);
# both packages get the same argv
SMALL = ["--beam-width", "8", "--batch-regions", "32", "--devices", "1"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """tests/test_pipeline.py:17-32."""
    tmp = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(200)
    genome = sim.random_genome(rng, 10000)
    sreads = sim.short_reads(rng, genome, coverage=40.0, read_len=100)
    sr_path = str(tmp / "short.fasta.gz")
    with gzip.open(sr_path, "wt") as f:
        for i, r in enumerate(sreads):
            f.write(f">sr{i}\n{dna.decode(r)}\n")
    lreads = sim.long_reads(rng, genome, n=3, min_len=1500, max_len=2500,
                            err=0.09)
    lr_path = str(tmp / "long.fastq")
    with open(lr_path, "w") as f:
        for i, (noisy, _, _) in enumerate(lreads):
            f.write(f"@lr{i}\n{dna.decode(noisy)}\n+\n{'!' * len(noisy)}\n")
    return tmp, lreads, sr_path, lr_path


def _read(path):
    """File bytes; a gzip file's decompressed bytes (its header carries a
    timestamp)."""
    if path.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    with open(path, "rb") as f:
        return f.read()


def _both(argv, out_j, out_t):
    assert JC.main(argv + ["-o", out_j]) == 0
    assert TC.main(argv + ["-o", out_t], device="cpu") == 0


CASES = {
    "default": [],
    "pass1_only": ["-1"],
    "no_snp": ["-F"],
    "fix_snps": ["-f"],
    "rounds2": ["-r", "2"],
    "cores2": ["-c", "2"],
    "trim35": ["-t", "35"],
    "gzip": ["-G"],
    "k21_K63": ["-k", "21", "-K", "63"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_jax(dataset, case):
    tmp, lreads, sr, lr = dataset
    extra = CASES[case]
    ks = [] if "-k" in extra else ["-k", str(K1), "-K", str(K2)]
    argv = ["correct", "-s", sr, "-l", lr, "-C", "500"] + ks + SMALL + extra
    out_j, out_t = str(tmp / f"j_{case}"), str(tmp / f"t_{case}")
    _both(argv, out_j, out_t)
    final = ".fastq.gz" if "-G" in extra else ".fastq"
    outs = [final] if "-1" in extra else [".2.fastq", final]
    for suf in outs:
        got = _read(out_t + suf)
        assert got == _read(out_j + suf), f"{suf} differs"
    recs = list(fastx.read_fastx(out_t + final))
    if "-t" in extra:
        assert recs and all("/" in r.name for r in recs)
    else:
        assert [r.name for r in recs] == [f"lr{i}" for i in range(len(lreads))]
        raw = np.mean([sim.error_rate(n, t) for n, t, _ in lreads])
        cor = np.mean([sim.error_rate(r.codes, t)
                       for r, (_, t, _) in zip(recs, lreads)])
        assert cor < raw / 4, f"{cor:.4f} vs raw {raw:.4f}"


@pytest.fixture(scope="module")
def indexes(dataset):
    """`index -1` through both CLIs."""
    tmp, _, sr, lr = dataset
    pj, pt = str(tmp / "idx_j"), str(tmp / "idx_t")
    argv = ["index", "-s", sr, "-l", lr, "-1", "-k", str(K1), "-K", str(K2),
            "--devices", "1"]
    assert JC.main(argv + ["-o", pj]) == 0
    assert TC.main(argv + ["-o", pt]) == 0
    return pj, pt


def test_index_artifacts_match_jax(indexes):
    pj, pt = indexes
    cj, colj = JGIO.load_index(JGIO.index_path(pj, K1))
    ct, colt = TGIO.load_index(TGIO.index_path(pt, K1))
    for f in ("useq", "uoff", "edges"):
        np.testing.assert_array_equal(getattr(ct, f), getattr(cj, f))
    np.testing.assert_array_equal(ct.index.keys_lo, cj.index.keys_lo)
    for f in ("rows", "card", "coverage", "edge_support", "edge_rescued"):
        np.testing.assert_array_equal(getattr(colt, f), getattr(colj, f))
    assert (_read(TIT.fasta_index_path(pt, K1))
            == _read(TIT.fasta_index_path(pj, K1)))


@pytest.mark.parametrize("graph", ["npz", "fasta"])
def test_correct_from_index_matches_jax(dataset, indexes, graph):
    """`correct -g <prefix>.index.k17.npz -1`, and `correct -g` on the
    exported unitig FASTA (colors rebuilt from -s), as
    tests/test_interop.py:48 runs them."""
    tmp, lreads, sr, lr = dataset
    pj, pt = indexes
    path = {"npz": TGIO.index_path, "fasta": TIT.fasta_index_path}[graph]
    argv = ["correct", "-l", lr, "-1", "-k", str(K1), "-K", str(K2)] + SMALL
    if graph == "fasta":
        argv += ["-s", sr]
    out_j, out_t = str(tmp / f"gj_{graph}"), str(tmp / f"gt_{graph}")
    assert JC.main(argv + ["-g", path(pj, K1), "-o", out_j]) == 0
    assert TC.main(argv + ["-g", path(pt, K1), "-o", out_t],
                   device="cpu") == 0
    assert _read(out_t + ".fastq") == _read(out_j + ".fastq")
    assert len(list(fastx.read_fastx(out_t + ".fastq"))) == len(lreads)


def test_batch_regions_default_keeps_output(dataset):
    """The port's --batch-regions default (512, CorrectOpt's) writes the
    same FASTQ as the JAX CLI's 64: padding rows of a launch are inert."""
    tmp, _, sr, lr = dataset
    argv = ["correct", "-s", sr, "-l", lr, "-1", "-k", str(K1), "-K", str(K2),
            "--beam-width", "8", "--devices", "1"]
    outs = {}
    for name, extra in (("default", []), ("64", ["--batch-regions", "64"])):
        out = str(tmp / f"br_{name}")
        assert TC.main(argv + extra + ["-o", out], device="cpu") == 0
        outs[name] = _read(out + ".fastq")
    assert outs["default"] == outs["64"]


def test_cli_surface():
    """--version/--cite; -d is gone; a run asking for more devices than are
    visible raises before it reads anything."""
    assert TC.main(["--version"]) == 0
    assert TC.main(["--cite"]) == 0
    with pytest.raises(SystemExit):
        TC.main(["correct", "-s", "x.fa", "-l", "y.fq", "-o", "z",
                 "-d", "data"], device="cpu")
    with pytest.raises(RuntimeError, match="--devices 2 requested"):
        TC.main(["correct", "-s", "x.fa", "-l", "y.fq", "-o", "z",
                 "--devices", "2"], device="cpu")
    assert not os.path.exists("z.fastq")
