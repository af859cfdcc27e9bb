"""The JAX package's FASTQ digests (ratatosk_tpu_torch/data/jax_digests.json,
written by scripts/jax_digests.py) and the check that holds the port's runs
to them (ratatosk_tpu_torch/digests.py): the file's schema and entries; the
`cut` entry recomputed by the JAX package and by the port (bench_torch.py
at tests/test_torch_bench.py's cut) in tier-1 time, both equal to the
file; and what the check does with data or FASTQ that differ."""

import importlib.util
import json
from pathlib import Path

import pytest

from ratatosk_tpu_torch import digests
from tests.test_torch_bench import CUT, SIZE
from tests.torch_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
ENTRIES = ("bench_default", "bench_smoke", "cli_default", "cli_small",
           "cli_quarter", "cut")
SHA = set("0123456789abcdef")
# the JAX package's CLI on scripts/dist_scale_torch.py's data, as run on an
# 8-core CPU before the file existed; the port's cards gave the same bytes
CARD_DIGESTS = {
    "cli_default": (
        "88488956aa00ebe26bd58a6467b4ca4e3a8e68013303492fffe676730c7277e0",
        "b3534930511b159aad15869a914d6c6a504ec0831a1e5f22ade24cd37cf4edcd",
        "4cfc575933a4de220e0408e2b9cab2c0d85be11b07b2c5dfd990c2c20d4869e8",
        "f13c293f9eadfe331393672df2f280d518e9556762efb9608c56a0a3ebb4fe65"),
    "cli_small": (
        "6c23a27037fb4246abdd69819d56f1a23f7b0d5423a10d5b09438bdbde863dd2",
        "1fbc0a0ac4ce79b2c9394cab5e988285cd3379b69bd72b465295b1b4da185956",
        "4f4939f522d853b860662e21dc21d3570f165568d00066b092e139d05a69729d",
        "9404acadfbb21a8b59d85fa87a9556f9264358d6c50453462cf3e0460d2b0203"),
}


def _is_sha(x) -> bool:
    return isinstance(x, str) and len(x) == 64 and set(x) <= SHA


@pytest.fixture(scope="module")
def G():
    """scripts/jax_digests.py as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_digests", ROOT / "scripts" / "jax_digests.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def S():
    import bench_torch
    return bench_torch


def test_file_schema():
    doc = json.loads(digests.PATH.read_text())
    assert doc["written_by"] == digests.SCRIPT == "scripts/jax_digests.py"
    assert set(doc["entries"]) == set(ENTRIES)
    for name, e in doc["entries"].items():
        assert e["name"] == name and e["script"] == digests.SCRIPT
        assert e["route"] in ("bench", "cli")
        assert set(e["inputs_sha256"]) == set(digests.INPUTS)
        assert set(e["fastq_sha256"]) == set(digests.OUTPUTS)
        assert all(map(_is_sha, e["inputs_sha256"].values()))
        assert all(map(_is_sha, e["fastq_sha256"].values()))
        assert e["platform"] == "cpu" and e["seconds"] > 0
        assert len(e["commit"].split("+")[0]) == 40
        assert isinstance(e["data"]["seed"], int)
        assert e["data"]["genome_bp"] > 0 and e["data"]["n_long_reads"] > 0
        if e["route"] == "bench":
            assert isinstance(e["options"], dict)
        else:
            assert all(isinstance(f, str) for f in e["options"])


def test_every_entry_is_one_the_script_makes(G, S):
    """Each entry's route, data rule and options are what the script
    derives for its name from the port's own generators and flags."""
    import chip_smoke
    e = digests.load()
    bench = S.bench_options()
    assert e["bench_default"]["data"] == S.data_rule((), S.SEED)
    assert e["bench_smoke"]["data"] == S.data_rule(
        chip_smoke.BENCH_ARGS[:2], S.SEED)
    assert e["cut"]["data"] == S.data_rule(SIZE, S.SEED)
    assert e["bench_default"]["options"] == e["bench_smoke"]["options"] \
        == bench
    assert e["cut"]["options"] == S.bench_options(**G.CUT_OPTIONS)
    assert G.CUT_SIZE == SIZE
    assert G.CUT_OPTIONS == dict(beam_width=CUT["beam_width"],
                                 batch_regions=CUT["batch_regions"],
                                 read_batch_bp=CUT["read_batch_bp"])
    flags = G.dist_scale_torch.flags()
    assert e["cli_default"]["options"] == e["cli_small"]["options"] == flags
    assert e["cli_default"]["data"] == S.data_rule((), S.SEED)
    assert e["cli_small"]["data"] == S.data_rule(("small",), S.SEED)
    assert e["cli_quarter"]["data"] == chip_smoke.quarter_rule(*G.SLICE)
    assert e["cli_quarter"]["options"] == G.QUARTER_FLAGS
    assert "--batch-regions" in flags and "--batch-regions" in G.QUARTER_FLAGS
    for name in ENTRIES:
        hit = digests.find(e[name]["route"], e[name]["data"],
                           e[name]["options"])
        assert hit is not None and hit[0] == name


@pytest.mark.parametrize("name", list(CARD_DIGESTS))
def test_cli_entries_are_the_bytes_the_cards_wrote(name):
    e = digests.load()[name]
    short, long_, p1, final = CARD_DIGESTS[name]
    assert e["inputs_sha256"] == {"short.fa": short, "long.fq": long_}
    assert e["fastq_sha256"] == {"pass1": p1, "final": final}


@pytest.fixture(scope="module")
def jax_cut(G):
    """The `cut` entry recomputed by the JAX package."""
    return G.run_entry("cut")


@pytest.fixture(scope="module")
def port_cut(S, tmp_path_factory):
    """bench_torch.py's run at the cut, on the CPU."""
    work = tmp_path_factory.mktemp("digest_cut")
    return S.run(SIZE, device="cpu", workdir=str(work), repeats=1,
                 plan="host", **CUT)


def test_cut_recomputed_by_the_jax_package_equals_the_file(jax_cut):
    e = digests.load()["cut"]
    for key in ("route", "data", "options", "inputs_sha256", "fastq_sha256"):
        assert jax_cut[key] == e[key], key


def test_cut_run_by_the_port_equals_the_file(port_cut):
    e = digests.load()["cut"]
    assert port_cut["jax_entry"] == "cut" and port_cut["jax_match"] is True
    assert port_cut["fastq_sha256"] == {
        "pass1": e["fastq_sha256"]["pass1"],
        "pass2": e["fastq_sha256"]["final"]}


def test_data_that_differ_are_reported_as_data(S):
    name, e = digests.find("bench", S.data_rule(SIZE, S.SEED),
                           S.bench_options(**{k: CUT[k] for k in (
                               "beam_width", "batch_regions",
                               "read_batch_bp")}))
    fastq = dict(e["fastq_sha256"])
    assert digests.held(name, e, dict(e["inputs_sha256"]), fastq) is True
    assert digests.held(name, e, dict(e["inputs_sha256"]),
                        dict(fastq, final="0" * 64)) is False
    with pytest.raises(digests.DataMismatch, match="long.fq"):
        digests.held(name, e, dict(e["inputs_sha256"], **{
            "long.fq": "0" * 64}), fastq)


def test_check_finds_the_entry_and_holds_the_run_to_it(S):
    rule = S.data_rule(SIZE, S.SEED)
    opts = S.bench_options(**{k: CUT[k] for k in (
        "beam_width", "batch_regions", "read_batch_bp")})
    e = digests.load()["cut"]
    fastq = dict(e["fastq_sha256"])
    inputs = lambda: dict(e["inputs_sha256"])  # noqa: E731
    assert digests.check("bench", rule, opts, inputs, fastq) == "cut"
    with pytest.raises(digests.Mismatch, match="differ from") as err:
        digests.check("bench", rule, opts, inputs, dict(fastq, pass1="0"))
    assert err.value.name == "cut"
    with pytest.raises(digests.DataMismatch, match="short.fa"):
        digests.check("bench", rule, opts, lambda: dict(
            e["inputs_sha256"], **{"short.fa": "0" * 64}), fastq)

    def unused():
        raise AssertionError("inputs read without an entry")
    assert digests.check("bench", rule, S.bench_options(beam_width=4),
                         unused, fastq) is None


def test_no_entry_for_other_options(S):
    assert digests.find("bench", S.data_rule(SIZE, S.SEED),
                        S.bench_options(beam_width=4)) is None
    assert digests.find("cli", S.data_rule(SIZE, S.SEED),
                        S.bench_options()) is None


@pytest.mark.parametrize("match,rc", [(True, 0), (None, 0), (False, 1)],
                         ids=["equal", "no_entry", "different"])
def test_bench_main_exits_non_zero_on_a_mismatch(S, monkeypatch, capsys,
                                                 match, rc):
    monkeypatch.setattr(S, "run", lambda *a, **kw: {"jax_match": match})
    assert S.main(["--device", "cpu"]) == rc
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == {
        "jax_match": match}


def test_short_fasta_digest_is_the_written_files(tmp_path):
    import numpy as np
    import chip_smoke
    reads = [np.array([0, 1, 2, 3, 4], np.uint8), np.array([3, 3], np.uint8)]
    chip_smoke._write_short_fasta(reads, str(tmp_path / "s.fa"))
    assert digests.short_fasta_sha256(reads) == digests.file_sha256(
        tmp_path / "s.fa")
