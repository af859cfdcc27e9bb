"""The port's graph annotations and their users against the JAX package, on
the CPU, at tolerance 0: SNP detection and the Corrector that emits IUPAC
codes from it, pass-1 edge rescue and a correction over the rescued graph
(the successor table's `edge_rescued` masking), phasing (-p/-P), -L
rephasing, -u unmapped-read rescue, and the index files. Fixtures are the
matching JAX tests'."""

import gzip

import numpy as np
import pytest

from ratatosk_tpu import cli as JC
from ratatosk_tpu import pipeline as JP
from ratatosk_tpu.config import CorrectOpt as JOpt
from ratatosk_tpu.correct.engine import Corrector as JCorrector
from ratatosk_tpu.graph import build as JB
from ratatosk_tpu.graph import io as JGIO
from ratatosk_tpu.graph import phasing as JPH
from ratatosk_tpu.graph import rephase as JRP
from ratatosk_tpu.graph import rescue as JRS
from ratatosk_tpu.graph import snp as JSNP
from ratatosk_tpu.graph.colors import color_graph as j_color_graph
from ratatosk_tpu.graph.rescue_edges import rescue_pass1_edges as j_rescue
from ratatosk_tpu_torch import cli as TC, dna, testing
from ratatosk_tpu_torch import pipeline as TP
from ratatosk_tpu_torch.config import CorrectOpt as TOpt
from ratatosk_tpu_torch.correct.engine import Corrector as TCorrector
from ratatosk_tpu_torch.graph import build as TB
from ratatosk_tpu_torch.graph import io as TGIO
from ratatosk_tpu_torch.graph import phasing as TPH
from ratatosk_tpu_torch.graph import rephase as TRP
from ratatosk_tpu_torch.graph import rescue as TRS
from ratatosk_tpu_torch.graph import snp as TSNP
from ratatosk_tpu_torch.graph.colors import color_graph as t_color_graph
from ratatosk_tpu_torch.graph.rescue_edges import rescue_pass1_edges as t_rescue
from ratatosk_tpu_torch.io import fastx
from tests import sim
from tests.torch_parity import one_torch_thread  # noqa: F401

SMALL = ["--beam-width", "8", "--batch-regions", "32", "--devices", "1"]
COLOR_FIELDS = ("rows", "card", "coverage", "edge_support", "n_colors",
                "edge_rescued")


def _graphs(reads, k, read_ids=None):
    """The same colored graph built by both packages."""
    jc = JB.build_cdbg(reads, k, min_count=2)
    tc = TB.build_cdbg(reads, k, min_count=2)
    return ((jc, j_color_graph(jc, reads, read_ids=read_ids)),
            (tc, t_color_graph(tc, reads, read_ids=read_ids)))


def _same_reads(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.codes, w.codes)
        np.testing.assert_array_equal(g.qual, w.qual)
        if w.iupac is None:
            assert g.iupac is None or not g.iupac.any()
        else:
            np.testing.assert_array_equal(g.iupac, w.iupac)
        assert (g.n_solid, g.n_regions, g.n_corrected) == (
            w.n_solid, w.n_regions, w.n_corrected)


# ---- SNP detection (tests/test_snp_correction.py) ----

def _diploid_sites(seed, sites):
    rng = np.random.default_rng(seed)
    hapA = sim.random_genome(rng, 6000)
    hapB = hapA.copy()
    for s in sites:
        hapB[s] = (hapB[s] + 1) % 4
    reads = (sim.short_reads(rng, hapA, coverage=25.0, read_len=100)
             + sim.short_reads(rng, hapB, coverage=25.0, read_len=100))
    return hapB, reads


@pytest.mark.parametrize("seed,sites", [(600, [3000]),
                                        (610, [2600, 3000, 3400])])
def test_detect_snps_matches_jax(seed, sites):
    _, reads = _diploid_sites(seed, sites)
    (jc, jcol), (tc, tcol) = _graphs(reads, 17)
    want = JSNP.detect_snps(jc, jcol)
    got = TSNP.detect_snps(tc, tcol)
    assert got.n_sites == want.n_sites >= 2
    for f in ("offsets", "pos", "mask"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_snp_corrector_matches_jax():
    """tests/test_snp_correction.py:49: het sites inside beam-corrected
    regions surface as IUPAC codes, and resolve_iupac (-f) settles them."""
    hapB, reads = _diploid_sites(610, [2600, 3000, 3400])
    (jc, jcol), (tc, tcol) = _graphs(reads, 17)
    kw = dict(small_k=17, k=63, beam_width=8, batch_regions=32,
              min_confidence_snp_corr=2.0)
    jcorr = JCorrector(jc, jcol, JOpt(**kw), snps=JSNP.detect_snps(jc, jcol))
    tcorr = TCorrector(tc, tcol, TOpt(**kw), snps=TSNP.detect_snps(tc, tcol),
                       device="cpu")
    noisy = [testing.noisy_read(np.random.default_rng(800 + t), hapB, 2000,
                                2200, 0.10)[0] for t in range(6)]
    want = jcorr.correct_batch(noisy)
    got = tcorr.correct_batch(noisy)
    _same_reads(got, want)
    assert any(g.iupac is not None and g.iupac.any() for g in got)
    assert ([tcorr.resolve_iupac(g) for g in got]
            == [jcorr.resolve_iupac(w) for w in want])
    _same_reads(got, want)


# ---- pass-1 edge rescue (tests/test_edge_rescue.py) ----

def _junction_reads(rng):
    """tests/test_edge_rescue.py:_setup: a 45 bp repeat whose first junction
    is covered by reads sharing one color id."""
    A = sim.random_genome(rng, 1200)
    X = sim.random_genome(rng, 45)
    Bseg = sim.random_genome(rng, 1200)
    C = sim.random_genome(rng, 900)
    D = sim.random_genome(rng, 900)
    genome = np.concatenate([A, X, Bseg, C, X, D])
    j1 = len(A)
    reads, ids = [], []
    next_id, dup_id = 0, None
    for start in range(0, len(genome) - 100 + 1, 9):
        reads.append(genome[start:start + 100].copy())
        if start + 100 > j1 - 2 and start < j1 + 45 + 2:
            if dup_id is None:
                dup_id = next_id
                next_id += 1
            ids.append(dup_id)
        else:
            ids.append(next_id)
            next_id += 1
    return genome, reads, ids, j1


@pytest.mark.parametrize("seed", [820, 821])
def test_rescue_edges_and_correction_match_jax(seed):
    genome, reads, ids, j1 = _junction_reads(np.random.default_rng(seed))
    (jc, jcol), (tc, tcol) = _graphs(reads, 31, read_ids=ids)
    n_j = j_rescue(jc, jcol, JB.build_cdbg(reads, 63, min_count=2), min_cov=2)
    n_t = t_rescue(tc, tcol, TB.build_cdbg(reads, 63, min_count=2), min_cov=2)
    assert n_t == n_j >= 1
    for f in COLOR_FIELDS:
        np.testing.assert_array_equal(getattr(tcol, f), getattr(jcol, f))
    assert tcol.edge_rescued.any()
    # correction across the rescued junction: the device graph's successor
    # table carries the rescued-edge flag
    noisy, true = sim.noisy_long_read(np.random.default_rng(77), genome,
                                      j1 - 600, 1300, err=0.10)
    kw = dict(small_k=31, k=63, beam_width=8, batch_regions=32)
    tcorr = TCorrector(tc, tcol, TOpt(**kw), device="cpu")
    assert bool((tcorr.g.utbl[..., :4] >= (1 << 30)).any())
    got = tcorr.correct_batch([noisy])
    _same_reads(got, JCorrector(jc, jcol, JOpt(**kw)).correct_batch([noisy]))
    if seed == 821:
        assert sim.error_rate(got[0].codes, true) < \
            sim.error_rate(noisy, true) / 5


# ---- phasing (tests/test_phasing.py) ----

def test_phasing_filter_matches_jax(tmp_path):
    """tests/test_phasing.py:27."""
    p = tmp_path / "phase.tsv"
    p.write_text("s0\t0\tb\ns1\t0\tb\ns2\t1\tb\n")
    names, ids = ["s0", "s1", "s2", "s3"], [10, 11, 12, 13]
    row = np.array([10, 11, 12, 13] + [-1] * 4, np.int32)
    outs = []
    for PH in (JPH, TPH):
        hap = PH.load_phasing([str(p)])
        PH.bind_colors(hap, names, ids)
        outs.append([PH.filter_colors_by_hap(row, hap, h) for h in (-1, 0, 1)])
    for g, w in zip(*outs):
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def phased_data(tmp_path_factory):
    """A diploid genome: short and long reads of both haplotypes, and
    phasing TSVs for both (-p short reads, -P long reads)."""
    tmp = tmp_path_factory.mktemp("phased")
    rng = np.random.default_rng(900)
    hapA = sim.random_genome(rng, 8000)
    hapB = hapA.copy()
    for s in range(2000, 6000, 150):
        hapB[s] = (hapB[s] + 1) % 4
    sr, sp = tmp / "short.fa", tmp / "short_phase.tsv.gz"
    lr, lp = tmp / "long.fq", tmp / "long_phase.tsv"
    with open(sr, "w") as f, gzip.open(sp, "wt") as g:
        for h, hap in enumerate((hapA, hapB)):
            for i, r in enumerate(sim.short_reads(rng, hap, coverage=25.0,
                                                  read_len=100)):
                f.write(f">h{h}s{i}\n{dna.decode(r)}\n")
                g.write(f"h{h}s{i}\t{h}\tblock0\n")
    with open(lr, "w") as f, open(lp, "w") as g:
        for i in range(4):
            h = i % 2
            noisy, _ = testing.noisy_read(rng, (hapA, hapB)[h],
                                          500 + 1200 * i, 2500, 0.10)
            f.write(f"@L{i}\n{dna.decode(noisy)}\n+\n{'!' * len(noisy)}\n")
            g.write(f"L{i}\t{h}\tblock0\n")
    # both packages read a -p/-P argument that is not FASTA/FASTQ as a list
    # file of paths (pipeline._expand_file_lists), so the TSVs go in lists
    lists = []
    for tsv in (sp, lp):
        lst = tmp / f"{tsv.name}.list"
        lst.write_text(f"{tsv}\n")
        lists.append(str(lst))
    return tmp, str(sr), lists[0], str(lr), lists[1]


def test_phased_cli_matches_jax(phased_data):
    """-p/-P: each long read is corrected with its haplotype's short-read
    colors plus the unphased ones (Corrector(hap=...))."""
    tmp, sr, sp, lr, lp = phased_data
    argv = ["correct", "-s", sr, "-l", lr, "-1", "-k", "21", "-K", "31",
            "-p", sp, "-P", lp] + SMALL
    assert JC.main(argv + ["-o", str(tmp / "j")]) == 0
    assert TC.main(argv + ["-o", str(tmp / "t")], device="cpu") == 0
    got = (tmp / "t.fastq").read_bytes()
    assert got == (tmp / "j.fastq").read_bytes()
    opt = TOpt(filename_seq_in=[sr], filename_phase_short=[sp],
               filename_phase_long=[lp])
    _, ids, names = TP.load_short_reads(opt)
    hap = TP.load_hap(opt, ids, names)
    assert hap.hap_of("L1") == 1 and len(hap.hap_colors[1]) > 0


# ---- -L rephasing (tests/test_rephase.py) ----

def _two_haps(rng, glen=9000, n_snps=40):
    hapA = sim.random_genome(rng, glen)
    hapB = hapA.copy()
    lo, hi = glen // 2 - 1000, glen // 2 + 1000
    for p in np.linspace(lo, hi, n_snps, dtype=int):
        hapB[p] = (hapB[p] + 1) % 4
    return hapA, hapB, lo, hi


def test_rephase_read_matches_jax():
    """tests/test_rephase.py:48: a hapB read with a hapA block spliced in
    is detected and spliced back to its raw mate."""
    rng = np.random.default_rng(1200)
    hapA, hapB, lo, hi = _two_haps(rng)
    frags, ids = [], []
    for hap in (hapA, hapB):
        for s in range(0, len(hap) - 3000, 500):
            frags.append(hap[s:s + 3000])
            ids.append(len(ids))
    sreads = (sim.short_reads(rng, hapA, coverage=30.0, read_len=100)
              + sim.short_reads(rng, hapB, coverage=30.0, read_len=100))
    jc, tc = (JB.build_cdbg(sreads, 21, min_count=2),
              TB.build_cdbg(sreads, 21, min_count=2))
    jcol = j_color_graph(jc, frags, read_ids=ids)
    tcol = t_color_graph(tc, frags, read_ids=ids)
    a, b = lo - 1500, hi + 1500
    corrected = np.concatenate([hapB[a:lo], hapA[lo:hi], hapB[hi:b]])
    raw = hapB[a:b].copy()
    segs = TRP.phase_inconsistent_segments(tc, tcol, corrected, insert_sz=500)
    assert segs and segs == JRP.phase_inconsistent_segments(
        jc, jcol, corrected, insert_sz=500)
    qual = np.full(len(corrected), 60, np.uint8)
    codes, q, n = TRP.rephase_read(tc, tcol, raw, corrected, qual)
    wc, wq, wn = JRP.rephase_read(jc, jcol, raw, corrected, qual)
    assert n == wn >= 1
    np.testing.assert_array_equal(codes, wc)
    np.testing.assert_array_equal(q, wq)


def test_rephase_cli_matches_jax(tmp_path):
    """tests/test_rephase.py:89: `correct -2 -L` pairs raw mates by name
    and rephases before correction; a mismatched name aborts."""
    rng = np.random.default_rng(1202)
    hapA, hapB, lo, hi = _two_haps(rng)
    a, b = lo - 1500, hi + 1500
    corrected = np.concatenate([hapB[a:lo], hapA[lo:hi], hapB[hi:b]])
    raw = hapB[a:b]
    sr = tmp_path / "short.fa"
    with open(sr, "w") as f:
        n = 0
        for hap in (hapA, hapB):
            for i in range(0, len(hap) - 100, 3):
                f.write(f">s{n}\n{dna.decode(hap[i:i + 100])}\n")
                n += 1
    lr = tmp_path / "p1out.fq"
    lr.write_text(f"@r0\n{dna.decode(corrected)}\n+\n{'I' * len(corrected)}\n")
    rawp = tmp_path / "raw.fq"
    rawp.write_text(f"@r0\n{dna.decode(raw)}\n+\n{'!' * len(raw)}\n")
    helper = tmp_path / "helper.fa"
    with open(helper, "w") as f:
        n = 0
        for hap in (hapA, hapB):
            for s in range(0, len(hap) - 3000, 500):
                f.write(f">h{n}\n{dna.decode(hap[s:s + 3000])}\n")
                n += 1
    argv = ["correct", "-s", str(sr), "-l", str(lr), "-2", "-k", "21",
            "-K", "31", "-L", str(rawp), "-C", "100", "-a", str(helper)] + SMALL
    assert JC.main(argv + ["-o", str(tmp_path / "j")]) == 0
    assert TC.main(argv + ["-o", str(tmp_path / "t")], device="cpu") == 0
    got = (tmp_path / "t.fastq").read_bytes()
    assert got == (tmp_path / "j.fastq").read_bytes()
    rec = next(iter(fastx.read_fastx(str(tmp_path / "t.fastq"))))
    assert (sim.error_rate(rec.codes, hapB[a:b])
            < 0.7 * sim.error_rate(corrected, hapB[a:b]))
    bad = tmp_path / "bad.fq"
    bad.write_text(f"@WRONG\n{dna.decode(raw)}\n+\n{'!' * len(raw)}\n")
    argv[argv.index(str(rawp))] = str(bad)
    with pytest.raises(SystemExit, match="-L raw read missing"):
        TC.main(argv + ["-o", str(tmp_path / "t2")], device="cpu")


# ---- -u unmapped-read rescue (tests/test_rescue.py) ----

@pytest.fixture(scope="module")
def unmapped_data(tmp_path_factory):
    """tests/test_rescue.py's loci: short reads cover only the first 8 kb;
    long reads cover all 12 kb; candidates come from the uncovered locus,
    from random sequence and from the covered part."""
    tmp = tmp_path_factory.mktemp("unmapped")
    rng = np.random.default_rng(400)
    genome = sim.random_genome(rng, 12000)
    sreads = sim.short_reads(rng, genome[:8000], coverage=30.0, read_len=100)
    lreads = [genome[s:s + 3000].copy()
              for s in (0, 2000, 5000, 7000, 9000, 8500)]
    cand = ([genome[s:s + 100].copy() for s in (9000, 10000, 11000)]
            + [sim.random_genome(np.random.default_rng(500 + i), 100)
               for i in range(3)]
            + [genome[s:s + 100].copy() for s in (1000, 3000)])
    paths = {}
    for name, seqs in (("short", sreads), ("unmapped", cand)):
        paths[name] = str(tmp / f"{name}.fa")
        with open(paths[name], "w") as f:
            for i, r in enumerate(seqs):
                f.write(f">{name}{i}\n{dna.decode(r)}\n")
    paths["long"] = str(tmp / "long.fq")
    with open(paths["long"], "w") as f:
        for i, r in enumerate(lreads):
            f.write(f"@L{i}\n{dna.decode(r)}\n+\n{'!' * len(r)}\n")
    return tmp, sreads, lreads, cand, paths


def test_find_missing_reads_matches_jax(unmapped_data):
    _, sreads, lreads, cand, paths = unmapped_data
    got = TRS.find_missing_reads(sreads, lreads, cand, k=21, min_count_lr=1)
    assert got == JRS.find_missing_reads(sreads, lreads, cand, k=21,
                                         min_count_lr=1)
    assert set(got) >= {0, 1, 2}
    outs = []
    for PL, Opt in ((JP, JOpt), (TP, TOpt)):
        opt = Opt(filename_seq_in=[paths["short"]],
                  filename_long_in=[paths["long"]],
                  filename_unmapped_in=[paths["unmapped"]], small_k=21)
        reads, ids, names = PL.load_short_reads(opt)
        n = PL.rescue_unmapped(opt, reads, ids, names)
        outs.append((n, ids[-n:], names[-n:]))
    assert outs[0] == outs[1] and outs[1][0] >= 3


def test_unmapped_cli_matches_jax(unmapped_data):
    tmp, _, _, _, paths = unmapped_data
    argv = ["correct", "-s", paths["short"], "-l", paths["long"],
            "-u", paths["unmapped"], "-1",
            "-k", "21", "-K", "31"] + SMALL
    assert JC.main(argv + ["-o", str(tmp / "j")]) == 0
    assert TC.main(argv + ["-o", str(tmp / "t")], device="cpu") == 0
    assert (tmp / "t.fastq").read_bytes() == (tmp / "j.fastq").read_bytes()


# ---- index files (graph/io.py) ----

@pytest.mark.parametrize("with_colors", [True, False])
def test_index_round_trips(tmp_path, with_colors):
    """The port's save_index/load_index round-trip, and each package loads
    the other's file, edge_rescued included."""
    genome, reads, ids, _ = _junction_reads(np.random.default_rng(820))
    (jc, jcol), (tc, tcol) = _graphs(reads, 31, read_ids=ids)
    t_rescue(tc, tcol, TB.build_cdbg(reads, 63, min_count=2), min_cov=2)
    j_rescue(jc, jcol, JB.build_cdbg(reads, 63, min_count=2), min_cov=2)
    if not with_colors:
        jcol = tcol = None
    tp, jp = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    TGIO.save_index(tp, tc, tcol)
    JGIO.save_index(jp, jc, jcol)
    for path, load in ((tp, TGIO.load_index), (tp, JGIO.load_index),
                       (jp, TGIO.load_index)):
        cdbg, colors = load(path)
        for f in ("k", "useq", "uoff", "edges"):
            np.testing.assert_array_equal(getattr(cdbg, f), getattr(tc, f))
        for f in ("keys_lo", "unitig_id", "pos", "strand"):
            np.testing.assert_array_equal(getattr(cdbg.index, f),
                                          getattr(tc.index, f))
        assert cdbg.index.keys_hi is None
        if tcol is None:
            assert colors is None
            continue
        for f in COLOR_FIELDS + ("cap",):
            np.testing.assert_array_equal(getattr(colors, f),
                                          getattr(tcol, f))
