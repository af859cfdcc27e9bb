"""The port's device planner (ratatosk_tpu_torch/ops/plan_device.py) on the
CPU, after tests/test_plan_device.py: its runs and seeds equal the host
planner's (correct/seeds.py) and the JAX planner's, its hash probe equals
the sorted-key lookup, its 128-bit and hash helpers equal a Python-int
oracle and the JAX helpers over edge values, and a Corrector that plans on
the device writes what the host planner writes, also when a batch overflows
its caps and falls back to the host. The probe's overflow flag is pinned to
the three counts the probe kernel keeps, and the cap a fallen-back batch
overflowed is read from its stats. The kernels' closed form past a batch's
extent (ops/plan_kernel.py: the tail's allowed positions, the fill values,
the miss record) is held against the plain versions at extents on a tile
boundary, in a halo, at one valid window, at none and at L, and the span
starts give the per-position span start the planner used to fill. Cases
marked `cuda` run the planner and its kernels (csrc/plan.cu) on the card,
each kernel tensor for tensor against its plain version; JAX is imported
inside the tests that use it, so they also run where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_plan_device.py
"""

import types
from dataclasses import replace as dataclasses_replace

import numpy as np
import pytest
import torch

from ratatosk_tpu_torch.config import CorrectOpt as TOpt
from ratatosk_tpu_torch.correct.engine import Corrector as TCorrector
from ratatosk_tpu_torch.correct.seeds import find_runs, find_weak_seeds_batch
from ratatosk_tpu_torch.graph import build as TB
from ratatosk_tpu_torch.graph.colors import color_graph
from ratatosk_tpu_torch.graph.keys import KeyArray
from ratatosk_tpu_torch.ops import hash_index as HX
from ratatosk_tpu_torch.ops import kmers as K
from ratatosk_tpu_torch.ops import plan_device as PD
from ratatosk_tpu_torch.ops import plan_kernel as PK
from ratatosk_tpu_torch.ops import u128 as U
from ratatosk_tpu_torch.ops.plan_device import DevicePlanner
from ratatosk_tpu_torch.testing import noisy_read, random_genome, short_reads

CPU = torch.device("cpu")
M64 = (1 << 64) - 1


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and the tensors here are small."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk(k: int, glen: int = 20000, seed: int = 0):
    rng = np.random.default_rng(seed)
    genome = random_genome(rng, glen, repeat_frac=0.1, repeat_len=120)
    sreads = short_reads(rng, genome, coverage=25.0)
    return rng, genome, sreads, TB.build_cdbg(sreads, k, min_count=2)


def _key(r):
    return (r.s, r.e, r.uid, r.direction, r.o_s, r.weak, r.rspan)


def _keys(lists):
    return [[_key(x) for x in runs] for runs in lists]


def _t(u: np.ndarray, device=CPU) -> torch.Tensor:
    """uint64 array -> int64 tensor of its bits."""
    return torch.from_numpy(np.asarray(u, np.uint64).view(np.int64)).to(device)


def _u(t: torch.Tensor) -> list:
    """int64 tensor -> its words as Python ints in [0, 2^64)."""
    return [v & M64 for v in t.cpu().tolist()]


# ---- hash-directory probe ----

@pytest.mark.parametrize("k", [31, 63])
def test_hash_probe_matches_sorted_find(k):
    rng, _, _, cdbg = _mk(k)
    hx = HX.HashKmerIndex.build(cdbg.index, CPU)
    idx = cdbg.index
    keys = KeyArray(k, idx.keys_lo, idx.keys_hi if idx.two_word else None)
    rows = rng.integers(0, idx.n, 500)
    q = np.concatenate([idx.keys_lo[rows],
                        rng.integers(0, 1 << 62, 500).astype(np.uint64)])
    qh = None
    if idx.two_word:
        qh = np.concatenate([idx.keys_hi[rows],
                             rng.integers(0, 1 << 60, 500).astype(np.uint64)])
    want = keys.find(KeyArray(k, q, qh))
    got = HX.probe_rows(hx, _t(q), None if qh is None else _t(qh))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:500] >= 0).all()


@pytest.mark.parametrize("k", [31, 63])
def test_prefilter_bitmap_no_false_negatives(k):
    _, _, _, cdbg = _mk(k, glen=8000)
    tbl, bits = HX.make_prefilter_bitmap(cdbg.index, CPU)
    idx = cdbg.index
    if idx.two_word:
        orients = [(idx.keys_lo, idx.keys_hi),
                   K.revcomp_kmer2(idx.keys_hi, idx.keys_lo, k, np)[::-1]]
    else:
        orients = [(idx.keys_lo, None),
                   (K.revcomp_kmer(idx.keys_lo, k, np), None)]
    for lo, hi in orients:        # both orientations must be present
        h = HX.hash_key64(_t(lo), None if hi is None else _t(hi))
        assert HX.prefilter_test(tbl, bits, h).all()


# ---- 128-bit and hash helpers against a Python-int oracle ----

EDGE = np.array([0, 1, 3, 0x7FFFFFFFFFFFFFFF, 0x8000000000000000,
                 0xC000000000000003, 0xFFFFFFFFFFFFFFFF, 0xFFFFFFFF00000000,
                 0x123456789ABCDEF0, 0xF0E1D2C3B4A59687], np.uint64)
SHIFTS = [0, 1, 2, 31, 32, 62, 63, 64, 65, 126, 127, 128]


def _pairs():
    hi = np.repeat(EDGE, len(EDGE))
    lo = np.tile(EDGE, len(EDGE))
    return hi, lo, [(int(h) << 64) | int(v) for h, v in zip(hi, lo)]


def _split128(vals):
    return ([(v >> 64) & M64 for v in vals], [v & M64 for v in vals])


@pytest.mark.parametrize("s", SHIFTS)
def test_u128_shifts_match_oracle(s):
    hi, lo, vals = _pairs()
    m128 = (1 << 128) - 1
    for fn, ref in ((U.shr128, lambda v: v >> s),
                    (U.shl128, lambda v: (v << s) & m128)):
        gh, gl = fn(_t(hi), _t(lo), s)
        assert (_u(gh), _u(gl)) == _split128([ref(v) for v in vals])
    assert _u(U.shr64(_t(lo), s)) == [int(v) >> s for v in lo]
    assert _u(U.shl64(_t(lo), s)) == [(int(v) << s) & M64 for v in lo]
    mh, ml = U.mask128(s)
    assert (mh & M64, ml & M64) == ((((1 << s) - 1) >> 64) & M64,
                                    ((1 << s) - 1) & M64)


def _base(v, m, p):
    return (v >> (2 * (m - 1 - p))) & 3


@pytest.mark.parametrize("m", [30, 31, 32, 33, 62, 63, 64])
def test_u128_base_surgery_matches_oracle(m):
    """get/set/drop/insert of a base in m-base windows: the Python-int
    oracle, and the JAX helpers on the same uint64 words."""
    from ratatosk_tpu.ops import u128 as JU
    hi, lo, vals = _pairs()
    vals = [v & ((1 << (2 * m)) - 1) for v in vals]
    hi, lo = (np.array(x, np.uint64) for x in _split128(vals))
    th, tl = _t(hi), _t(lo)
    for p in sorted({0, 1, m // 2, m - 2, m - 1}):
        s = 2 * (m - 1 - p)
        assert _u(U.get_base(th, tl, m, p)) == [_base(v, m, p) for v in vals]
        for b in range(4):
            want = [(v & ~(3 << s)) | (b << s) for v in vals]
            gh, gl = U.set_base(th, tl, m, p, b)
            assert (_u(gh), _u(gl)) == _split128(want)
            jh, jl = JU.set_base(hi, lo, m, p, b)
            assert (_u(gh), _u(gl)) == (np.asarray(jh).tolist(),
                                        np.asarray(jl).tolist())
            t = s + 2       # bits of bases p..m-1
            want = [(((v >> t) << (t + 2)) | (b << t) | (v & ((1 << t) - 1)))
                    & ((1 << 128) - 1) for v in vals]
            gh, gl = U.insert_base(th, tl, m, p, b)
            assert (_u(gh), _u(gl)) == _split128(want)
            jh, jl = JU.insert_base(hi, lo, m, p, b)
            assert (_u(gh), _u(gl)) == (np.asarray(jh).tolist(),
                                        np.asarray(jl).tolist())
        want = [((v >> (s + 2)) << s) | (v & ((1 << s) - 1)) for v in vals]
        gh, gl = U.drop_base(th, tl, m, p)
        assert (_u(gh), _u(gl)) == _split128(want)
        jh, jl = JU.drop_base(hi, lo, m, p)
        assert (_u(gh), _u(gl)) == (np.asarray(jh).tolist(),
                                    np.asarray(jl).tolist())


def test_hash_helpers_match_jax():
    from ratatosk_tpu.ops import hash_index as JHX
    w = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0x811C9DC5,
                  0x01000193, 0xDEADBEEF], np.uint32)
    a, b = np.repeat(w, len(w)), np.tile(w, len(w))
    ta, tb = (torch.from_numpy(x.astype(np.int64)) for x in (a, b))
    want2 = JHX.hash_words(a, b, xp=np)
    want4 = JHX.hash_words(a, b, b, a, xp=np)
    assert HX.hash_words(ta, tb).tolist() == want2.tolist()
    assert HX.hash_words(ta, tb, tb, ta).tolist() == want4.tolist()
    # the host build runs the same code on NumPy int64 words
    assert HX.hash_words(a.astype(np.int64), b.astype(np.int64)).tolist() \
        == want2.tolist()
    x = np.repeat(EDGE, len(EDGE))
    y = np.tile(EDGE, len(EDGE))
    for got, want in zip(HX.split64(_t(x)), JHX.split64(x)):
        assert got.tolist() == want.tolist()
    assert HX.hash_key64(_t(x), _t(y)).tolist() == \
        JHX.hash_key64(x, y, np).tolist()
    assert HX.hash_key64(_t(x)).tolist() == JHX.hash_key64(x, None, np).tolist()


# ---- runs and probe against the host planner and the JAX planner ----

@pytest.mark.parametrize("k", [31, 63])
def test_device_runs_match_host(k):
    rng, genome, _, cdbg = _mk(k)
    dp = DevicePlanner.build(cdbg, CPU)
    reads = [noisy_read(rng, genome, int(rng.integers(0, len(genome) - 1500)),
                        1500, err=0.08)[0] for _ in range(12)]
    reads.append(np.zeros(5, np.uint8))          # shorter than k
    got = dp.collect_runs(dp.dispatch_runs(reads))
    assert got is not None
    assert _keys(got) == _keys([find_runs(cdbg, r) for r in reads])
    from ratatosk_tpu.ops.plan_device import DevicePlanner as JDevicePlanner
    jdp = JDevicePlanner.build(cdbg)
    assert _keys(got) == _keys(jdp.collect_runs(jdp.dispatch_runs(reads)))


@pytest.mark.parametrize("k,stride,nes", [(31, 1, 16), (31, 2, 0),
                                          (63, 2, 16)])
def test_device_probe_matches_host(k, stride, nes):
    rng, genome, _, cdbg = _mk(k, glen=30000, seed=3)
    dp = DevicePlanner.build(cdbg, CPU)
    reads, spans = [], []
    for i in range(8):
        start = int(rng.integers(0, len(genome) - 2000))
        reads.append(noisy_read(rng, genome, start, 2000, err=0.12)[0])
        spans.append((i, 100, 1900))
    got = dp.collect_probe(dp.dispatch_probe(
        reads, spans, stride=stride, near_exact_skip=nes))
    assert got is not None and dp.n_fallback == 0
    assert _keys(got) == _keys(find_weak_seeds_batch(
        cdbg, reads, spans, stride=stride, near_exact_skip=nes))
    assert sum(r.rspan != k for s in got for r in s) > 0   # indel seeds too
    from ratatosk_tpu.ops.plan_device import DevicePlanner as JDevicePlanner
    jdp = JDevicePlanner.build(cdbg)
    want = jdp.collect_probe(jdp.dispatch_probe(
        reads, spans, stride=stride, near_exact_skip=nes))
    assert _keys(got) == _keys(want)
    # same counts at every phase: allowed, max qualifying, survivors, seeds
    assert dp.last_stats.tolist() == np.asarray(jdp.last_stats).tolist()


# ---- the probe's overflow flag and the kernels' routes ----

_BATCHES: dict = {}


def _probe_batch(k: int):
    """A planner and one probe batch at k (the pad tier's floor, 2^16), made
    once per k: 4 reads of 2 kbp at 6% error (exact k-mers at k=63 too),
    each probed on [100, 1900)."""
    if k not in _BATCHES:
        rng, genome, _, cdbg = _mk(k, glen=30000, seed=3)
        dp = DevicePlanner.build(cdbg, CPU)
        reads = [noisy_read(rng, genome,
                            int(rng.integers(0, len(genome) - 2000)), 2000,
                            err=0.06)[0] for _ in range(4)]
        codes, starts = dp.probe_inputs(reads, [(i, 100, 1900)
                                                for i in range(4)])
        starts = torch.from_numpy(starts)
        _BATCHES[k] = (dp, reads, torch.from_numpy(codes),
                       PD.span_sstart(starts, len(codes)), cdbg, starts)
    return _BATCHES[k][:4]


def _allowed(dp, codes, sstart, *, stride, nes):
    """The probe's allowed positions, from the plain helpers: no exact
    k-window hit within nes, on its span's stride."""
    k, L = dp.k, codes.shape[0]
    whi, wlo, valid = PD._pack_windows(codes, k)
    row, _, _ = HX.probe_rowflag(dp.hx, wlo, whi if k > 32 else None, valid)
    hit = torch.cat([row >= 0, torch.zeros(k - 1, dtype=torch.bool)])
    skip = torch.zeros(L, dtype=torch.bool)
    if nes > 0:
        skip = torch.nn.functional.max_pool1d(
            hit.float()[None, None], 2 * nes + 1, stride=1,
            padding=nes)[0, 0] > 0
    return ~skip & ((torch.arange(L) - sstart) % stride == 0)


def _probe_counts(dp, codes, sstart, *, stride, nes, qcap):
    """What the probe's overflow flag reads, counted with the plain helpers:
    the qualifying positions of each (kind, side), and the prefilter
    survivors of each (kind, side, p) step over the first qcap of them (the
    positions the probe enumerates). Returns (nq list, step counts, total
    survivors)."""
    k, L = dp.k, codes.shape[0]
    h = (k - 1) // 2
    pos = torch.arange(L)
    allowed = _allowed(dp, codes, sstart, stride=stride, nes=nes)
    _, hlo, hvalid = PD._pack_windows(codes, h)
    half = hvalid & HX.prefilter_test(dp.hf_tbl, dp.hf_bits,
                                      HX.hash_key64(hlo))
    half = torch.cat([half, torch.zeros(h - 1, dtype=torch.bool)])
    nqs, steps, total = [], [], 0
    for kind, m, p0 in ((PD._SUB, k, 0), (PD._DEL, k + 1, 1),
                        (PD._INS, k - 1, 1)):
        wh, wl, wv = PD._pack_windows(codes, m)
        validm = torch.cat([wv, torch.zeros(m - 1, dtype=torch.bool)])
        suf_max = (k - h) if kind == PD._DEL else (k - 1 - h)
        suffix = half[torch.clamp(pos + m - h, max=L - 1)]
        for flag, ps in ((half, range(max(p0, h), k)),
                         (suffix, range(p0, suf_max + 1))):
            q = (allowed & validm & flag).nonzero()[:, 0]
            nqs.append(len(q))
            q = q[:qcap]
            for p in ps:
                c = 0
                for vh, vl, keep in PD._variant_key(kind, k, wh[q], wl[q], p):
                    words = list(HX.split64(vl))
                    if dp.hx.two_word:
                        words += list(HX.split64(vh))
                    ok = HX.prefilter_test(dp.pf_tbl, dp.pf_bits,
                                           HX.hash_words(*words))
                    c += int((ok if keep is None else ok & keep).sum())
                steps.append(c)
                total += c
    return nqs, steps, total


@pytest.mark.parametrize("k", [31, 63])
@pytest.mark.parametrize("over", [None, "qcap", "scap", "tcap"])
def test_probe_overflow_flag_is_its_counts(monkeypatch, k, over):
    """The probe's `of` is exactly: some (kind, side) has more than qcap
    qualifying positions, or some (kind, side, p) step more than scap
    prefilter survivors, or all steps more than tcap (the identity the
    probe kernel keeps with counters instead of a survivor buffer); each
    cap exceeded by one in turn, with the seed cap out of reach. stats
    [1:3] are the most qualifying positions and min(survivors, tcap)."""
    dp, _, codes, sstart = _probe_batch(k)
    kw = dict(stride=1, nes=16)
    nqs, steps, total = _probe_counts(dp, codes, sstart, qcap=len(codes),
                                      **kw)
    caps = dict(qcap=max(nqs), scap=max(steps), tcap=total)
    assert min(caps.values()) > 0
    if over is not None:
        caps[over] -= 1
    monkeypatch.setattr(PD, "probe_caps",
                        lambda qcap: (caps["scap"], caps["tcap"]))
    opts = dict(dp.probe_options(len(codes), stride=1, near_exact_skip=16),
                hcap=len(codes), qcap=caps["qcap"])
    *_, of, stats = PD._probe_kernel(codes, sstart, dp.hx, dp.pf_tbl,
                                     dp.hf_tbl, **opts)
    nq, st, tot = _probe_counts(dp, codes, sstart, qcap=caps["qcap"], **kw)
    want = (max(nq) > caps["qcap"] or max(st) > caps["scap"]
            or tot > caps["tcap"])
    assert bool(of) == want == (over is not None)
    assert stats[1:3].tolist() == [max(nqs), min(tot, caps["tcap"])]


@pytest.mark.parametrize("k", [31, 63])
@pytest.mark.parametrize("over", ["qcap", "scap", "tcap", "hcap"])
def test_probe_fallback_records_its_cap(monkeypatch, k, over):
    """A batch that falls back is counted under the cap its `of` came from,
    read from its stats (overflow_cap): each cap exceeded by one in turn
    (the set-up of test_probe_overflow_flag_is_its_counts, with the total
    cap one above the survivors unless it is the one exceeded)."""
    dp, _, codes, sstart = _probe_batch(k)
    nqs, steps, total = _probe_counts(dp, codes, sstart, stride=1, nes=16,
                                      qcap=len(codes))
    caps = dict(qcap=max(nqs), scap=max(steps), tcap=total + 1)
    opts = dict(dp.probe_options(len(codes), stride=1, near_exact_skip=16),
                hcap=len(codes))
    if over == "hcap":
        monkeypatch.setattr(PD, "probe_caps",
                            lambda qcap: (caps["scap"], caps["tcap"]))
        n = PD._probe_kernel(codes, sstart, dp.hx, dp.pf_tbl, dp.hf_tbl,
                             **dict(opts, qcap=caps["qcap"]))[4]
        opts["hcap"] = int(n) - 1
    else:
        caps[over] -= 2 if over == "tcap" else 1
    monkeypatch.setattr(PD, "probe_caps",
                        lambda qcap: (caps["scap"], caps["tcap"]))
    opts["qcap"] = caps["qcap"]
    out = PD._probe_kernel(codes, sstart, dp.hx, dp.pf_tbl, dp.hf_tbl,
                           **opts)
    fresh = dataclasses_replace(dp, fallback_caps={}, n_fallback=0)
    assert fresh.collect_probe((out, np.zeros(1, np.int64), [(0, 0, 1)],
                                opts, None)) is None
    assert fresh.fallback_caps == {over: 1} and fresh.n_fallback == 1


def test_span_sstart_is_the_planners_fill():
    """span_sstart of the span starts equals the per-position span start
    the planner filled before it passed the starts (each span's start from
    its offset to the next span's, the last to L), and 0 without spans."""
    dp, reads, codes, sstart = _probe_batch(31)
    rng = np.random.default_rng(5)
    for spans in ([(i, 100, 1900) for i in range(4)],
                  [(i, int(a), int(a) + int(n)) for i, a, n in zip(
                      rng.integers(0, 4, 40), rng.integers(0, 1500, 40),
                      rng.integers(0, 300, 40))], []):
        c, starts = dp.probe_inputs(reads, spans)
        L = len(c)
        bounds = list(starts) + [L]
        fill = np.zeros(L, np.int64)
        for i, s0 in enumerate(starts):
            fill[s0:bounds[i + 1]] = s0
        got = PD.span_sstart(torch.from_numpy(starts), L)
        assert got.dtype == torch.int64 and got.tolist() == fill.tolist()
    assert torch.equal(sstart, PD.span_sstart(_BATCHES[31][5], len(codes)))


EXTENTS = ("none", "one window", "tile boundary", "halo", "L")
EXTENT_STARTS = [0, 700, 1500, 2600, 3900]


def _extent_case(k: int, name: str, dev=CPU):
    """(planner, codes [4 tiles], span starts, E): the probe batch's bases
    with every separator made a base, cut to 4 * TILE, then bases >= 4
    from the extent E on: none (E = 0), one valid k-window (the first
    exact hit from 1000 on, its bases alone), E on a tile boundary
    (2 * TILE), E 8 short of a tile's end (its nes halo reaches into the
    next tile), no padding (E = L)."""
    dp, _, codes, _ = _probe_batch(k)
    L = 4 * PK.TILE
    base = codes[:L].clone()
    base[base >= 4] = 1
    whi, wlo, valid = PD._pack_windows(base, k)
    row, _, _ = HX.probe_rowflag(dp.hx, wlo, whi if k > 32 else None, valid)
    hit = int((row[1000:] >= 0).nonzero()[0, 0]) + 1000
    E = {"none": 0, "one window": hit + k, "tile boundary": 2 * PK.TILE,
         "halo": 3 * PK.TILE - 8, "L": L}[name]
    c = torch.full((L,), 4, dtype=torch.uint8)
    lo = E - k if name == "one window" else 0
    c[lo:E] = base[lo:E]
    if dev != CPU:
        dp = DevicePlanner.build(_BATCHES[k][4], dev)
    return (dp, c.to(dev), torch.tensor(EXTENT_STARTS, dtype=torch.int64,
                                        device=dev), E)


@pytest.mark.parametrize("name", EXTENTS)
@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("nes", [0, 16])
def test_extent_closed_form_matches_plain(name, stride, nes):
    """The kernels' closed form past the batch's extent against the plain
    versions: the probe walks whole tiles up to E + nes, and the allowed
    positions past them are the tail's on-stride positions (the plain
    version's stats[0] is the walked part plus that); no seed lies past E;
    the entries past n are L, -1, 0, -1. The runs' windows that start or
    end a run lie in the tiles they walk, and the entries past n are P and
    window P - 1's record, a miss's when the last window is not valid."""
    k = 31
    dp, codes, starts, E = _extent_case(k, name)
    assert PK.extent(codes.numpy()) == E
    L, P = len(codes), len(codes) - k + 1
    sstart = PD.span_sstart(starts, L)
    opts = dict(dp.probe_options(L, stride=stride, near_exact_skip=nes),
                hcap=L)
    sel, ex_row, ex_fw, varid, n, of, stats = PD._probe_kernel(
        codes, sstart, dp.hx, dp.pf_tbl, dp.hf_tbl, **opts)
    allowed = _allowed(dp, codes, sstart, stride=stride, nes=nes)
    X = PK.probe_walk(L, nes, E)
    assert X == min(L, max(1, -(-min(L, E + nes) // PK.TILE)) * PK.TILE)
    assert int(allowed[X:].sum()) == PK.tail_allowed(starts.tolist(), X, L,
                                                     stride)
    assert int(stats[0]) == int(allowed[:X].sum()) + PK.tail_allowed(
        starts.tolist(), X, L, stride)
    n = int(n)
    assert not bool(of) and (n == 0 or int(sel[n - 1]) < max(E - k + 2, 1))
    fill = PK.PROBE_FILL
    assert (sel[n:] == L).all() and (ex_row[n:] == fill[0]).all()
    assert (ex_fw[n:] == fill[1]).all() and (varid[n:] == fill[2]).all()
    rcap = 1 << 12
    sidx, eidx, uid, dirn, o, nr = PD._runs_kernel(codes, dp.hx, dp.nk_dev,
                                                   k=k, rcap=rcap)
    nr = int(nr)
    walk = PK.runs_tiles(L, k, E) * PK.RUNS_TILE
    assert nr == 0 or max(int(sidx[nr - 1]), int(eidx[nr - 1])) < min(walk, P)
    assert (sidx[nr:] == P).all() and (eidx[nr:] == P).all()
    if E < L:
        want = PK.miss_record(dp.hx, dp.nk_dev)
        assert {(int(u), int(d), int(oo)) for u, d, oo in
                zip(uid[nr:], dirn[nr:], o[nr:])} == {want}
    if name != "none":
        assert n > 0 and nr > 0


def test_planner_routes_by_impl():
    """impl "torch" runs the plain versions; any other impl the kernels'
    wrappers, which take the plain versions on a CPU tensor and launch
    nothing there."""
    dp, reads, codes, sstart = _probe_batch(31)
    torch_dp = dataclasses_replace(dp, impl="torch")
    assert torch_dp._kernels() == (PD._runs_kernel, PD._probe_kernel)
    assert dp._kernels() == (PK.runs_kernel, PK.probe_kernel)
    before = PK.runs_kernel.launches, PK.probe_kernel.launches
    got = dp.collect_runs(dp.dispatch_runs(reads))
    assert _keys(got) == _keys(torch_dp.collect_runs(
        torch_dp.dispatch_runs(reads)))
    opts = dp.probe_options(len(codes), stride=2, near_exact_skip=16)
    for g, w in zip(PK.probe_kernel(codes, _BATCHES[31][5], dp.hx, dp.pf_tbl,
                                    dp.hf_tbl, **opts),
                    PD._probe_kernel(codes, sstart, dp.hx, dp.pf_tbl,
                                     dp.hf_tbl, **opts)):
        assert torch.equal(g, w)
    assert (PK.runs_kernel.launches, PK.probe_kernel.launches) == before


def test_plan_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a CUDA device raises (no kernel, no
    plain fallback)."""
    dp, _, codes, _ = _probe_batch(31)
    meta = codes.to("meta")
    with pytest.raises(ValueError, match="no kernel"):
        PK.runs_kernel(meta, dp.hx, dp.nk_dev, k=31, rcap=64)
    with pytest.raises(ValueError, match="no kernel"):
        PK.probe_kernel(meta, _BATCHES[31][5].to("meta"), dp.hx, dp.pf_tbl,
                        dp.hf_tbl,
                        **dp.probe_options(len(codes), stride=2,
                                           near_exact_skip=16))


def test_build_declines_huge_index():
    """Past ~3.5e8 keys the int32 placement identity would overflow: no
    planner, and the host planner serves the index."""
    big = types.SimpleNamespace(index=types.SimpleNamespace(n=400_000_000))
    assert DevicePlanner.build(big, CPU) is None


# ---- Corrector(plan_on_device=True) ----

@pytest.fixture(scope="module")
def toy():
    """tests/test_correct_e2e.py's repetitive genome, a graph and reads."""
    rng = np.random.default_rng(101)
    genome = random_genome(rng, 15000, repeat_frac=0.2, repeat_len=200)
    sreads = short_reads(rng, genome, coverage=40.0, read_len=120)
    reads = [noisy_read(rng, genome, int(rng.integers(0, 15000 - 2500)),
                        2500, err=0.10)[0] for _ in range(4)]
    cdbg = TB.build_cdbg(sreads, 21, min_count=2)
    return sreads, reads, cdbg, color_graph(cdbg, sreads)


def _opt(Opt, **kw):
    # a read batch of 20 kbp keeps the planner's pad tier at its floor
    return Opt(small_k=21, k=63, beam_width=8, batch_regions=32,
               weak_seed_min_gap=100, read_batch_bp=20000, **kw)


def _same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.codes, w.codes)
        np.testing.assert_array_equal(g.qual, w.qual)


def test_corrector_plan_on_device_matches_host(toy):
    sreads, reads, cdbg, colors = toy
    host = TCorrector(cdbg, colors, _opt(TOpt), device=CPU)
    dev = TCorrector(cdbg, colors, _opt(TOpt, plan_on_device=True),
                     device=CPU)
    assert host.devplan is None and dev.devplan is not None
    dev.warmup_compile()
    want = host.correct_batch(reads)
    got = dev.correct_batch(reads)
    _same(got, want)
    assert dev.devplan.n_fallback == 0
    assert dev.devplan.last_stats[3] > 0          # the probe found seeds
    from ratatosk_tpu.config import CorrectOpt as JOpt
    from ratatosk_tpu.correct.engine import Corrector as JCorrector
    from ratatosk_tpu.graph import build as JB
    from ratatosk_tpu.graph.colors import color_graph as j_color_graph
    jc = JB.build_cdbg(sreads, 21, min_count=2)
    _same(got, JCorrector(jc, j_color_graph(jc, sreads),
                          _opt(JOpt, plan_on_device=True)).correct_batch(reads))


def test_cap_overflow_falls_back_to_host(toy):
    """A batch whose qualifying positions overflow the cap is planned on the
    host, counted in n_fallback, and corrects to the same output."""
    _, reads, cdbg, colors = toy
    want = TCorrector(cdbg, colors, _opt(TOpt), device=CPU).correct_batch(reads)
    dev = TCorrector(cdbg, colors, _opt(TOpt, plan_on_device=True),
                     device=CPU)
    dev.devplan._qcap = lambda L: 8
    got = dev.correct_batch(reads)
    assert dev.devplan.n_fallback == 1
    _same(got, want)


# ---- on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs the planner on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [31, 63])
def test_planner_on_card_matches_host(cuda_device, k):
    rng, genome, _, cdbg = _mk(k, glen=30000, seed=3)
    dp = DevicePlanner.build(cdbg, cuda_device)
    assert dp.hx.key_tbl.is_cuda
    reads = [noisy_read(rng, genome, int(rng.integers(0, len(genome) - 2000)),
                        2000, err=0.12)[0] for _ in range(8)]
    spans = [(i, 100, 1900) for i in range(8)]
    assert _keys(dp.collect_runs(dp.dispatch_runs(reads))) == \
        _keys([find_runs(cdbg, r) for r in reads])
    got = dp.collect_probe(dp.dispatch_probe(reads, spans, stride=2,
                                             near_exact_skip=16))
    assert _keys(got) == _keys(find_weak_seeds_batch(
        cdbg, reads, spans, stride=2, near_exact_skip=16))


@pytest.mark.cuda
def test_corrector_plan_on_device_on_card(cuda_device, toy):
    _, reads, cdbg, colors = toy
    want = TCorrector(cdbg, colors, _opt(TOpt), device=CPU).correct_batch(reads)
    dev = TCorrector(cdbg, colors, _opt(TOpt, plan_on_device=True),
                     device=cuda_device)
    _same(dev.correct_batch(reads), want)
    assert dev.devplan.n_fallback == 0


def _equal(got, want):
    """Tensor for tensor: dtype, shape and values."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        assert torch.equal(g, w), i


@pytest.mark.cuda
@pytest.mark.parametrize("k", [31, 63])
@pytest.mark.parametrize("stride,nes", [(1, 16), (2, 0)])
def test_plan_kernels_match_plain_on_card(cuda_device, k, stride, nes):
    """csrc/plan.cu's runs and probe kernels against their plain versions on
    the card, on one batch: every output tensor equal, `of` and stats
    included (no cap overflows here); the runs also with a cap below their
    count, where the first rcap entries must still match."""
    _, reads, codes, sstart = _probe_batch(k)
    starts = _BATCHES[k][5].to(cuda_device)
    dp = DevicePlanner.build(_BATCHES[k][4], cuda_device)
    rcodes, _, rcap = dp.runs_inputs(reads)
    rcodes = torch.from_numpy(rcodes).to(cuda_device)
    n_runs = None
    for cap in (rcap, 8):
        got = PK.runs_kernel(rcodes, dp.hx, dp.nk_dev, k=k, rcap=cap)
        want = PD._runs_kernel(rcodes, dp.hx, dp.nk_dev, k=k, rcap=cap)
        _equal(got, want)
        n_runs = int(want[-1])
    assert n_runs > 8
    codes, sstart = codes.to(cuda_device), sstart.to(cuda_device)
    opts = dp.probe_options(len(codes), stride=stride, near_exact_skip=nes)
    launches = PK.probe_kernel.launches
    got = PK.probe_kernel(codes, starts, dp.hx, dp.pf_tbl, dp.hf_tbl, **opts)
    assert PK.probe_kernel.launches == launches + 1
    want = PD._probe_kernel(codes, sstart, dp.hx, dp.pf_tbl, dp.hf_tbl,
                            **opts)
    _equal(got, want)
    assert not bool(want[5]) and int(want[4]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [31, 63])
@pytest.mark.parametrize("over", ["qcap", "scap", "tcap", "hcap"])
def test_plan_probe_overflow_on_card(monkeypatch, cuda_device, k, over):
    """One cap exceeded by one at a time: the probe kernel's `of` and
    stats[0:3] equal the plain version's (its other outputs need not: the
    plain version drops survivors there, and the host plans the batch)."""
    dp_cpu, _, codes, sstart = _probe_batch(k)
    nqs, steps, total = _probe_counts(dp_cpu, codes, sstart, stride=1,
                                      nes=16, qcap=len(codes))
    dp = DevicePlanner.build(_BATCHES[k][4], cuda_device)
    codes, sstart = codes.to(cuda_device), sstart.to(cuda_device)
    starts = _BATCHES[k][5].to(cuda_device)
    caps = dict(qcap=max(nqs), scap=max(steps), tcap=total)
    monkeypatch.setattr(PD, "probe_caps",
                        lambda qcap: (caps["scap"], caps["tcap"]))
    opts = dict(dp.probe_options(len(codes), stride=1, near_exact_skip=16),
                qcap=caps["qcap"], hcap=len(codes))
    if over == "hcap":
        n = PD._probe_kernel(codes, sstart, dp.hx, dp.pf_tbl, dp.hf_tbl,
                             **opts)[4]
        opts["hcap"] = int(n) - 1
    else:
        caps[over] -= 1
        opts["qcap"] = caps["qcap"]
    got = PK.probe_kernel(codes, starts, dp.hx, dp.pf_tbl, dp.hf_tbl, **opts)
    want = PD._probe_kernel(codes, sstart, dp.hx, dp.pf_tbl, dp.hf_tbl,
                            **opts)
    assert bool(got[5]) and bool(want[5])
    assert torch.equal(got[6][:3], want[6][:3])


@pytest.mark.cuda
@pytest.mark.parametrize("name", EXTENTS)
@pytest.mark.parametrize("k", [31, 63])
@pytest.mark.parametrize("stride,nes", [(1, 0), (2, 16), (3, 16)])
def test_plan_kernels_at_extents_on_card(cuda_device, name, k, stride, nes):
    """Both kernels against their plain versions at the extents of
    test_extent_closed_form_matches_plain (on a tile boundary, in a halo, at
    one valid window, at none, at L): every output tensor equal."""
    dp, codes, starts, _ = _extent_case(k, name, cuda_device)
    L = len(codes)
    _equal(PK.runs_kernel(codes, dp.hx, dp.nk_dev, k=k, rcap=1 << 12),
           PD._runs_kernel(codes, dp.hx, dp.nk_dev, k=k, rcap=1 << 12))
    opts = dict(dp.probe_options(L, stride=stride, near_exact_skip=nes),
                hcap=L)
    got = PK.probe_kernel(codes, starts, dp.hx, dp.pf_tbl, dp.hf_tbl, **opts)
    _equal(got, PD._probe_kernel(codes, PD.span_sstart(starts, L), dp.hx,
                                 dp.pf_tbl, dp.hf_tbl, **opts))
