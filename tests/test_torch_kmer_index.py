"""The port's device k-mer lookup (ratatosk_tpu_torch/ops/kmer_index.py:
KmerIndex.to_device, lookup) and region packing (correct/engine.py:
make_region_batch) against the JAX package's, tolerance 0: the same index
and queries, the same region specs."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ratatosk_tpu import testing as JT
from ratatosk_tpu.correct.engine import make_region_batch as jax_region_batch
from ratatosk_tpu.graph import build as JB
from ratatosk_tpu.graph.keys import KeyArray
from ratatosk_tpu.ops import kmer_index as JKI
from ratatosk_tpu_torch.correct import beam as TBM
from ratatosk_tpu_torch.correct.engine import make_region_batch
from ratatosk_tpu_torch.ops import kmer_index as TKI
from tests.torch_parity import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _index(k):
    """(genome, the JAX package's index of testing's toy genome at k,
    the port's KmerIndex of the same arrays)."""
    rng = np.random.default_rng(31 + k)
    genome = JT.random_genome(rng, 12000, repeat_frac=0.1, repeat_len=120)
    idx = JB.build_cdbg(JT.short_reads(rng, genome, 20.0), k,
                        min_count=2).index
    port = TKI.KmerIndex.build(k, idx.keys_lo, idx.keys_hi, idx.unitig_id,
                               idx.pos, idx.strand)
    return genome, idx, port


def _queries(k, seed):
    """Canonical k-mers of a stretch of the genome and of a noisy read,
    random absent keys with bit 63 set, the all-ones and the zero key;
    with a valid mask that drops every seventh."""
    genome, idx, _ = _index(k)
    rng = np.random.default_rng(seed)
    noisy, _ = JT.noisy_read(rng, genome, 2000, 1500, 0.1)
    los, his = [], []
    for codes in (genome[500:1500], noisy):
        ka, ok = KeyArray.from_codes(codes, k)
        can, _ = ka.canonical()
        los.append(can.lo[ok])
        if can.hi is not None:
            his.append(can.hi[ok])
    n_abs = 300
    edge = np.array([0xFFFFFFFFFFFFFFFF, 0], np.uint64)
    los += [rng.integers(0, 1 << 62, n_abs).astype(np.uint64)
            | np.uint64(1 << 63), edge]
    if idx.two_word:
        his += [rng.integers(0, 1 << 62, n_abs).astype(np.uint64), edge]
    q_lo = np.concatenate(los)
    q_hi = np.concatenate(his) if idx.two_word else None
    valid = np.arange(len(q_lo)) % 7 != 3
    return q_lo, q_hi, valid


@pytest.mark.parametrize("use_valid", [False, True], ids=["all", "valid"])
@pytest.mark.parametrize("k", [31, 63], ids=["k31_one_word", "k63_two_word"])
def test_lookup_matches_jax(k, use_valid):
    _, idx, port = _index(k)
    assert idx.two_word == (k > 32) == port.two_word
    q_lo, q_hi, valid = _queries(k, seed=k)
    v = valid if use_valid else None
    want = np.asarray(JKI.lookup(
        idx.to_device(), jnp.asarray(q_lo),
        None if q_hi is None else jnp.asarray(q_hi),
        None if v is None else jnp.asarray(v)))
    dev = port.to_device(CPU)
    got = TKI.lookup(dev, q_lo, q_hi, v)
    assert got.dtype == torch.int32 and got.shape == q_lo.shape
    np.testing.assert_array_equal(got.numpy(), want)
    # a valid mask given as a torch tensor agrees
    if v is not None:
        np.testing.assert_array_equal(
            TKI.lookup(dev, q_lo, q_hi, torch.from_numpy(v)).numpy(), want)
    hits = want >= 0
    assert hits.sum() > 500 and (~hits).sum() >= 300
    np.testing.assert_array_equal(port.keys_lo[want[hits]], q_lo[hits])


def test_to_device_holds_flipped_keys_and_int32_payload():
    _, idx, port = _index(63)
    dev = port.to_device(CPU)
    assert dev.k == 63 and dev.n == port.n and dev.two_word
    for name, x in (("keys_lo", port.keys_lo), ("keys_hi", port.keys_hi)):
        t = getattr(dev, name)
        assert t.dtype == torch.int64
        np.testing.assert_array_equal(
            t.numpy().view(np.uint64) ^ np.uint64(1 << 63), x)
        # signed order of the flipped words is the unsigned order
        assert bool((t[1:] >= t[:-1]).all()) or name == "keys_lo"
    for name, dt in (("unitig_id", torch.int32), ("pos", torch.int32),
                     ("strand", torch.bool)):
        t = getattr(dev, name)
        assert t.dtype == dt
        np.testing.assert_array_equal(t.numpy(), getattr(idx, name))


@pytest.mark.parametrize("n", [0, 1, 2, 3, 1000])
def test_lookup_step_count_and_edges_match_jax(n):
    """Indexes of 0 to a few keys (the branchless search's fixed step count
    at its edges), one word, keys on both sides of bit 63."""
    rng = np.random.default_rng(n)
    keys = np.unique(rng.integers(0, 1 << 63, n).astype(np.uint64)
                     ^ (rng.integers(0, 2, n).astype(np.uint64)
                        << np.uint64(63)))
    ids = np.arange(len(keys))
    port = TKI.KmerIndex.build(31, keys, None, ids, ids, ids % 2 == 0)
    q = np.concatenate([keys, keys + np.uint64(1), np.array(
        [0, 0xFFFFFFFFFFFFFFFF, 1 << 63], np.uint64)])
    got = TKI.lookup(port.to_device(CPU), q).numpy()
    if n:
        jidx = JKI.KmerIndex.build(31, keys, None, ids, ids, ids % 2 == 0)
        want = np.asarray(JKI.lookup(jidx.to_device(), jnp.asarray(q)))
        np.testing.assert_array_equal(got, want)
    else:
        assert (got == -1).all()
    assert TKI._steps(n) == max(1, int(np.ceil(np.log2(n + 1))))


def test_two_word_lookup_requires_q_hi():
    _, _, port = _index(63)
    with pytest.raises(ValueError, match="q_hi"):
        TKI.lookup(port.to_device(CPU), port.keys_lo[:4])


def test_lookup_takes_a_device_copy_only():
    _, _, port = _index(31)
    with pytest.raises(TypeError, match="to_device"):
        TKI.lookup(port, port.keys_lo[:4])


# ---- make_region_batch ----

@functools.lru_cache(maxsize=None)
def _specs():
    genome, corr = JT.build_toy_corrector(seed=7, glen=20000, k=21,
                                          coverage=30.0)
    specs = JT.toy_region_specs(corr, genome, np.random.default_rng(7), 40)
    return corr, specs


@pytest.mark.parametrize("r_pad", [None, 64], ids=["unpadded", "r_pad64"])
@pytest.mark.parametrize("mirrored", [False, True], ids=["plain", "mirrored"])
def test_make_region_batch_matches_jax(mirrored, r_pad):
    corr, specs = _specs()
    if mirrored:
        specs = [s for s in specs if s.mirror is not None]
    assert len(specs) >= 8
    nt = 2048
    specs = [s for s in specs if len(s.tgt) <= nt]
    kw = dict(mirrored=mirrored, r_pad=r_pad, len_factor=0.3)
    jrb, jl = jax_region_batch(specs, nt, corr.colors.cap, **kw)
    trb, tl = make_region_batch(specs, nt, corr.colors.cap, device="cpu",
                                **kw)
    assert tl == jl
    assert isinstance(trb, TBM.RegionBatch)
    rows = r_pad or len(specs)
    for name, dt in TBM.RegionBatch._DTYPES.items():
        t = getattr(trb, name)
        w = np.asarray(getattr(jrb, name))
        assert t.device == CPU and t.shape[0] == rows, name
        assert t.numpy().dtype == np.dtype(dt), name
        np.testing.assert_array_equal(t.numpy(), w, err_msg=name)
