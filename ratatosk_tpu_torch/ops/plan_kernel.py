"""The device planner's two dispatches as hand-written CUDA kernels
(csrc/plan.cu), and their wrappers.

`runs_kernel` takes what ops.plan_device._runs_kernel takes and returns the
same tensors. `probe_kernel` returns what _probe_kernel returns, from the
spans' start offsets (`starts`, int64, ascending) in place of a start per
position: on a CPU tensor it builds that per-position array
(plan_device.span_sstart) and runs the plain version; on a CUDA tensor it
launches its kernels or raises. Nothing falls back from the card.

The reference computes both in plain JAX (ratatosk_tpu/ops/plan_device.py:
`_runs_kernel` and `_probe_kernel`, one XLA program each); the port's plain
versions are a few thousand small PyTorch launches a batch. csrc/plan.cu
says how the kernels map the work. One wrapper call enqueues two CUDA
kernels on the current stream (a prep pass over the codes, then the tile
pass; the probe a third that places the seeds) and counts one launch. It
reads nothing back: the caller's collect is where the host waits. The
wrapper allocates the outputs and the scratch (counters, look-back words,
the prep blocks' extents, the probe's seeds by tile) with torch.empty: at
the batch tier L = 2^21 the probe's outputs are 8 MB and its seeds by
tile 4 MB, the runs' outputs 3.5 MB, the other scratch under 0.2 MB.

The work past the batch's extent is closed form in the kernels; the
functions below state it in Python for the tests (tests/
test_torch_plan_device.py holds them against the plain versions).
"""
from __future__ import annotations

import numpy as np
import torch

from ratatosk_tpu_torch.ops import cuda_lib
from ratatosk_tpu_torch.ops import plan_device as PD

# the pointer and int tables of csrc/plan.cu's launchers, in their order
RUNS_PTRS = ("codes", "key_tbl", "dir0", "rowflag", "upa", "nk", "scratch",
             "sidx", "eidx", "ouid", "odir", "oo", "n")
RUNS_INTS = ("L", "k", "rcap", "nn", "nw", "bits", "dmax", "scratch")
PROBE_PTRS = ("codes", "starts", "key_tbl", "dir0", "rowflag", "pf", "hf",
              "scratch", "seeds", "sel", "oex_row", "oex_fw", "ovarid", "n",
              "of", "stats")
PROBE_INTS = ("L", "k", "stride", "nes", "subs", "indels", "pf_bits",
              "hf_bits", "qcap", "scap", "tcap", "hcap", "nn", "nw", "bits",
              "dmax", "nstarts", "scratch")
# csrc/plan.cu's constants: threads of a block, positions of a probe tile
# and windows of a runs tile, prep blocks at most, (kind, side) pairs and
# edit positions the survivor counters hold, the widest near-exact skip
THREADS = 256
TILE = 1024
RUNS_TILE = 1022
PREP_MAX = 264
MAX_SIDES = 6
MAX_P = 64
MAX_NES = 4096


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def prep_blocks(L: int) -> int:
    """Blocks of the prep pass: one per 16 bytes a thread, at most
    PREP_MAX."""
    return min(PREP_MAX, max(1, _ceil(L, 16 * THREADS)))


def runs_scratch_words(L: int, k: int) -> int:
    """int64 words of the runs' scratch: the tile counter, the starts' and
    the ends' look-back words a tile, the prep blocks' extents (int32)."""
    return 1 + 2 * _ceil(L - k + 1, RUNS_TILE) + (prep_blocks(L) + 1) // 2


def probe_scratch_words(L: int, nsides: int) -> int:
    """int64 words of the probe's scratch: four counters, eight totals, the
    survivors of each (kind, side, p), each tile's seed count and each
    side's look-back words a tile, the prep blocks' extents (int32)."""
    return (12 + MAX_SIDES * MAX_P + (1 + nsides) * _ceil(L, TILE)
            + (prep_blocks(L) + 1) // 2)


# ---- the closed form past the extent (what the kernels do not walk) ----

def extent(codes) -> int:
    """1 + the last index of a base < 4 (0: none)."""
    ok = np.flatnonzero(np.asarray(codes) < 4)
    return int(ok[-1]) + 1 if len(ok) else 0


def runs_tiles(L: int, k: int, E: int) -> int:
    """Tiles the runs walk: windows up to the last that can be valid,
    min(P, E - k + 1); at least one."""
    walk = min(L - k + 1, max(E - k + 1, 0))
    return max(1, _ceil(walk, RUNS_TILE))


def probe_walk(L: int, nes: int, E: int) -> int:
    """X: the probe walks positions [0, X) (whole tiles up to min(L, E +
    nes), at least one): past E + nes no position is near an exact hit,
    none qualifies and none seeds."""
    tiles = max(1, _ceil(min(L, E + nes), TILE))
    return min(L, tiles * TILE)


def tail_allowed(starts, X: int, L: int, stride: int) -> int:
    """Allowed positions in [X, L): every position whose offset from its
    span's start is a multiple of stride (a position before the first start
    counts from 0; the last span runs to L)."""
    if X >= L:
        return 0
    if stride <= 1:
        return L - X
    s = [0] + [int(x) for x in starts]
    ends = [int(x) for x in starts] + [L]
    n = 0
    for s0, hi in zip(s, ends):
        lo = max(X, s0)
        first = s0 + _ceil(lo - s0, stride) * stride
        if first < min(hi, L):
            n += (min(hi, L) - 1 - first) // stride + 1
    return n


def miss_record(hx, nk):
    """(uid, direction, o) of a window with no hit: row 0's flag read by
    the plain version's clamped gather, position 0, strand 0."""
    dirn = int(hx.rowflag[0]) & 1
    return -1, dirn, 0 if dirn == 0 else int(nk[0]) - 1


# the probe's entries past its seeds: sel, ex_row, ex_fw, varid at L - 1
PROBE_FILL = (-1, 0, -1)


# ---- the launches ----

def _index_arrays(fn: str, hx, dev) -> dict:
    """The hash directory's tensors, checked; an empty index is refused
    (the plain version cannot probe one either)."""
    if hx.n < 1:
        raise ValueError(f"{fn}: the index holds no key")
    nw = 4 if hx.two_word else 2
    arrays = dict(key_tbl=hx.key_tbl, dir0=hx.dir0, rowflag=hx.rowflag)
    shapes = dict(key_tbl=(2 * hx.n, nw), dir0=(1 << hx.bits,),
                  rowflag=(2 * hx.n,))
    types = dict(key_tbl=torch.int32, dir0=torch.int64, rowflag=torch.int32)
    for name, t in arrays.items():
        cuda_lib.check_tensor(fn, name, t, types[name], shapes[name], dev)
    return arrays


def _index_ints(hx) -> dict:
    return dict(nn=2 * hx.n, nw=4 if hx.two_word else 2, bits=hx.bits,
                dmax=hx.dmax)


def _device(fn: str, t) -> torch.device:
    dev = t.device
    if dev.type != "cuda":
        raise ValueError(f"{fn}: no kernel for device {dev}")
    return dev


def _launch(lib_fn, ptrs, ints, arrays, values, index, stream, what):
    err = cuda_lib.call_on(
        index, lib_fn, cuda_lib.pointer_table([arrays[n] for n in ptrs]),
        len(ptrs), cuda_lib.int_table([values[n] for n in ints]), len(ints),
        index, stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({values})")


def _check_runs(fn, codes, hx, nk, k, rcap):
    dev = codes.device
    L = codes.shape[0]
    cuda_lib.check_tensor(fn, "codes", codes, torch.uint8, (L,), dev)
    cuda_lib.check_tensor(fn, "nk", nk, torch.int64, None, dev)
    cuda_lib.check_tensor(fn, "upa", hx.upa, torch.int32, (2 * hx.n, 2), dev)
    if not 1 <= k <= 64 or L - k + 1 < 1 or rcap < 1:
        raise ValueError(f"{fn}: unsupported k={k} L={L} rcap={rcap}")
    return _index_arrays(fn, hx, dev)


def enqueue_runs(lib, codes, hx, nk, *, k: int, rcap: int, index: int,
                 stream):
    """Allocate the runs' outputs and scratch beside codes and enqueue
    their kernels through `lib` on device `index`, stream `stream`."""
    arrays = _check_runs("runs_kernel", codes, hx, nk, k, rcap)
    dev, L = codes.device, codes.shape[0]

    def empty(n, dtype=torch.int64):
        return torch.empty(n, dtype=dtype, device=dev)

    out = dict(sidx=empty(rcap), eidx=empty(rcap), ouid=empty(rcap),
               odir=empty(rcap), oo=empty(rcap), n=empty(()))
    scratch = empty(runs_scratch_words(L, k))
    arrays = dict(arrays, codes=codes, upa=hx.upa, nk=nk, scratch=scratch,
                  **out)
    values = dict(_index_ints(hx), L=L, k=k, rcap=rcap,
                  scratch=scratch.numel())
    _launch(lib.plan_runs_launch, RUNS_PTRS, RUNS_INTS, arrays, values, index,
            stream, "runs")
    return (out["sidx"], out["eidx"], out["ouid"], out["odir"], out["oo"],
            out["n"])


@cuda_lib.counted
def runs_kernel(codes, hx, nk, *, k: int, rcap: int):
    """ops.plan_device._runs_kernel in one wrapper call on the current
    stream; a CPU tensor takes the plain version."""
    if codes.device.type == "cpu":
        return PD._runs_kernel(codes, hx, nk, k=k, rcap=rcap)
    dev = _device("runs_kernel", codes)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = enqueue_runs(cuda_lib.library(), codes, hx, nk, k=k, rcap=rcap,
                       index=cuda_lib.device_index(dev), stream=stream)
    cuda_lib.add_launches(runs_kernel, stream)
    return out


def n_sides(subs: bool, indels: bool) -> int:
    """(kind, side) pairs: two sides of SUB, and of DEL and INS."""
    return 2 * (int(subs) + 2 * int(indels))


def enqueue_probe(lib, codes, starts, hx, pf_tbl, hf_tbl, *, k: int,
                  stride: int, nes: int, subs: bool, indels: bool,
                  pf_bits: int, hf_bits: int, qcap: int, hcap: int,
                  index: int, stream):
    """Allocate the probe's outputs and scratch beside codes and enqueue
    its kernels through `lib` on device `index`, stream `stream`."""
    fn = "probe_kernel"
    dev, L = codes.device, codes.shape[0]
    cuda_lib.check_tensor(fn, "codes", codes, torch.uint8, (L,), dev)
    cuda_lib.check_tensor(fn, "starts", starts, torch.int64,
                          (starts.numel(),), dev)
    cuda_lib.check_tensor(fn, "pf_tbl", pf_tbl, torch.int32,
                          (1 << max(pf_bits - 5, 0),), dev)
    cuda_lib.check_tensor(fn, "hf_tbl", hf_tbl, torch.int32,
                          (1 << max(hf_bits - 5, 0),), dev)
    arrays = _index_arrays(fn, hx, dev)
    scap, tcap = PD.probe_caps(qcap)
    if not 3 <= k <= 63 or L - k + 1 < 1 or stride < 1 \
            or not 0 <= nes <= MAX_NES or qcap < 1 or hcap < 1:
        raise ValueError(f"{fn}: unsupported k={k} L={L} stride={stride} "
                         f"nes={nes} qcap={qcap} hcap={hcap}")

    def empty(n, dtype=torch.int64):
        return torch.empty(n, dtype=dtype, device=dev)

    out = dict(sel=empty(hcap), oex_row=empty(hcap), oex_fw=empty(hcap),
               ovarid=empty(hcap), n=empty(()), of=empty((), torch.bool),
               stats=empty(4))
    scratch = empty(probe_scratch_words(L, n_sides(subs, indels)))
    # each tile's seeds in order (position, row, placement, fw), a segment
    # a tile where all fit
    seeds = empty(4 * hcap, torch.int32)
    arrays = dict(arrays, codes=codes, starts=starts, pf=pf_tbl, hf=hf_tbl,
                  scratch=scratch, seeds=seeds, **out)
    values = dict(_index_ints(hx), L=L, k=k, stride=stride, nes=nes,
                  subs=int(subs), indels=int(indels), pf_bits=pf_bits,
                  hf_bits=hf_bits, qcap=qcap, scap=scap, tcap=tcap, hcap=hcap,
                  nstarts=starts.numel(), scratch=scratch.numel())
    _launch(lib.plan_probe_launch, PROBE_PTRS, PROBE_INTS, arrays, values,
            index, stream, "probe")
    return (out["sel"], out["oex_row"], out["oex_fw"], out["ovarid"],
            out["n"], out["of"], out["stats"])


@cuda_lib.counted
def probe_kernel(codes, starts, hx, pf_tbl, hf_tbl, *, k: int, stride: int,
                 nes: int, subs: bool, indels: bool, pf_bits: int,
                 hf_bits: int, qcap: int, hcap: int):
    """ops.plan_device._probe_kernel in one wrapper call on the current
    stream, from the spans' starts; a CPU tensor takes the plain version."""
    opts = dict(k=k, stride=stride, nes=nes, subs=subs, indels=indels,
                pf_bits=pf_bits, hf_bits=hf_bits, qcap=qcap, hcap=hcap)
    if codes.device.type == "cpu":
        return PD._probe_kernel(codes, PD.span_sstart(starts, len(codes)),
                                hx, pf_tbl, hf_tbl, **opts)
    dev = _device("probe_kernel", codes)
    stream = torch.cuda.current_stream(dev).cuda_stream
    out = enqueue_probe(cuda_lib.library(), codes, starts, hx, pf_tbl,
                        hf_tbl, index=cuda_lib.device_index(dev),
                        stream=stream, **opts)
    cuda_lib.add_launches(probe_kernel, stream)
    return out
