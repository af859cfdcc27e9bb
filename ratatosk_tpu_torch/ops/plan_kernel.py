"""The device planner's two dispatches as hand-written CUDA kernels
(csrc/plan.cu), and their wrappers.

`runs_kernel` takes what ops.plan_device._runs_kernel takes and returns the
same tensors; `probe_kernel` the same for _probe_kernel. On a CPU tensor
each runs that plain version; on a CUDA tensor it launches its kernels or
raises. Nothing falls back from the card.

The reference computes both in plain JAX (ratatosk_tpu/ops/plan_device.py:
`_runs_kernel` and `_probe_kernel`, one XLA program each); the port's plain
versions are a few thousand small PyTorch launches a batch. csrc/plan.cu
says how the kernels map the work. One wrapper call enqueues its kernels
on the current stream (runs: four, probe: eight, one after another) and
counts one launch. It reads nothing back: the caller's collect is where
the host waits. The wrapper allocates the outputs and all scratch with
torch.empty (torch.zeros for the probe's counters): at the batch tier
L = 2^21 some 45 MB for the probe, 28 MB for the runs.
"""
from __future__ import annotations

import torch

from ratatosk_tpu_torch.ops import cuda_lib
from ratatosk_tpu_torch.ops import plan_device as PD

# the pointer and int tables of csrc/plan.cu's launchers, in their order
RUNS_PTRS = ("codes", "key_tbl", "dir0", "rowflag", "upa", "nk", "uid",
             "dirn", "o", "bcnt", "boff", "tot", "sidx", "eidx", "ouid",
             "odir", "oo", "n")
RUNS_INTS = ("L", "k", "rcap", "nn", "nw", "bits", "dmax")
PROBE_PTRS = ("codes", "sstart", "key_tbl", "dir0", "rowflag", "pf", "hf",
              "ex_row", "ex_fw", "hhit", "qmask", "bcnt", "boff", "tot",
              "qlist", "counts", "minid", "maxid", "sel", "oex_row", "oex_fw",
              "ovarid", "n", "of", "stats")
PROBE_INTS = ("L", "k", "stride", "nes", "subs", "indels", "pf_bits",
              "hf_bits", "qcap", "scap", "tcap", "hcap", "nn", "nw", "bits",
              "dmax")
# threads of a position kernel's block (csrc/plan.cu: kThreads), and the
# edit positions a side counts survivors for (kMaxP)
THREADS = 256
MAX_P = 64


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


def _launch(lib_fn, ptrs, ints, arrays, values, dev, stream, what):
    err = lib_fn(cuda_lib.pointer_table([arrays[n] for n in ptrs]), len(ptrs),
                 cuda_lib.int_table([values[n] for n in ints]), len(ints),
                 cuda_lib.device_index(dev), stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({values})")


@cuda_lib.counted
def runs_kernel(codes, hx, nk, *, k: int, rcap: int):
    """ops.plan_device._runs_kernel in one wrapper call on the current
    stream; a CPU tensor takes the plain version."""
    if codes.device.type == "cpu":
        return PD._runs_kernel(codes, hx, nk, k=k, rcap=rcap)
    fn = "runs_kernel"
    dev = _device(fn, codes)
    L = codes.shape[0]
    cuda_lib.check_tensor(fn, "codes", codes, torch.uint8, (L,), dev)
    cuda_lib.check_tensor(fn, "nk", nk, torch.int64, None, dev)
    cuda_lib.check_tensor(fn, "upa", hx.upa, torch.int32, (2 * hx.n, 2), dev)
    arrays = _index_arrays(fn, hx, dev)
    if not 1 <= k <= 64 or L - k + 1 < 1 or rcap < 1:
        raise ValueError(f"{fn}: unsupported k={k} L={L} rcap={rcap}")
    lib = cuda_lib.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    P = L - k + 1
    nblk = -(-P // THREADS)

    def empty(n, dtype=torch.int64):
        return torch.empty(n, dtype=dtype, device=dev)

    out = dict(sidx=empty(rcap), eidx=empty(rcap), ouid=empty(rcap),
               odir=empty(rcap), oo=empty(rcap), n=empty(()))
    arrays = dict(arrays, codes=codes, upa=hx.upa, nk=nk,
                  uid=empty(P, torch.int32), dirn=empty(P, torch.int8),
                  o=empty(P), bcnt=empty(2 * nblk, torch.int32),
                  boff=empty(2 * nblk, torch.int32), tot=empty(2, torch.int32),
                  **out)
    values = dict(_index_ints(hx), L=L, k=k, rcap=rcap)
    _launch(lib.plan_runs_launch, RUNS_PTRS, RUNS_INTS, arrays, values, dev,
            stream, "runs")
    cuda_lib.add_launches(runs_kernel, stream)
    return (out["sidx"], out["eidx"], out["ouid"], out["odir"], out["oo"],
            out["n"])


@cuda_lib.counted
def probe_kernel(codes, sstart, hx, pf_tbl, hf_tbl, *, k: int, stride: int,
                 nes: int, subs: bool, indels: bool, pf_bits: int,
                 hf_bits: int, qcap: int, hcap: int):
    """ops.plan_device._probe_kernel in one wrapper call on the current
    stream; a CPU tensor takes the plain version."""
    if codes.device.type == "cpu":
        return PD._probe_kernel(
            codes, sstart, hx, pf_tbl, hf_tbl, k=k, stride=stride, nes=nes,
            subs=subs, indels=indels, pf_bits=pf_bits, hf_bits=hf_bits,
            qcap=qcap, hcap=hcap)
    fn = "probe_kernel"
    dev = _device(fn, codes)
    L = codes.shape[0]
    cuda_lib.check_tensor(fn, "codes", codes, torch.uint8, (L,), dev)
    cuda_lib.check_tensor(fn, "sstart", sstart, torch.int64, (L,), dev)
    cuda_lib.check_tensor(fn, "pf_tbl", pf_tbl, torch.int32,
                          (1 << max(pf_bits - 5, 0),), dev)
    cuda_lib.check_tensor(fn, "hf_tbl", hf_tbl, torch.int32,
                          (1 << max(hf_bits - 5, 0),), dev)
    arrays = _index_arrays(fn, hx, dev)
    scap, tcap = PD.probe_caps(qcap)
    if not 3 <= k <= 63 or L - k + 1 < 1 or stride < 1 or nes < 0 \
            or qcap < 1 or hcap < 1:
        raise ValueError(f"{fn}: unsupported k={k} L={L} stride={stride} "
                         f"nes={nes} qcap={qcap} hcap={hcap}")
    lib = cuda_lib.library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    # (kind, side) pairs: two sides of SUB, and of DEL and INS
    ns = 2 * (int(subs) + 2 * int(indels))
    nblk = -(-L // THREADS)

    def empty(n, dtype=torch.int64):
        return torch.empty(n, dtype=dtype, device=dev)

    out = dict(sel=empty(hcap), oex_row=empty(hcap), oex_fw=empty(hcap),
               ovarid=empty(hcap), n=empty(()), of=empty((), torch.bool),
               stats=empty(4))
    arrays = dict(
        arrays, codes=codes, sstart=sstart, pf=pf_tbl, hf=hf_tbl,
        ex_row=empty(L, torch.int32), ex_fw=empty(L, torch.int8),
        hhit=empty(L, torch.uint8), qmask=empty(L, torch.uint8),
        bcnt=empty((ns + 1) * nblk, torch.int32),
        boff=empty((ns + 1) * nblk, torch.int32),
        tot=empty(ns + 1, torch.int32),
        qlist=empty(max(ns, 1) * qcap, torch.int32),
        # survivors per (kind, side, p) step, then the allowed positions
        counts=torch.zeros(ns * MAX_P + 1, dtype=torch.int64, device=dev),
        minid=empty(L, torch.int32), maxid=empty(L, torch.int32), **out)
    values = dict(_index_ints(hx), L=L, k=k, stride=stride, nes=nes,
                  subs=int(subs), indels=int(indels), pf_bits=pf_bits,
                  hf_bits=hf_bits, qcap=qcap, scap=scap, tcap=tcap, hcap=hcap)
    _launch(lib.plan_probe_launch, PROBE_PTRS, PROBE_INTS, arrays, values,
            dev, stream, "probe")
    cuda_lib.add_launches(probe_kernel, stream)
    return (out["sel"], out["oex_row"], out["oex_fw"], out["ovarid"],
            out["n"], out["of"], out["stats"])
