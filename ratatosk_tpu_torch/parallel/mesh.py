"""Region-batch mesh over GPUs: the graph replicated per device, region rows
split over the slots.

Counterpart of ratatosk_tpu/parallel/mesh.py. The reference scales by
chunk-scattering long reads with the index replicated per node
(Ratatosk_nf/Ratatosk.nf:5-59,280; SURVEY.md §2.4); inside one process the
JAX package shards every region batch over a `data` mesh axis. Here a `Mesh`
is an ordered tuple of torch devices, its *slots*. A device may repeat
(`[cuda:0, cuda:0]`): one card, or the CPU in the tests, then runs the
split, the replicas and the gather as several cards would.

Every slot runs its share of a launch on its own worker thread, under its
own CUDA stream (`SlotPool`). The beam search syncs with the host once per
branch step, so slots issued one after another from one thread would run
one after another. The Corrector and sharded_beam_search split a launch
the same way (SlotPool.submit_rows, then gather): a slot's upload, launch
and read-back all happen inside its thread, on its stream, and it returns
NumPy, so no tensor crosses streams. Rows are independent, so the gathered
result equals one device's.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ratatosk_tpu_torch.correct import beam as BM
from ratatosk_tpu_torch.correct.graphdev import DeviceGraph

DATA_AXIS = "data"


def canonical_device(device) -> torch.device:
    """torch.device with the CUDA index filled in; raises for a CUDA device
    that torch cannot see."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested, but torch sees no CUDA "
                           "device")
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    if idx >= torch.cuda.device_count():
        raise RuntimeError(f"device cuda:{idx} requested, but torch sees "
                           f"{torch.cuda.device_count()} CUDA devices")
    return torch.device("cuda", idx)


class Mesh:
    """Ordered slots (torch devices; a device may repeat) along one data
    axis."""

    def __init__(self, devices: Sequence):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(canonical_device(d) for d in devices)
        self._streams: Dict[int, torch.cuda.Stream] = {}

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct(self) -> List[torch.device]:
        """The devices in slot order, each once."""
        return list(dict.fromkeys(self.devices))

    def stream(self, i: int) -> torch.cuda.Stream:
        """Slot i's own CUDA stream (made at first use, then kept, so the
        caching allocator reuses the slot's blocks)."""
        s = self._streams.get(i)
        if s is None:
            s = self._streams[i] = torch.cuda.Stream(device=self.devices[i])
        return s

    def run_on_slot(self, i: int, fn: Callable, *args):
        """fn(device, *args) on slot i: under the slot's stream when it is a
        CUDA slot. Waits for the stream before returning."""
        dev = self.devices[i]
        if dev.type != "cuda":
            return fn(dev, *args)
        s = self.stream(i)
        # work queued on the device's default stream before this call (a
        # replica, a shard made by the caller) is visible to the slot
        s.wait_stream(torch.cuda.default_stream(dev))
        with torch.cuda.device(dev), torch.cuda.stream(s):
            out = fn(dev, *args)
        s.synchronize()
        return out

    def __repr__(self) -> str:
        return f"Mesh({', '.join(map(str, self.devices))})"


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Mesh over `devices`, or over every visible CUDA device; the first
    n_devices of them when given (raises if there are fewer)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: torch sees no CUDA device; pass "
                               "devices= explicitly")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = list(devices)
    if n_devices is not None:
        if n_devices > len(devs):
            raise RuntimeError(f"make_mesh: {n_devices} devices requested, "
                               f"{len(devs)} available")
        devs = devs[:n_devices]
    return Mesh(devs)


class SlotPool:
    """One worker thread per mesh slot, each running its slot's work in
    submission order (Mesh.run_on_slot). A context manager: leaving it waits
    for the work queued so far, or cancels what has not started when the
    block raised."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self._ex = [ThreadPoolExecutor(max_workers=1,
                                       thread_name_prefix=f"slot{i}")
                    for i in range(mesh.size)]

    def submit(self, i: int, fn: Callable, *args) -> Future:
        return self._ex[i].submit(self.mesh.run_on_slot, i, fn, *args)

    def submit_rows(self, n_rows: int, fn: Callable,
                    n_real: Optional[int] = None) -> List[Future]:
        """fn(device, rows) on every slot for its contiguous block `rows` (a
        slice, slot_rows) of an n_rows batch. fn slices and uploads its
        rows, launches and reads back on the slot's thread and stream, and
        returns host arrays. A slot whose rows are all padding (rows.start
        >= n_real) is not launched: the padding rows come last and nobody
        reads their results. Futures in slot order, for gather()."""
        n_real = n_rows if n_real is None else n_real
        return [self.submit(i, fn, rows)
                for i, rows in enumerate(slot_rows(n_rows, self.mesh))
                if rows.start < n_real]

    def __enter__(self) -> "SlotPool":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        for ex in self._ex:
            ex.shutdown(wait=True, cancel_futures=exc_type is not None)


def replicate_graph(g: DeviceGraph, mesh: Mesh) -> Dict[torch.device,
                                                        DeviceGraph]:
    """One DeviceGraph per distinct device of the mesh (g itself on its own
    device). Copies are complete when this returns."""
    out = {}
    for dev in mesh.distinct():
        out[dev] = g if g.useq.device == dev else g.to(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return out


def slot_rows(r: int, mesh: Mesh) -> List[slice]:
    """Contiguous row blocks of an r-row batch, one per slot (r must divide
    by the slot count)."""
    n = mesh.size
    if r % n:
        raise ValueError(f"{r} rows do not split over {n} slots")
    per = r // n
    return [slice(i * per, (i + 1) * per) for i in range(n)]


def gather(futs: Sequence[Future]) -> tuple:
    """The slots' host arrays (each future gives a tuple of them)
    concatenated in slot order, item by item. The first failure raises."""
    parts = [f.result() for f in futs]
    return tuple(np.concatenate(x) for x in zip(*parts))


def region_rows(rb: BM.RegionBatch, rows: slice, device) -> BM.RegionBatch:
    """Rows `rows` of a region batch, on `device`."""
    return BM.RegionBatch(**{f.name: getattr(rb, f.name)[rows].to(device)
                             for f in dataclasses.fields(BM.RegionBatch)})


def shard_regions(rb: BM.RegionBatch, mesh: Mesh) -> List[BM.RegionBatch]:
    """Contiguous row blocks of a region batch, each on its slot's device
    (the leading dim must divide by the slot count)."""
    return [region_rows(rb, sl, dev) for sl, dev in
            zip(slot_rows(rb.tgt_masks.shape[0], mesh), mesh.devices)]


def pad_regions_to(rb: BM.RegionBatch, r_pad: int) -> BM.RegionBatch:
    """Pad the leading axis to r_pad with inert rows (tgt_len=1,
    end_tip=-1, max_plen=1; everything else 0)."""
    r = rb.tgt_masks.shape[0]
    if r == r_pad:
        return rb
    fill = dict(tgt_len=1, end_tip=-1, max_plen=1)

    def pad(name, x):
        extra = torch.full((r_pad - r,) + tuple(x.shape[1:]),
                           fill.get(name, 0), dtype=x.dtype, device=x.device)
        return torch.cat([x, extra])

    return BM.RegionBatch(**{f.name: pad(f.name, getattr(rb, f.name))
                             for f in dataclasses.fields(BM.RegionBatch)})


def sharded_beam_search(g: DeviceGraph, rb: BM.RegionBatch, mesh: Mesh, *,
                        beam: int, lmax: int, min_cov: int = 2, band: int = 0,
                        sprint_impl: str = "auto") -> BM.BeamResult:
    """beam_search with the regions split over the mesh's slots and the
    graph replicated: every slot searches its rows at the same time. The
    result is gathered on slot 0's device, in row order."""
    n = mesh.size
    r = rb.tgt_masks.shape[0]
    rp = -(-r // n) * n
    rb = pad_regions_to(rb, rp)
    graphs = replicate_graph(g, mesh)

    def slot(dev, rows):
        res = BM.beam_search(graphs[dev], region_rows(rb, rows, dev),
                             beam=beam, lmax=lmax, min_cov=min_cov,
                             band=band, sprint_impl=sprint_impl)
        return tuple(getattr(res, f).cpu().numpy() for f in BM.FIELDS)

    with SlotPool(mesh) as pool:
        outs = gather(pool.submit_rows(rp, slot, n_real=r))
    dev0 = mesh.devices[0]
    return BM.BeamResult(**{f: torch.from_numpy(x[:r]).to(dev0)
                            for f, x in zip(BM.FIELDS, outs)})
