"""The fused beam search: the hand-written CUDA kernel (csrc/beam.cu) that
runs a launch's whole beam search on the card, and its wrapper.

`fused_beam_search` takes what correct.beam.beam_search takes and returns
the same BeamResult. On a CPU tensor it runs the plain version
(beam_search with impl="torch"); on a CUDA tensor it launches the kernel or
raises. Nothing falls back from the card.

The kernel replaces the Pallas TPU kernel of the sprint substeps
(ratatosk_tpu/ops/sprint_pallas.py) on this route, together with the plain
JAX around it: the branch step, the all-frozen loop and the winner
reconstruction (ratatosk_tpu/correct/beam.py:beam_search). A warp owns a
region and loops over its branch steps, doing work only for its live,
unfrozen entries. The reference steps every region of a launch until none
of them has a live, unfrozen entry (the launch-wide step count T), but a
region's steps past its own all-frozen step f_r plus one change nothing its
result reads (correct.beam.beam_search_by_region is the plain version of
this decomposition, and says why). Two launches on one stream realise it
with no host sync: launch 1 runs each region to f_r, saves its entries and
scalars to scratch and raises T to f_r with an atomic max; launch 2 runs
the one step f_r where T > f_r, then picks and reconstructs from step
min(T, f_r+1)-1. A mesh slot, one part of a launch, reads its own T back
between the two launches (4 bytes) and writes the launch's in its place
(launch_t: correct.beam.beam_search). Bands of up to MAX_WIDTH columns, up
to 32 a lane. The wrapper allocates all scratch with torch.empty: the
saved state [R, 11B+32], the double-buffered band rows [R, 2, B, W] (read
and written only when a region holds more than one live, unfrozen entry:
the one it usually holds keeps its row in registers; 16.8 MB at R=512,
B=16, W=257) and the history [R, lmax, B] (written for the steps a region
runs: its f_r, plus one; 264 MB allocated at bucket 5376 and B=16, 2.1 GB
at B=128).
"""
from __future__ import annotations

import dataclasses

import torch

from ratatosk_tpu_torch.ops import cuda_lib

# the pointer table of csrc/beam.cu's beam_search_launch, in its order
PTRS = ("useq", "utbl", "color_sig",
        "tgt_masks", "tgt_len", "start_tip", "start_off", "end_tip",
        "end_off", "colors_sig", "colors_wsig", "max_plen", "end_cyclic",
        "state", "rows", "hist", "t_launch", "f_steps",
        "best_seq", "best_len", "best_dist", "best_end", "second_dist",
        "completed", "n_done")
# its int table
INTS = ("R", "NT", "B", "W", "lmax", "k", "min_cov", "smax", "n_useq",
        "n_utbl", "n_sig", "H", "state_words")
# the widest band the kernel takes (csrc/beam.cu: kMaxW, 32 columns a lane;
# cuda_lib checks the library's export against it once, at load)
MAX_WIDTH = 1024


def refuses(W: int):
    """Why the kernel cannot take a W-column band, or None: the one test of
    its width, which the wrapper and engine.check_kernel_widths make."""
    return None if 1 <= W <= MAX_WIDTH else \
        f"a {W}-column band (at most {MAX_WIDTH})"

_RB_TYPES = dict(tgt_masks=torch.uint8, tgt_len=torch.int32,
                 start_tip=torch.int32, start_off=torch.int32,
                 end_tip=torch.int32, end_off=torch.int32,
                 colors_sig=torch.int8, colors_wsig=torch.int8,
                 max_plen=torch.int32, end_cyclic=torch.bool)


def state_words(B: int) -> int:
    """int32 words of one region's saved state between the two launches:
    11 per beam entry, 32 region scalars."""
    return 11 * B + 32


@cuda_lib.counted
def fused_beam_search(g, rb, *, beam: int, lmax: int, min_cov: int = 2,
                      band: int = 0, sprint: int = 8, launch_t=None):
    """correct.beam.beam_search in the fused kernel (two launches on the
    current stream); a CPU tensor takes the plain version. launch_t (a mesh
    slot's part of a launch: correct.beam.beam_search): between the two
    launches the slot's own step count is read back, and launch 2 runs with
    launch_t of it in t_launch."""
    from ratatosk_tpu_torch.correct import beam as BM
    dev = rb.tgt_masks.device
    if dev.type == "cpu":
        return BM.beam_search(g, rb, beam=beam, lmax=lmax, min_cov=min_cov,
                              band=band, sprint=sprint, impl="torch",
                              launch_t=launch_t)
    if dev.type != "cuda":
        raise ValueError(f"fused_beam_search: no kernel for device {dev}")
    R, NT = rb.tgt_masks.shape
    B, W = beam, BM.band_width(NT, band)
    fn = "fused_beam_search"
    for name, dt in _RB_TYPES.items():
        t = getattr(rb, name)
        shape = ((R, NT) if name == "tgt_masks" else
                 (R, t.shape[-1]) if name in ("colors_sig", "colors_wsig")
                 else (R,))
        cuda_lib.check_tensor(fn, name, t, dt, shape, dev)
    cuda_lib.check_tensor(fn, "useq", g.useq, torch.uint8, None, dev)
    cuda_lib.check_tensor(fn, "utbl", g.utbl, torch.int32,
                          (g.utbl.shape[0], 2, 6), dev)
    cuda_lib.check_tensor(fn, "color_sig", g.color_sig, torch.int8, None, dev)
    H = g.color_sig.shape[-1]
    if g.color_sig.dim() != 2 or rb.colors_sig.shape[1] != H \
            or rb.colors_wsig.shape[1] != H:
        raise ValueError(f"fused_beam_search: color signatures of "
                         f"{H} bins and {rb.colors_sig.shape[1]} disagree")
    lib = cuda_lib.library()
    if not (refuses(W) is None and 1 <= B <= 128
            and 1 <= sprint <= 8 and lmax >= 1 and NT >= 1
            and g.utbl.shape[0] >= 1 and g.color_sig.shape[0] >= 1
            and g.useq.numel() >= 1):
        raise ValueError(f"fused_beam_search: unsupported shape R={R} NT={NT}"
                         f" B={B} W={W} lmax={lmax} sprint={sprint}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    q = enqueue_launch1(lib, g, rb, beam=B, W=W, lmax=lmax, min_cov=min_cov,
                        sprint=sprint, index=cuda_lib.device_index(dev),
                        stream=stream,
                        counted=lambda: cuda_lib.add_launches(
                            fused_beam_search, stream))
    if launch_t is not None:
        # the slot's own T after launch 1 (a 4-byte read-back on this
        # stream), the launch's in its place before launch 2
        own = int(q.t_launch.item()) if R else 0
        q.t_launch.fill_(launch_t(own))
    return enqueue_launch2(q)


@dataclasses.dataclass
class Enqueued:
    """A fused search whose launch 1 is enqueued: what launch 2 needs.
    t_launch holds the step count T that launch 2 reads (launch 1 raises
    it to the batch's own); scratch keeps the tables' tensors alive."""

    lib: object
    index: int
    stream: object
    counted: object
    t_launch: torch.Tensor
    result: object
    shape: str
    ptrs: object = None
    vals: object = None
    scratch: dict = None


def enqueue_launch1(lib, g, rb, *, beam, W, lmax, min_cov, sprint, index,
                    stream, counted) -> Enqueued:
    """Allocate the outputs and scratch beside rb's tensors and enqueue the
    kernel's launch 1 on CUDA device `index`, stream `stream` (checked
    inputs; counted() after the launch)."""
    from ratatosk_tpu_torch.correct import beam as BM
    dev = rb.tgt_masks.device
    R, NT = rb.tgt_masks.shape
    B = beam

    def empty(shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = dict(best_seq=empty((R, lmax), torch.uint8), best_len=empty(R),
               best_dist=empty(R), best_end=empty(R), second_dist=empty(R),
               completed=empty(R, torch.bool), n_done=empty(R))
    t_launch = torch.zeros(1, dtype=torch.int32, device=dev)
    q = Enqueued(lib=lib, index=index, stream=stream, counted=counted,
                 t_launch=t_launch, result=BM.BeamResult(**out),
                 shape=f"R={R} NT={NT} B={B} W={W} lmax={lmax}")
    if R == 0:
        return q
    sw = state_words(B)
    arrays = dict(
        useq=g.useq, utbl=g.utbl, color_sig=g.color_sig,
        **{name: getattr(rb, name) for name in _RB_TYPES},
        state=empty((R, sw)), rows=empty((R, 2, B, W)),
        hist=empty((R, lmax, B)), t_launch=t_launch, f_steps=empty(R),
        **out)
    ints = dict(R=R, NT=NT, B=B, W=W, lmax=lmax, k=g.k, min_cov=min_cov,
                smax=sprint, n_useq=g.useq.numel(), n_utbl=g.utbl.shape[0],
                n_sig=g.color_sig.shape[0], H=g.color_sig.shape[1],
                state_words=sw)
    q.scratch = arrays
    q.ptrs = cuda_lib.pointer_table([arrays[n] for n in PTRS])
    q.vals = cuda_lib.int_table([ints[n] for n in INTS])
    _launch(q, 1)
    return q


def enqueue_launch2(q: Enqueued):
    """Enqueue launch 2 of a search whose launch 1 is enqueued (it reads
    t_launch on the device); returns the BeamResult."""
    if q.ptrs is not None:
        _launch(q, 2)
    return q.result


def _launch(q: Enqueued, phase: int) -> None:
    err = q.lib.beam_search_launch(q.ptrs, len(PTRS), q.vals, len(INTS),
                                   phase, q.index, q.stream)
    if err != 0:
        raise RuntimeError(f"beam kernel launch {phase} failed: CUDA error "
                           f"{err} ({q.shape})")
    q.counted()


def enqueue(lib, g, rb, *, beam, W, lmax, min_cov, sprint, index, stream,
            counted):
    """Both launches of one fused search, as one batch's own launch (T its
    own step count); returns the BeamResult."""
    return enqueue_launch2(enqueue_launch1(
        lib, g, rb, beam=beam, W=W, lmax=lmax, min_cov=min_cov,
        sprint=sprint, index=index, stream=stream, counted=counted))
