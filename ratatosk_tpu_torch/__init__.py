"""ratatosk_tpu_torch — the PyTorch + CUDA port of ratatosk_tpu.

Same module names as `ratatosk_tpu/`, so each counterpart is easy to find.
Host code (graph build, planning, assembly, FASTQ I/O) is NumPy plus the
shared `native/*.cpp` libraries; device state is plain torch tensors on an
explicit device that the caller passes in. The one hand-written Hopper
kernel lives in `csrc/` and is built with nvcc at first use
(`ops/sprint.py`). Nothing here imports JAX.
"""

__version__ = "0.1.0"

from ratatosk_tpu_torch.config import CorrectOpt  # noqa: E402,F401
