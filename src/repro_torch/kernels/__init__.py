"""Hand-written CUDA kernels for the compute hot-spots, with their plain
PyTorch versions.

Each family is a package with two modules:

  ops.py  — the public entry, the CUDA wrapper (shape/dtype/contiguity
            checks, launch on PyTorch's current stream, launch counter)
            and the `KernelSpec` registration
  ref.py  — the plain PyTorch version: what CPU tensors run, and what the
            kernel is held against on the card

The CUDA sources live in `repro_torch/csrc/`; `_build.py` compiles them
with nvcc for sm_90a into one ctypes-loaded library at first use.

  spikemm  FINDIDX+LOCACC  event-gated spike x weight matmul (dense channel)
  linrec   DIFF            diagonal first-order recurrence y = a*y + x
  lif      DIFF+SEND       fused integrate-fire over time

`incidents.py` is the per-process incident log, kept verbatim from the
JAX package (the serve scheduler records backpressure on it).
"""

from repro_torch.kernels.incidents import (FallbackError, FallbackEvent,
                                           clear_incidents, incidents,
                                           strict_mode)

__all__ = ["FallbackError", "FallbackEvent", "clear_incidents", "incidents",
           "strict_mode"]
