"""Public entry for the DIFF recurrence, dispatched via the registry.

`linrec(a, x, h0)`: y_t = a_t * y_{t-1} + x_t over axis 0 of x (T, B, D),
from h0 (B, D). `a` is anything that broadcasts to x's shape; a per-neuron
decay (D,) broadcast over T and B reaches the kernel as a stride-0 view
and is never materialised. Forward only: the reverse-time adjoint comes
with the training slice.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, registry
from repro_torch.kernels.common import MAX_WARPS, lane_plan, sm_count
from repro_torch.kernels.linrec.ref import linrec_ref


def _check(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor) -> None:
    if not x.is_cuda:
        raise ValueError(f"linrec: the CUDA kernel takes CUDA tensors, got "
                         f"{x.device}")
    if x.dim() != 3 or tuple(h0.shape) != tuple(x.shape[1:]):
        raise ValueError(f"linrec: x {tuple(x.shape)} must be (T, B, D) and "
                         f"h0 {tuple(h0.shape)} (B, D)")
    for nm, t in (("a", a), ("x", x), ("h0", h0)):
        if t.dtype != torch.float32:
            raise TypeError(f"linrec: {nm} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"linrec: {nm} on {t.device}, x on {x.device}")
    for nm, t in (("x", x), ("h0", h0)):
        if not t.is_contiguous():
            raise ValueError(f"linrec: {nm} must be contiguous")


def linrec_cuda(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor):
    """Launch `csrc/linrec.cu` on CUDA tensors."""
    _check(a, x, h0)
    T, B, D = x.shape
    av = a.expand(x.shape)                   # a view: strides 0 where broadcast
    y = torch.empty_like(x)
    hT = torch.empty_like(h0)
    if T == 0:
        return y, hT.copy_(h0)
    if h0.numel() == 0:
        return y, hT
    warps, _, stages = lane_plan(B * D, T, sm_count(x.device))
    with torch.cuda.device(x.device):
        code = _build.library().linrec_f32(
            av.data_ptr(), av.stride(0), av.stride(1), av.stride(2),
            x.data_ptr(), h0.data_ptr(), y.data_ptr(), hT.data_ptr(),
            T, B, D, warps, stages, torch.cuda.current_stream().cuda_stream)
    _build.check("linrec", code)
    linrec_cuda.launches += 1
    return y, hT


def linrec(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor):
    """y_t = a_t * y_{t-1} + x_t over axis 0. x: (T,B,D); h0: (B,D)."""
    return registry.dispatch("linrec", (a, x, h0))


def _make_inputs(generator: torch.Generator):
    T, B, D = 24, 3, 136
    a = 0.5 + 0.49 * torch.rand((T, B, D), generator=generator)
    x = torch.randn((T, B, D), generator=generator)
    h0 = torch.randn((B, D), generator=generator)
    return a, x, h0


registry.register(registry.KernelSpec(
    name="linrec", plain=linrec_ref, cuda=linrec_cuda,
    make_inputs=_make_inputs, tol=1e-4))

__all__ = ["linrec", "linrec_cuda", "linrec_ref", "lane_plan",
           "MAX_WARPS"]
