"""Public entry for the DIFF recurrence, dispatched via the registry.

`linrec(a, x, h0)`: y_t = a_t * y_{t-1} + x_t over axis 0 of x (T, B, D),
from h0 (B, D). `a` is anything that broadcasts to x's shape; a per-neuron
decay (D,) broadcast over T and B reaches the kernel as a stride-0 view
and is never materialised. It is differentiable in (a, x, h0) through
`_LinRec`, the reverse-time adjoint of the JAX package's custom VJP:
`linrec.cu`'s `linrec_bwd_f32` kernel on CUDA tensors (`linrec_bwd_cuda`,
its own launch counter, listed as `linrec_bwd`), `linrec_bwd_ref` on CPU
tensors. g_a and g_h0 are computed only where autograd needs them (an LI
readout's decay is a constant); g_a comes back in x's shape, and a
broadcast decay's is reduced to its own shape by autograd.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, registry
from repro_torch.kernels.common import (MAX_WARPS, check_planes, lane_plan,
                                        optional_ptr, sm_count)
from repro_torch.kernels.linrec.ref import (linrec_bwd_ref, linrec_naive,
                                            linrec_ref)


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


def linrec_bwd_cuda(a: torch.Tensor, y: torch.Tensor, h0: torch.Tensor,
                    g_y: torch.Tensor, g_hT: torch.Tensor,
                    need_a: bool = True, need_h0: bool = True):
    """Launch `csrc/linrec.cu`'s backward kernel on CUDA tensors:
    `linrec_bwd_ref`'s (g_a, g_x, g_h0), None where not needed."""
    _check(a, y, h0)
    check_planes("linrec_bwd", y, [("g_y", g_y)])
    check_planes("linrec_bwd", h0, [("g_hT", g_hT)])
    T, B, D = y.shape
    av = a.expand(y.shape)                   # a view: strides 0 where broadcast
    g_x = torch.empty_like(y)
    g_a = torch.empty_like(y) if need_a else None
    g_h0 = torch.empty_like(h0) if need_h0 else None
    if T == 0 or h0.numel() == 0:
        return g_a, g_x, None if g_h0 is None else g_h0.copy_(g_hT)
    stages = lane_plan(B * D, T, sm_count(y.device))[2]
    with torch.cuda.device(y.device):
        code = _build.library().linrec_bwd_f32(
            av.data_ptr(), av.stride(0), av.stride(1), av.stride(2),
            y.data_ptr(), h0.data_ptr(), g_y.data_ptr(), g_hT.data_ptr(),
            g_x.data_ptr(), optional_ptr(g_a), optional_ptr(g_h0), T, B, D,
            stages, torch.cuda.current_stream().cuda_stream)
    _build.check("linrec_bwd", code)
    linrec_bwd_cuda.launches += 1
    return g_a, g_x, g_h0


class _LinRec(torch.autograd.Function):
    """`fwd` forward, `bwd` backward: the implementations `linrec`
    dispatches to by device (None), or the pair the parity harness holds
    against each other."""

    @staticmethod
    def forward(ctx, a, x, h0, fwd, bwd):
        y, hT = (registry.dispatch("linrec", (a, x, h0)) if fwd is None
                 else fwd(a, x, h0))
        ctx.save_for_backward(a, y, h0)
        ctx.bwd = bwd
        return y, hT

    @staticmethod
    def backward(ctx, g_y, g_hT):
        a, y, h0 = ctx.saved_tensors
        need_a, need_x, need_h0 = ctx.needs_input_grad[:3]
        args = (a, y, h0, g_y.contiguous(), g_hT.contiguous())
        kw = dict(need_a=need_a, need_h0=need_h0)
        g_a, g_x, g_h0 = (registry.dispatch_bwd("linrec", args, **kw)
                          if ctx.bwd is None else ctx.bwd(*args, **kw))
        if g_a is not None and g_a.shape != a.shape:
            g_a = g_a.sum_to_size(a.shape)
        return g_a, g_x if need_x else None, g_h0, None, None


def linrec(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor):
    """y_t = a_t * y_{t-1} + x_t over axis 0. x: (T,B,D); h0: (B,D).

    Differentiable in (a, x, h0)."""
    return _LinRec.apply(a, x, h0, None, None)


def _vjp(fwd, bwd, a, x, h0):
    return _LinRec.apply(a, x, h0, fwd, bwd)


def _make_inputs(generator: torch.Generator):
    T, B, D = 24, 3, 136
    a = 0.5 + 0.49 * torch.rand((T, B, D), generator=generator)
    x = torch.randn((T, B, D), generator=generator)
    h0 = torch.randn((B, D), generator=generator)
    return a, x, h0


registry.register(registry.KernelSpec(
    name="linrec", plain=linrec_ref, cuda=linrec_cuda,
    make_inputs=_make_inputs, tol=1e-4, diff_argnums=(0, 1, 2),
    bwd=registry.Channel(plain=linrec_bwd_ref, cuda=linrec_bwd_cuda),
    vjp=_vjp))

__all__ = ["linrec", "linrec_cuda", "linrec_bwd_cuda", "linrec_ref",
           "linrec_bwd_ref", "linrec_naive", "lane_plan", "MAX_WARPS"]
