"""Public fused-LIF entry point with a surrogate-gradient VJP.

`lif_scan(current, tau, v0, v_th, surrogate, alpha, reset)` runs the
serial-in-time LIF over (T, B, N): `csrc/lif.cu` on CUDA tensors, the
plain scan on CPU tensors. Both the zero and the subtract reset are
supported. It is differentiable in (current, tau, v0) through `_LifScan`
(STBP, as the JAX package's custom VJP): the backward is
`csrc/lif_bwd.cu`'s `lif_bwd_f32` kernel on CUDA tensors (`lif_bwd_cuda`,
its own launch counter, listed as `lif_bwd`) and `lif_scan_bwd_ref` on
CPU tensors, each computing only the gradients autograd asks for.
"""

from __future__ import annotations

import torch

from repro_torch.core.surrogate import check_surrogate
from repro_torch.kernels import _build, registry
from repro_torch.kernels.common import (check_planes, check_scan,
                                        lane_bwd_plan, lane_bwd_tiles,
                                        lane_plan, lane_tiles, optional_ptr,
                                        sm_count,
                                        zeroed_counters)
from repro_torch.kernels.lif.ref import lif_scan_bwd_ref, lif_scan_ref

# the surrogates the backward kernels compute in registers (the others
# `register` adds run on the CPU only)
KERNEL_SURROGATES = ("arctan", "rectangle", "sigmoid", "triangle")


def kernel_surrogate(name: str, surrogate: str) -> int:
    """The index the backward kernels (`lif_bwd`, `lifrec_bwd`, `alif_bwd`,
    `alifrec_bwd`) take for `surrogate`; raises for one they do not
    compute."""
    if surrogate not in KERNEL_SURROGATES:
        check_surrogate(surrogate)
        raise NotImplementedError(
            f"{name}: the kernel computes the surrogates "
            f"{KERNEL_SURROGATES}; {surrogate!r} runs on the CPU only")
    return KERNEL_SURROGATES.index(surrogate)


def lif_cuda(current: torch.Tensor, tau: torch.Tensor, v0: torch.Tensor,
             v_th: float = 1.0, reset: str = "zero"):
    """Launch `csrc/lif.cu` on CUDA tensors, in CTAs and a staging ring
    sized by `lane_plan`."""
    if reset not in ("zero", "subtract"):
        raise ValueError(f"lif: reset must be 'zero' or 'subtract', "
                         f"got {reset!r}")
    check_scan("lif", current, None, [("tau", tau)], [("v0", v0)])
    T, B, N = current.shape
    spikes = torch.empty_like(current)
    vT = torch.empty_like(v0)
    if T == 0:
        return spikes, vT.copy_(v0)
    if v0.numel() == 0:
        return spikes, vT
    warps, _, stages = lane_plan(B * N, T, sm_count(current.device))
    with torch.cuda.device(current.device):
        code = _build.library().lif_f32(
            current.data_ptr(), tau.data_ptr(), v0.data_ptr(),
            spikes.data_ptr(), vT.data_ptr(), T, B, N, float(v_th),
            int(reset == "subtract"), warps, stages,
            torch.cuda.current_stream().cuda_stream)
    _build.check("lif", code)
    lif_cuda.launches += 1
    return spikes, vT


def lif_bwd_cuda(current: torch.Tensor, tau: torch.Tensor,
                 v0: torch.Tensor, spikes: torch.Tensor,
                 g_spikes: torch.Tensor, g_vT: torch.Tensor,
                 v_th: float = 1.0, surrogate: str = "rectangle",
                 alpha: float = 1.0, reset: str = "zero",
                 need_tau: bool = True, need_v0: bool = True):
    """Launch `csrc/lif_bwd.cu` on CUDA tensors: `lif_scan_bwd_ref`'s
    (g_current, g_tau, g_v0), None where not needed, g_tau summed over B
    by the kernel (in ascending b, as the plain version sums it). One
    launch and nothing after it: a call of more than `_build.LANE_BWD_SEG`
    steps hands it a checkpoint scratch of (segments, B, N), and g_tau a
    (B, N) scratch of per-lane partials and a zeroed counter of the
    stream."""
    if reset not in ("zero", "subtract"):
        raise ValueError(f"lif: reset must be 'zero' or 'subtract', "
                         f"got {reset!r}")
    sur = kernel_surrogate("lif_bwd", surrogate)
    check_scan("lif_bwd", current, None, [("tau", tau)],
               [("v0", v0), ("g_vT", g_vT)])
    check_planes("lif_bwd", current, [("spikes", spikes),
                                      ("g_spikes", g_spikes)])
    T, B, N = current.shape
    g_cur = torch.empty_like(current)
    g_tau = torch.empty_like(tau) if need_tau else None
    g_v0 = torch.empty_like(v0) if need_v0 else None
    if T == 0 or v0.numel() == 0:
        return (g_cur, None if g_tau is None else g_tau.zero_(),
                None if g_v0 is None else g_v0.copy_(g_vT))
    _, _, segs = lane_bwd_plan(B * N, T)
    ckpt = (torch.empty((segs, B, N), dtype=torch.float32,
                        device=current.device) if segs > 1 else None)
    with torch.cuda.device(current.device):
        stream = torch.cuda.current_stream().cuda_stream
        part = count = None
        if need_tau:
            part = torch.empty((B, N), dtype=torch.float32,
                               device=current.device)
            count = zeroed_counters(current.device, stream, 1)
        code = _build.library().lif_bwd_f32(
            current.data_ptr(), tau.data_ptr(), v0.data_ptr(),
            spikes.data_ptr(), g_spikes.data_ptr(), g_vT.data_ptr(),
            optional_ptr(ckpt), optional_ptr(part), optional_ptr(count),
            g_cur.data_ptr(), optional_ptr(g_tau), optional_ptr(g_v0), T, B,
            N, float(v_th), int(reset == "subtract"), sur, float(alpha),
            stream)
    _build.check("lif_bwd", code)
    lif_bwd_cuda.launches += 1
    return g_cur, g_tau, g_v0


class _LifScan(torch.autograd.Function):
    """`fwd` forward, `bwd` backward: the implementations `lif_scan`
    dispatches to by device (None), or the pair the parity harness
    holds against each other."""

    @staticmethod
    def forward(ctx, current, tau, v0, v_th, surrogate, alpha, reset, fwd,
                bwd):
        if fwd is None:
            s, vT = registry.dispatch("lif", (current, tau, v0), v_th=v_th,
                                      reset=reset)
        else:
            s, vT = fwd(current, tau, v0, v_th=v_th, reset=reset)
        ctx.save_for_backward(current, tau, v0, s)
        ctx.cfg = dict(v_th=v_th, surrogate=surrogate, alpha=alpha,
                       reset=reset)
        ctx.bwd = bwd
        return s, vT

    @staticmethod
    def backward(ctx, g_s, g_vT):
        current, tau, v0, s = ctx.saved_tensors
        need_c, need_tau, need_v0 = ctx.needs_input_grad[:3]
        args = (current, tau, v0, s, g_s.contiguous(), g_vT.contiguous())
        kw = dict(ctx.cfg, need_tau=need_tau, need_v0=need_v0)
        g_cur, g_tau, g_v0 = (registry.dispatch_bwd("lif", args, **kw)
                              if ctx.bwd is None else ctx.bwd(*args, **kw))
        return (g_cur if need_c else None, g_tau, g_v0) + (None,) * 6


def lif_scan(current: torch.Tensor, tau: torch.Tensor, v0: torch.Tensor,
             v_th: float = 1.0, surrogate: str = "rectangle",
             alpha: float = 1.0, reset: str = "zero"):
    """Fused LIF over time. current: (T,B,N); tau: (N,); v0: (B,N).

    reset: "zero" (hard reset) or "subtract" (v <- v - v_th on spike).
    Returns (spikes (T,B,N), v_final (B,N)). Differentiable in (current,
    tau, v0) through surrogate `surrogate` of sharpness `alpha` (STBP)."""
    check_surrogate(surrogate)
    return _LifScan.apply(current, tau, v0, v_th, surrogate, alpha, reset,
                          None, None)


def _vjp(fwd, bwd, current, tau, v0, v_th=1.0, surrogate="rectangle",
         alpha=1.0, reset="zero"):
    return _LifScan.apply(current, tau, v0, v_th, surrogate, alpha, reset,
                          fwd, bwd)


def _make_inputs(generator: torch.Generator):
    T, B, N = 20, 3, 130
    current = 0.6 * torch.randn((T, B, N), generator=generator)
    tau = 0.7 + 0.28 * torch.rand((N,), generator=generator)
    v0 = torch.zeros((B, N))
    return current, tau, v0


_TILES = lane_tiles("lif_kernel")

registry.register(registry.KernelSpec(
    name="lif", plain=lif_scan_ref, cuda=lif_cuda,
    make_inputs=_make_inputs, tol=1e-4, diff_argnums=(0, 1, 2),
    bwd=registry.Channel(plain=lif_scan_bwd_ref, cuda=lif_bwd_cuda),
    vjp=_vjp, **_TILES,
    bwd_tiles=registry.KernelSpec(
        name="lif_bwd", plain=lif_scan_bwd_ref, cuda=lif_bwd_cuda,
        make_inputs=_make_inputs, dims_of=_TILES["dims_of"],
        **lane_bwd_tiles("lif_bwd_kernel"))))

__all__ = ["lif_scan", "lif_cuda", "lif_bwd_cuda", "lif_scan_ref",
           "lif_scan_bwd_ref", "KERNEL_SURROGATES", "kernel_surrogate"]
