"""Public fused recurrent-LIF entry point with a surrogate-gradient VJP.

`lifrec_scan(current, w_rec, tau, v0, s0, v_th, surrogate, alpha)` runs
the recurrent LIF over (T, B, N) with the hard reset: `csrc/lifrec.cu` on
CUDA tensors, the plain scan on CPU tensors. s0 holds the 0/1 spikes of
the step before the first. It is differentiable in (current, w_rec, tau,
v0, s0) through `_LifRecScan` (STBP, as the JAX package's custom VJP):
the backward is `csrc/rec_bwd.cu`'s `lifrec_bwd_f32` kernel on CUDA
tensors (`lifrec_bwd_cuda`, its own launch counter, listed as
`lifrec_bwd`) and `lifrec_scan_bwd_ref` on CPU tensors, and g_W, the
spike product sum_t s_{t-1}^T Gu_t, goes to spikemm's weight gradient on
the one-step-shifted raster (`rec_g_w`).

The kernels take one of the two routes of `csrc/rec_scan.cuh` (and of
`rec_bwd.cu`) by the row's width, `common.rec_route(N)` (a warp a batch
row up to 128 neurons, a block a row above), and count each launch on
that route's counter (`common.rec_route_launch_counts()`) as well as on
their registry counters. Each launch, forward and backward (its route,
neurons a lane or a thread, W_rec in shared memory or through L2), is
`common.rec_plan`'s, which the wrapper hands the C entry point.
"""

from __future__ import annotations

import torch

from repro_torch.core.surrogate import check_surrogate
from repro_torch.kernels import _build, registry
from repro_torch.kernels.common import (REC_WARP, check_planes, check_scan,
                                        count_rec_launch, optional_ptr,
                                        rec_plan, rec_tiles, smem_budget)
from repro_torch.kernels.lif.ops import kernel_surrogate
from repro_torch.kernels.spikemm.ops import spikemm_g_w
from repro_torch.kernels.lifrec.ref import (lifrec_scan_bwd_ref,
                                            lifrec_scan_ref)


def lifrec_cuda(current: torch.Tensor, w_rec: torch.Tensor,
                tau: torch.Tensor, v0: torch.Tensor, s0: torch.Tensor,
                v_th: float = 1.0):
    """Launch `csrc/lifrec.cu` on CUDA tensors as `rec_plan` plans it (on
    the route `rec_route(N)` picks)."""
    check_scan("lifrec", current, w_rec, [("tau", tau)],
               [("v0", v0), ("s0", s0)])
    T, B, N = current.shape
    spikes = torch.empty_like(current)
    vT = torch.empty_like(v0)
    if T == 0:
        return spikes, vT.copy_(v0)
    if v0.numel() == 0:
        return spikes, vT
    plan = rec_plan(N, B, smem_budget(current.device))
    with torch.cuda.device(current.device):
        code = _build.library().lifrec_f32(
            current.data_ptr(), w_rec.data_ptr(), tau.data_ptr(),
            v0.data_ptr(), s0.data_ptr(), spikes.data_ptr(), vT.data_ptr(),
            T, B, N, float(v_th), int(plan.route == REC_WARP), plan.unit,
            int(plan.w_smem), torch.cuda.current_stream().cuda_stream)
    _build.check("lifrec", code)
    lifrec_cuda.launches += 1
    count_rec_launch("lifrec", plan.route)
    return spikes, vT


def lifrec_bwd_cuda(current: torch.Tensor, w_rec: torch.Tensor,
                    tau: torch.Tensor, v0: torch.Tensor, s0: torch.Tensor,
                    spikes: torch.Tensor, g_spikes: torch.Tensor,
                    g_vT: torch.Tensor, v_th: float = 1.0,
                    surrogate: str = "rectangle", alpha: float = 1.0,
                    need_tau: bool = True, need_v0: bool = True,
                    need_s0: bool = True):
    """Launch `csrc/rec_bwd.cu`'s `lifrec_bwd_f32` on CUDA tensors, on the
    route `rec_route(N)` picks: `lifrec_scan_bwd_ref`'s (g_current, g_tau,
    g_v0, g_s0), None where not needed, the per-lane g_tau partials summed
    over B here."""
    sur = kernel_surrogate("lifrec_bwd", surrogate)
    check_scan("lifrec_bwd", current, w_rec, [("tau", tau)],
               [("v0", v0), ("s0", s0), ("g_vT", g_vT)])
    check_planes("lifrec_bwd", current, [("spikes", spikes),
                                         ("g_spikes", g_spikes)])
    T, B, N = current.shape
    g_cur = torch.empty_like(current)
    g_tau = torch.empty_like(v0) if need_tau else None
    g_v0 = torch.empty_like(v0) if need_v0 else None
    g_s0 = torch.empty_like(s0) if need_s0 else None
    if T == 0 or v0.numel() == 0:
        return (g_cur, None if g_tau is None else g_tau.zero_().sum(0),
                None if g_v0 is None else g_v0.copy_(g_vT),
                None if g_s0 is None else g_s0.zero_())
    u = torch.empty_like(current)
    w_t = w_rec.t().contiguous()
    plan = rec_plan(N, B, smem_budget(current.device), backward=True)
    with torch.cuda.device(current.device):
        code = _build.library().lifrec_bwd_f32(
            current.data_ptr(), w_rec.data_ptr(), w_t.data_ptr(),
            tau.data_ptr(), v0.data_ptr(), s0.data_ptr(), spikes.data_ptr(),
            g_spikes.data_ptr(), g_vT.data_ptr(), u.data_ptr(),
            g_cur.data_ptr(), optional_ptr(g_tau), optional_ptr(g_v0),
            optional_ptr(g_s0), T, B, N, float(v_th), sur, float(alpha),
            int(plan.route == REC_WARP), plan.unit, int(plan.w_smem),
            torch.cuda.current_stream().cuda_stream)
    _build.check("lifrec_bwd", code)
    lifrec_bwd_cuda.launches += 1
    count_rec_launch("lifrec_bwd", plan.route)
    return g_cur, None if g_tau is None else g_tau.sum(0), g_v0, g_s0


def rec_g_w(s0: torch.Tensor, spikes: torch.Tensor,
            gu: torch.Tensor) -> torch.Tensor:
    """g_W = sum_t s_{t-1}^T Gu_t of a self-recurrent scan: spikemm's
    weight gradient (`spikemm_g_w`) on the (T * B, N) one-step-shifted
    raster [s0; s_0 .. s_{T-2}], handed over as s0 (`head`) and the spikes
    plane, with no `cat` and no transposed copy (on the card
    `csrc/spikemm_wgrad.cu` reads both where they lie; the plain product
    on the CPU)."""
    T, B, N = spikes.shape
    if T == 0:
        return torch.zeros((N, N), dtype=gu.dtype, device=gu.device)
    return spikemm_g_w(spikes.reshape(T * B, N), gu.reshape(T * B, N),
                       head=s0.to(spikes.dtype).contiguous())


class _LifRecScan(torch.autograd.Function):
    """`fwd` forward, `bwd` backward: the implementations `lifrec_scan`
    dispatches to by device (None), or the pair the parity harness holds
    against each other."""

    @staticmethod
    def forward(ctx, current, w_rec, tau, v0, s0, v_th, surrogate, alpha,
                fwd, bwd):
        args = (current, w_rec, tau, v0, s0)
        s, vT = (registry.dispatch("lifrec", args, v_th=v_th) if fwd is None
                 else fwd(*args, v_th=v_th))
        ctx.save_for_backward(*args, s)
        ctx.cfg = dict(v_th=v_th, surrogate=surrogate, alpha=alpha)
        ctx.bwd = bwd
        return s, vT

    @staticmethod
    def backward(ctx, g_s, g_vT):
        current, w_rec, tau, v0, s0, s = ctx.saved_tensors
        need_c, need_w, need_tau, need_v0, need_s0 = ctx.needs_input_grad[:5]
        args = (current, w_rec, tau, v0, s0, s, g_s.contiguous(),
                g_vT.contiguous())
        kw = dict(ctx.cfg, need_tau=need_tau, need_v0=need_v0,
                  need_s0=need_s0)
        g_cur, g_tau, g_v0, g_s0 = (
            registry.dispatch_bwd("lifrec", args, **kw) if ctx.bwd is None
            else ctx.bwd(*args, **kw))
        g_w = rec_g_w(s0, s, g_cur).to(w_rec.dtype) if need_w else None
        return ((g_cur if need_c else None, g_w, g_tau, g_v0, g_s0)
                + (None,) * 5)


def lifrec_scan(current: torch.Tensor, w_rec: torch.Tensor,
                tau: torch.Tensor, v0: torch.Tensor, s0: torch.Tensor,
                v_th: float = 1.0, surrogate: str = "rectangle",
                alpha: float = 1.0):
    """Fused recurrent LIF over time. current: (T,B,N); w_rec: (N,N);
    tau: (N,); v0/s0: (B,N).

    Returns (spikes (T,B,N), v_final (B,N)). Differentiable in every
    tensor argument through surrogate `surrogate` of sharpness `alpha`
    (STBP/BPTT)."""
    check_surrogate(surrogate)
    return _LifRecScan.apply(current, w_rec, tau, v0, s0, v_th, surrogate,
                             alpha, None, None)


def _vjp(fwd, bwd, current, w_rec, tau, v0, s0, v_th=1.0,
         surrogate="rectangle", alpha=1.0):
    return _LifRecScan.apply(current, w_rec, tau, v0, s0, v_th, surrogate,
                             alpha, fwd, bwd)


def _make_inputs(generator: torch.Generator):
    T, B, N = 20, 3, 70                       # as the JAX family's
    current = 0.8 * torch.randn((T, B, N), generator=generator)
    w_rec = (0.4 / N ** 0.5) * torch.randn((N, N), generator=generator)
    tau = 0.7 + 0.28 * torch.rand((N,), generator=generator)
    v0 = torch.zeros((B, N))
    s0 = torch.zeros((B, N))
    return current, w_rec, tau, v0, s0


registry.register(registry.KernelSpec(
    name="lifrec", plain=lifrec_scan_ref, cuda=lifrec_cuda,
    make_inputs=_make_inputs, tol=1e-4, diff_argnums=(0, 1, 2, 3, 4),
    bwd=registry.Channel(plain=lifrec_scan_bwd_ref, cuda=lifrec_bwd_cuda),
    vjp=_vjp, **rec_tiles(),
    bwd_tiles=registry.KernelSpec(
        name="lifrec_bwd", plain=lifrec_scan_bwd_ref, cuda=lifrec_bwd_cuda,
        make_inputs=_make_inputs, **rec_tiles(backward=True))))

__all__ = ["lifrec_scan", "lifrec_cuda", "lifrec_bwd_cuda",
           "lifrec_scan_ref", "lifrec_scan_bwd_ref", "rec_g_w"]
