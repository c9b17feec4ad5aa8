"""Public fused adaptive-threshold LIF entry points with surrogate-gradient
VJPs, dispatched via the registry: two families, `alif` (feed-forward) and
`alifrec` (self-recurrent).

`alif_scan(current, tau, rho, v0, a0, v_th, beta, surrogate, alpha)` and
`alifrec_scan(current, w_rec, tau, rho, v0, a0, s0, v_th, beta,
surrogate, alpha)` run the ALIF neuron over (T, B, N) with the moving
threshold v_th + beta * a and the hard reset: `csrc/alifrec.cu` on CUDA
tensors, the plain scans on CPU tensors. s0 holds the 0/1 spikes of the
step before the first. Both are differentiable in every tensor argument
through `_AlifScan` and `_AlifRecScan` (STBP, as the JAX package's custom
VJPs): the backward is `csrc/alif_bwd.cu`'s `alif_bwd_f32` and
`csrc/rec_bwd.cu`'s `alifrec_bwd_f32` on CUDA tensors (`alif_bwd_cuda`,
`alifrec_bwd_cuda`; counted as `alif_bwd`, `alifrec_bwd`), the plain
`alif_scan_bwd_ref` and `alifrec_scan_bwd_ref` on CPU tensors; the
recurrent g_W is spikemm's weight gradient (`lifrec.ops.rec_g_w`).

The recurrent kernels take one of the two routes of `csrc/rec_scan.cuh`
(and of `rec_bwd.cu`) by the row's width, `common.rec_route(N)` (a warp a
batch row up to 128 neurons, a block a row above), and count each launch
on that route's counter (`common.rec_route_launch_counts()`) as well as
on their registry counters.
"""

from __future__ import annotations

import torch

from repro_torch.core.surrogate import check_surrogate
from repro_torch.kernels import _build, registry
from repro_torch.kernels.alifrec.ref import (alif_scan_bwd_ref,
                                             alif_scan_ref,
                                             alifrec_scan_bwd_ref,
                                             alifrec_scan_ref)
from repro_torch.kernels.common import (REC_WARP, check_planes, check_scan,
                                        count_rec_launch, lane_bwd_plan,
                                        lane_bwd_tiles, lane_plan,
                                        lane_tiles, optional_ptr, rec_plan,
                                        rec_tiles, sm_count, smem_budget,
                                        zeroed_counters)
from repro_torch.kernels.lif.ops import kernel_surrogate
from repro_torch.kernels.lifrec.ops import rec_g_w


def _outputs(current: torch.Tensor, v0: torch.Tensor, a0: torch.Tensor):
    return (torch.empty_like(current), torch.empty_like(v0),
            torch.empty_like(a0))


def alif_cuda(current: torch.Tensor, tau: torch.Tensor, rho: torch.Tensor,
              v0: torch.Tensor, a0: torch.Tensor, v_th: float = 1.0,
              beta: float = 1.8):
    """Launch `csrc/alifrec.cu`'s feed-forward kernel on CUDA tensors, in
    CTAs and a staging ring sized by `lane_plan`."""
    check_scan("alif", current, None, [("tau", tau), ("rho", rho)],
               [("v0", v0), ("a0", a0)])
    T, B, N = current.shape
    spikes, vT, aT = _outputs(current, v0, a0)
    if T == 0:
        return spikes, vT.copy_(v0), aT.copy_(a0)
    if v0.numel() == 0:
        return spikes, vT, aT
    warps, _, stages = lane_plan(B * N, T, sm_count(current.device))
    with torch.cuda.device(current.device):
        code = _build.library().alif_f32(
            current.data_ptr(), tau.data_ptr(), rho.data_ptr(),
            v0.data_ptr(), a0.data_ptr(), spikes.data_ptr(), vT.data_ptr(),
            aT.data_ptr(), T, B, N, float(v_th), float(beta), warps, stages,
            torch.cuda.current_stream().cuda_stream)
    _build.check("alif", code)
    alif_cuda.launches += 1
    return spikes, vT, aT


def alifrec_cuda(current: torch.Tensor, w_rec: torch.Tensor,
                 tau: torch.Tensor, rho: torch.Tensor, v0: torch.Tensor,
                 a0: torch.Tensor, s0: torch.Tensor, v_th: float = 1.0,
                 beta: float = 1.8):
    """Launch `csrc/alifrec.cu`'s self-recurrent kernel on CUDA tensors, on
    the route `rec_route(N)` picks, as `rec_plan` plans it."""
    check_scan("alifrec", current, w_rec, [("tau", tau), ("rho", rho)],
               [("v0", v0), ("a0", a0), ("s0", s0)])
    T, B, N = current.shape
    spikes, vT, aT = _outputs(current, v0, a0)
    if T == 0:
        return spikes, vT.copy_(v0), aT.copy_(a0)
    if v0.numel() == 0:
        return spikes, vT, aT
    plan = rec_plan(N, B, smem_budget(current.device))
    with torch.cuda.device(current.device):
        code = _build.library().alifrec_f32(
            current.data_ptr(), w_rec.data_ptr(), tau.data_ptr(),
            rho.data_ptr(), v0.data_ptr(), a0.data_ptr(), s0.data_ptr(),
            spikes.data_ptr(), vT.data_ptr(), aT.data_ptr(), T, B, N,
            float(v_th), float(beta), int(plan.route == REC_WARP), plan.unit,
            int(plan.w_smem), torch.cuda.current_stream().cuda_stream)
    _build.check("alifrec", code)
    alifrec_cuda.launches += 1
    count_rec_launch("alifrec", plan.route)
    return spikes, vT, aT


def _bwd_outputs(current, v0, a0, need_tau, need_rho, need_v0, need_a0):
    """g_current, and the (B, N) g_tau and g_rho partials, g_v0 and g_a0
    where needed (else None)."""
    return (torch.empty_like(current),
            *(torch.empty_like(x) if need else None for x, need in
              ((v0, need_tau), (v0, need_rho), (v0, need_v0),
               (a0, need_a0))))


def _bwd_empty(g_cur, g_tau, g_rho, g_v0, g_a0, g_vT, g_aT):
    """The backward's outputs of a call with no steps or no lanes."""
    return (g_cur, None if g_tau is None else g_tau.zero_().sum(0),
            None if g_rho is None else g_rho.zero_().sum(0),
            None if g_v0 is None else g_v0.copy_(g_vT),
            None if g_a0 is None else g_a0.copy_(g_aT))


def _sum_partials(g_tau, g_rho):
    return (None if g_tau is None else g_tau.sum(0),
            None if g_rho is None else g_rho.sum(0))


def alif_bwd_cuda(current: torch.Tensor, tau: torch.Tensor,
                  rho: torch.Tensor, v0: torch.Tensor, a0: torch.Tensor,
                  spikes: torch.Tensor, g_spikes: torch.Tensor,
                  g_vT: torch.Tensor, g_aT: torch.Tensor, v_th: float = 1.0,
                  beta: float = 1.8, surrogate: str = "rectangle",
                  alpha: float = 1.0, need_tau: bool = True,
                  need_rho: bool = True, need_v0: bool = True,
                  need_a0: bool = True):
    """Launch `csrc/alif_bwd.cu` on CUDA tensors: `alif_scan_bwd_ref`'s
    (g_current, g_tau, g_rho, g_v0, g_a0), None where not needed, g_tau
    and g_rho summed over B by the kernel (in ascending b, as the plain
    version sums them). One launch: a call of more than
    `_build.LANE_BWD_SEG` steps hands it a checkpoint scratch of
    (segments, 2, B, N), and g_tau or g_rho a (2, B, N) scratch of
    per-lane partials and a zeroed counter of the stream."""
    sur = kernel_surrogate("alif_bwd", surrogate)
    check_scan("alif_bwd", current, None, [("tau", tau), ("rho", rho)],
               [("v0", v0), ("a0", a0), ("g_vT", g_vT), ("g_aT", g_aT)])
    check_planes("alif_bwd", current, [("spikes", spikes),
                                       ("g_spikes", g_spikes)])
    T, B, N = current.shape
    g_cur = torch.empty_like(current)
    g_tau, g_rho = (torch.empty_like(tau) if need else None
                    for need in (need_tau, need_rho))
    g_v0 = torch.empty_like(v0) if need_v0 else None
    g_a0 = torch.empty_like(a0) if need_a0 else None
    if T == 0 or v0.numel() == 0:
        return (g_cur, None if g_tau is None else g_tau.zero_(),
                None if g_rho is None else g_rho.zero_(),
                None if g_v0 is None else g_v0.copy_(g_vT),
                None if g_a0 is None else g_a0.copy_(g_aT))
    _, _, segs = lane_bwd_plan(B * N, T)
    ckpt = (torch.empty((segs, 2, B, N), dtype=torch.float32,
                        device=current.device) if segs > 1 else None)
    with torch.cuda.device(current.device):
        stream = torch.cuda.current_stream().cuda_stream
        part = count = None
        if need_tau or need_rho:
            part = torch.empty((2, B, N), dtype=torch.float32,
                               device=current.device)
            count = zeroed_counters(current.device, stream, 1)
        code = _build.library().alif_bwd_f32(
            current.data_ptr(), tau.data_ptr(), rho.data_ptr(),
            v0.data_ptr(), a0.data_ptr(), spikes.data_ptr(),
            g_spikes.data_ptr(), g_vT.data_ptr(), g_aT.data_ptr(),
            optional_ptr(ckpt), optional_ptr(part), optional_ptr(count),
            g_cur.data_ptr(), optional_ptr(g_tau), optional_ptr(g_rho),
            optional_ptr(g_v0), optional_ptr(g_a0), T, B, N, float(v_th),
            float(beta), sur, float(alpha), stream)
    _build.check("alif_bwd", code)
    alif_bwd_cuda.launches += 1
    return g_cur, g_tau, g_rho, g_v0, g_a0


def alifrec_bwd_cuda(current: torch.Tensor, w_rec: torch.Tensor,
                     tau: torch.Tensor, rho: torch.Tensor, v0: torch.Tensor,
                     a0: torch.Tensor, s0: torch.Tensor,
                     spikes: torch.Tensor, g_spikes: torch.Tensor,
                     g_vT: torch.Tensor, g_aT: torch.Tensor,
                     v_th: float = 1.0, beta: float = 1.8,
                     surrogate: str = "rectangle", alpha: float = 1.0,
                     need_tau: bool = True, need_rho: bool = True,
                     need_v0: bool = True, need_a0: bool = True,
                     need_s0: bool = True):
    """Launch `csrc/rec_bwd.cu`'s `alifrec_bwd_f32` on CUDA tensors, on the
    route `rec_route(N)` picks: `alifrec_scan_bwd_ref`'s (g_current,
    g_tau, g_rho, g_v0, g_a0, g_s0), None where not needed, the per-lane
    partials summed over B here."""
    sur = kernel_surrogate("alifrec_bwd", surrogate)
    check_scan("alifrec_bwd", current, w_rec, [("tau", tau), ("rho", rho)],
               [("v0", v0), ("a0", a0), ("s0", s0), ("g_vT", g_vT),
                ("g_aT", g_aT)])
    check_planes("alifrec_bwd", current, [("spikes", spikes),
                                          ("g_spikes", g_spikes)])
    T, B, N = current.shape
    g_cur, g_tau, g_rho, g_v0, g_a0 = _bwd_outputs(
        current, v0, a0, need_tau, need_rho, need_v0, need_a0)
    g_s0 = torch.empty_like(s0) if need_s0 else None
    if T == 0 or v0.numel() == 0:
        return (*_bwd_empty(g_cur, g_tau, g_rho, g_v0, g_a0, g_vT, g_aT),
                None if g_s0 is None else g_s0.zero_())
    u, ap = torch.empty_like(current), torch.empty_like(current)
    w_t = w_rec.t().contiguous()
    plan = rec_plan(N, B, smem_budget(current.device), backward=True)
    with torch.cuda.device(current.device):
        code = _build.library().alifrec_bwd_f32(
            current.data_ptr(), w_rec.data_ptr(), w_t.data_ptr(),
            tau.data_ptr(), rho.data_ptr(), v0.data_ptr(), a0.data_ptr(),
            s0.data_ptr(), spikes.data_ptr(), g_spikes.data_ptr(),
            g_vT.data_ptr(), g_aT.data_ptr(), u.data_ptr(), ap.data_ptr(),
            g_cur.data_ptr(), optional_ptr(g_tau), optional_ptr(g_rho),
            optional_ptr(g_v0), optional_ptr(g_a0), optional_ptr(g_s0), T, B,
            N, float(v_th), float(beta), sur, float(alpha),
            int(plan.route == REC_WARP), plan.unit, int(plan.w_smem),
            torch.cuda.current_stream().cuda_stream)
    _build.check("alifrec_bwd", code)
    alifrec_bwd_cuda.launches += 1
    count_rec_launch("alifrec_bwd", plan.route)
    return (g_cur, *_sum_partials(g_tau, g_rho), g_v0, g_a0, g_s0)


class _AlifScan(torch.autograd.Function):
    """`fwd` forward, `bwd` backward: the implementations `alif_scan`
    dispatches to by device (None), or the pair the parity harness holds
    against each other."""

    @staticmethod
    def forward(ctx, current, tau, rho, v0, a0, v_th, beta, surrogate,
                alpha, fwd, bwd):
        args = (current, tau, rho, v0, a0)
        s, vT, aT = (registry.dispatch("alif", args, v_th=v_th, beta=beta)
                     if fwd is None else fwd(*args, v_th=v_th, beta=beta))
        ctx.save_for_backward(*args, s)
        ctx.cfg = dict(v_th=v_th, beta=beta, surrogate=surrogate,
                       alpha=alpha)
        ctx.bwd = bwd
        return s, vT, aT

    @staticmethod
    def backward(ctx, g_s, g_vT, g_aT):
        current, tau, rho, v0, a0, s = ctx.saved_tensors
        need_c, need_tau, need_rho, need_v0, need_a0 = \
            ctx.needs_input_grad[:5]
        args = (current, tau, rho, v0, a0, s, g_s.contiguous(),
                g_vT.contiguous(), g_aT.contiguous())
        kw = dict(ctx.cfg, need_tau=need_tau, need_rho=need_rho,
                  need_v0=need_v0, need_a0=need_a0)
        g_cur, g_tau, g_rho, g_v0, g_a0 = (
            registry.dispatch_bwd("alif", args, **kw) if ctx.bwd is None
            else ctx.bwd(*args, **kw))
        return ((g_cur if need_c else None, g_tau, g_rho, g_v0, g_a0)
                + (None,) * 6)


class _AlifRecScan(torch.autograd.Function):
    """`fwd` forward, `bwd` backward, as `_AlifScan`; g_W is the spike
    product (`rec_g_w`)."""

    @staticmethod
    def forward(ctx, current, w_rec, tau, rho, v0, a0, s0, v_th, beta,
                surrogate, alpha, fwd, bwd):
        args = (current, w_rec, tau, rho, v0, a0, s0)
        s, vT, aT = (registry.dispatch("alifrec", args, v_th=v_th,
                                       beta=beta)
                     if fwd is None else fwd(*args, v_th=v_th, beta=beta))
        ctx.save_for_backward(*args, s)
        ctx.cfg = dict(v_th=v_th, beta=beta, surrogate=surrogate,
                       alpha=alpha)
        ctx.bwd = bwd
        return s, vT, aT

    @staticmethod
    def backward(ctx, g_s, g_vT, g_aT):
        current, w_rec, tau, rho, v0, a0, s0, s = ctx.saved_tensors
        (need_c, need_w, need_tau, need_rho, need_v0, need_a0,
         need_s0) = ctx.needs_input_grad[:7]
        args = (current, w_rec, tau, rho, v0, a0, s0, s, g_s.contiguous(),
                g_vT.contiguous(), g_aT.contiguous())
        kw = dict(ctx.cfg, need_tau=need_tau, need_rho=need_rho,
                  need_v0=need_v0, need_a0=need_a0, need_s0=need_s0)
        g_cur, g_tau, g_rho, g_v0, g_a0, g_s0 = (
            registry.dispatch_bwd("alifrec", args, **kw) if ctx.bwd is None
            else ctx.bwd(*args, **kw))
        g_w = rec_g_w(s0, s, g_cur).to(w_rec.dtype) if need_w else None
        return ((g_cur if need_c else None, g_w, g_tau, g_rho, g_v0, g_a0,
                 g_s0) + (None,) * 6)


def alif_scan(current: torch.Tensor, tau: torch.Tensor, rho: torch.Tensor,
              v0: torch.Tensor, a0: torch.Tensor, v_th: float = 1.0,
              beta: float = 1.8, surrogate: str = "rectangle",
              alpha: float = 1.0):
    """Fused adaptive-threshold LIF over time. current: (T,B,N);
    tau/rho: (N,); v0/a0: (B,N).

    Returns (spikes (T,B,N), v_final (B,N), a_final (B,N)).
    Differentiable in every tensor argument through surrogate `surrogate`
    of sharpness `alpha` (STBP)."""
    check_surrogate(surrogate)
    return _AlifScan.apply(current, tau, rho, v0, a0, v_th, beta, surrogate,
                           alpha, None, None)


def alifrec_scan(current: torch.Tensor, w_rec: torch.Tensor,
                 tau: torch.Tensor, rho: torch.Tensor, v0: torch.Tensor,
                 a0: torch.Tensor, s0: torch.Tensor, v_th: float = 1.0,
                 beta: float = 1.8, surrogate: str = "rectangle",
                 alpha: float = 1.0):
    """Fused self-recurrent adaptive-threshold LIF. current: (T,B,N);
    w_rec: (N,N); tau/rho: (N,); v0/a0/s0: (B,N).

    Returns (spikes (T,B,N), v_final (B,N), a_final (B,N)).
    Differentiable in every tensor argument (STBP/BPTT)."""
    check_surrogate(surrogate)
    return _AlifRecScan.apply(current, w_rec, tau, rho, v0, a0, s0, v_th,
                              beta, surrogate, alpha, None, None)


def _alif_vjp(fwd, bwd, current, tau, rho, v0, a0, v_th=1.0, beta=1.8,
              surrogate="rectangle", alpha=1.0):
    return _AlifScan.apply(current, tau, rho, v0, a0, v_th, beta, surrogate,
                           alpha, fwd, bwd)


def _alifrec_vjp(fwd, bwd, current, w_rec, tau, rho, v0, a0, s0, v_th=1.0,
                 beta=1.8, surrogate="rectangle", alpha=1.0):
    return _AlifRecScan.apply(current, w_rec, tau, rho, v0, a0, s0, v_th,
                              beta, surrogate, alpha, fwd, bwd)


def _make_alif_inputs(generator: torch.Generator):
    T, B, N = 20, 3, 130                      # as the JAX family's
    current = 0.8 * torch.randn((T, B, N), generator=generator)
    tau = 0.7 + 0.28 * torch.rand((N,), generator=generator)
    rho = 0.85 + 0.14 * torch.rand((N,), generator=generator)
    v0 = torch.zeros((B, N))
    a0 = torch.zeros((B, N))
    return current, tau, rho, v0, a0


def _make_alifrec_inputs(generator: torch.Generator):
    current, tau, rho, v0, a0 = _make_alif_inputs(generator)
    N = current.shape[2]
    w_rec = (0.4 / N ** 0.5) * torch.randn((N, N), generator=generator)
    return current, w_rec, tau, rho, v0, a0, torch.zeros_like(v0)


_ALIF_TILES = lane_tiles("alif_kernel")

registry.register(registry.KernelSpec(
    name="alif", plain=alif_scan_ref, cuda=alif_cuda,
    make_inputs=_make_alif_inputs, tol=1e-4, diff_argnums=(0, 1, 2, 3, 4),
    bwd=registry.Channel(plain=alif_scan_bwd_ref, cuda=alif_bwd_cuda),
    vjp=_alif_vjp, **_ALIF_TILES,
    bwd_tiles=registry.KernelSpec(
        name="alif_bwd", plain=alif_scan_bwd_ref, cuda=alif_bwd_cuda,
        make_inputs=_make_alif_inputs, dims_of=_ALIF_TILES["dims_of"],
        **lane_bwd_tiles("alif_bwd_kernel"))))
registry.register(registry.KernelSpec(
    name="alifrec", plain=alifrec_scan_ref, cuda=alifrec_cuda,
    make_inputs=_make_alifrec_inputs, tol=1e-4,
    diff_argnums=(0, 1, 2, 3, 4, 5, 6),
    bwd=registry.Channel(plain=alifrec_scan_bwd_ref, cuda=alifrec_bwd_cuda),
    vjp=_alifrec_vjp, **rec_tiles(),
    bwd_tiles=registry.KernelSpec(
        name="alifrec_bwd", plain=alifrec_scan_bwd_ref,
        cuda=alifrec_bwd_cuda, make_inputs=_make_alifrec_inputs,
        **rec_tiles(backward=True))))

__all__ = ["alif_scan", "alifrec_scan", "alif_cuda", "alifrec_cuda",
           "alif_bwd_cuda", "alifrec_bwd_cuda", "alif_scan_ref",
           "alifrec_scan_ref", "alif_scan_bwd_ref", "alifrec_scan_bwd_ref"]
