"""Public fused adaptive-threshold LIF entry points, dispatched via the
registry: two families, `alif` (feed-forward) and `alifrec`
(self-recurrent).

`alif_scan(current, tau, rho, v0, a0, v_th, beta)` and
`alifrec_scan(current, w_rec, tau, rho, v0, a0, s0, v_th, beta)` run the
ALIF neuron over (T, B, N) with the moving threshold v_th + beta * a and
the hard reset: `csrc/alifrec.cu` on CUDA tensors, the plain scans on CPU
tensors. s0 holds the 0/1 spikes of the step before the first. Forward
only: the STBP backward comes with the training slice.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, registry
from repro_torch.kernels.alifrec.ref import alif_scan_ref, alifrec_scan_ref
from repro_torch.kernels.common import check_rec_n, check_scan


def _outputs(current: torch.Tensor, v0: torch.Tensor, a0: torch.Tensor):
    return (torch.empty_like(current), torch.empty_like(v0),
            torch.empty_like(a0))


def alif_cuda(current: torch.Tensor, tau: torch.Tensor, rho: torch.Tensor,
              v0: torch.Tensor, a0: torch.Tensor, v_th: float = 1.0,
              beta: float = 1.8):
    """Launch `csrc/alifrec.cu`'s feed-forward kernel on CUDA tensors."""
    check_scan("alif", current, None, [("tau", tau), ("rho", rho)],
               [("v0", v0), ("a0", a0)])
    T, B, N = current.shape
    spikes, vT, aT = _outputs(current, v0, a0)
    if T == 0:
        return spikes, vT.copy_(v0), aT.copy_(a0)
    if v0.numel() == 0:
        return spikes, vT, aT
    with torch.cuda.device(current.device):
        code = _build.library().alif_f32(
            current.data_ptr(), tau.data_ptr(), rho.data_ptr(),
            v0.data_ptr(), a0.data_ptr(), spikes.data_ptr(), vT.data_ptr(),
            aT.data_ptr(), T, B, N, float(v_th), float(beta),
            torch.cuda.current_stream().cuda_stream)
    _build.check("alif", code)
    alif_cuda.launches += 1
    return spikes, vT, aT


def alifrec_cuda(current: torch.Tensor, w_rec: torch.Tensor,
                 tau: torch.Tensor, rho: torch.Tensor, v0: torch.Tensor,
                 a0: torch.Tensor, s0: torch.Tensor, v_th: float = 1.0,
                 beta: float = 1.8):
    """Launch `csrc/alifrec.cu`'s self-recurrent kernel on CUDA tensors."""
    check_scan("alifrec", current, w_rec, [("tau", tau), ("rho", rho)],
               [("v0", v0), ("a0", a0), ("s0", s0)])
    T, B, N = current.shape
    check_rec_n("alifrec", N)
    spikes, vT, aT = _outputs(current, v0, a0)
    if T == 0:
        return spikes, vT.copy_(v0), aT.copy_(a0)
    if v0.numel() == 0:
        return spikes, vT, aT
    with torch.cuda.device(current.device):
        code = _build.library().alifrec_f32(
            current.data_ptr(), w_rec.data_ptr(), tau.data_ptr(),
            rho.data_ptr(), v0.data_ptr(), a0.data_ptr(), s0.data_ptr(),
            spikes.data_ptr(), vT.data_ptr(), aT.data_ptr(), T, B, N,
            float(v_th), float(beta),
            torch.cuda.current_stream().cuda_stream)
    _build.check("alifrec", code)
    alifrec_cuda.launches += 1
    return spikes, vT, aT


def alif_scan(current: torch.Tensor, tau: torch.Tensor, rho: torch.Tensor,
              v0: torch.Tensor, a0: torch.Tensor, v_th: float = 1.0,
              beta: float = 1.8):
    """Fused adaptive-threshold LIF over time. current: (T,B,N);
    tau/rho: (N,); v0/a0: (B,N).

    Returns (spikes (T,B,N), v_final (B,N), a_final (B,N))."""
    return registry.dispatch("alif", (current, tau, rho, v0, a0),
                             v_th=v_th, beta=beta)


def alifrec_scan(current: torch.Tensor, w_rec: torch.Tensor,
                 tau: torch.Tensor, rho: torch.Tensor, v0: torch.Tensor,
                 a0: torch.Tensor, s0: torch.Tensor, v_th: float = 1.0,
                 beta: float = 1.8):
    """Fused self-recurrent adaptive-threshold LIF. current: (T,B,N);
    w_rec: (N,N); tau/rho: (N,); v0/a0/s0: (B,N).

    Returns (spikes (T,B,N), v_final (B,N), a_final (B,N))."""
    return registry.dispatch("alifrec",
                             (current, w_rec, tau, rho, v0, a0, s0),
                             v_th=v_th, beta=beta)


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


registry.register(registry.KernelSpec(
    name="alif", plain=alif_scan_ref, cuda=alif_cuda,
    make_inputs=_make_alif_inputs, tol=1e-4))
registry.register(registry.KernelSpec(
    name="alifrec", plain=alifrec_scan_ref, cuda=alifrec_cuda,
    make_inputs=_make_alifrec_inputs, tol=1e-4))

__all__ = ["alif_scan", "alifrec_scan", "alif_cuda", "alifrec_cuda",
           "alif_scan_ref", "alifrec_scan_ref"]
