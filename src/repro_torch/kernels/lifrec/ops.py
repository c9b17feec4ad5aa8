"""Public fused recurrent-LIF entry point, dispatched via the registry.

`lifrec_scan(current, w_rec, tau, v0, s0, v_th)` runs the recurrent LIF
over (T, B, N) with the hard reset: `csrc/lifrec.cu` on CUDA tensors, the
plain scan on CPU tensors. s0 holds the 0/1 spikes of the step before the
first. Forward only: the STBP backward comes with the training slice.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, registry
from repro_torch.kernels.common import check_rec_n, check_scan
from repro_torch.kernels.lifrec.ref import lifrec_scan_ref


def lifrec_cuda(current: torch.Tensor, w_rec: torch.Tensor,
                tau: torch.Tensor, v0: torch.Tensor, s0: torch.Tensor,
                v_th: float = 1.0):
    """Launch `csrc/lifrec.cu` on CUDA tensors."""
    check_scan("lifrec", current, w_rec, [("tau", tau)],
               [("v0", v0), ("s0", s0)])
    T, B, N = current.shape
    check_rec_n("lifrec", N)
    spikes = torch.empty_like(current)
    vT = torch.empty_like(v0)
    if T == 0:
        return spikes, vT.copy_(v0)
    if v0.numel() == 0:
        return spikes, vT
    with torch.cuda.device(current.device):
        code = _build.library().lifrec_f32(
            current.data_ptr(), w_rec.data_ptr(), tau.data_ptr(),
            v0.data_ptr(), s0.data_ptr(), spikes.data_ptr(), vT.data_ptr(),
            T, B, N, float(v_th), torch.cuda.current_stream().cuda_stream)
    _build.check("lifrec", code)
    lifrec_cuda.launches += 1
    return spikes, vT


def lifrec_scan(current: torch.Tensor, w_rec: torch.Tensor,
                tau: torch.Tensor, v0: torch.Tensor, s0: torch.Tensor,
                v_th: float = 1.0):
    """Fused recurrent LIF over time. current: (T,B,N); w_rec: (N,N);
    tau: (N,); v0/s0: (B,N).

    Returns (spikes (T,B,N), v_final (B,N))."""
    return registry.dispatch("lifrec", (current, w_rec, tau, v0, s0),
                             v_th=v_th)


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
    make_inputs=_make_inputs, tol=1e-4))

__all__ = ["lifrec_scan", "lifrec_cuda", "lifrec_scan_ref"]
