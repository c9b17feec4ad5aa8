"""Public fused-LIF entry point, dispatched via the registry.

`lif_scan(current, tau, v0, v_th, reset)` runs the serial-in-time LIF over
(T, B, N): `csrc/lif.cu` on CUDA tensors, the plain scan on CPU tensors.
Both the zero and the subtract reset are supported. Forward only: the
surrogate-gradient backward comes with the training slice.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, registry
from repro_torch.kernels.common import check_scan, lane_plan, sm_count
from repro_torch.kernels.lif.ref import lif_scan_ref


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


def lif_scan(current: torch.Tensor, tau: torch.Tensor, v0: torch.Tensor,
             v_th: float = 1.0, reset: str = "zero"):
    """Fused LIF over time. current: (T,B,N); tau: (N,); v0: (B,N).

    Returns (spikes (T,B,N), v_final (B,N))."""
    return registry.dispatch("lif", (current, tau, v0), v_th=v_th,
                             reset=reset)


def _make_inputs(generator: torch.Generator):
    T, B, N = 20, 3, 130
    current = 0.6 * torch.randn((T, B, N), generator=generator)
    tau = 0.7 + 0.28 * torch.rand((N,), generator=generator)
    v0 = torch.zeros((B, N))
    return current, tau, v0


registry.register(registry.KernelSpec(
    name="lif", plain=lif_scan_ref, cuda=lif_cuda,
    make_inputs=_make_inputs, tol=1e-4))

__all__ = ["lif_scan", "lif_cuda", "lif_scan_ref"]
