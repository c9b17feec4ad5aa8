"""Plain versions of the fused adaptive-threshold LIF time scans.

ALIF (Yin et al. 2021, the paper's ECG SRNN hidden layer) extends LIF with
a spike-driven adaptation trace that raises the effective threshold:

    u_t  = tau * v_{t-1} + c_t  [+ s_{t-1} @ W_rec]
    th_t = v_th + beta * a_{t-1}
    s_t  = [u_t >= th_t]
    v_t  = u_t * (1 - s_t)
    a_t  = rho * a_{t-1} + s_t

`alif_scan_ref` is the feed-forward family (`alif`), `alifrec_scan_ref`
the self-recurrent one (`alifrec`). Every step is a rounded product or
sum in the order written, the arithmetic of `csrc/alifrec.cu`; the
recurrent term is `lifrec.ref.recurrent_current`'s fixed-order sum.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.lifrec.ref import recurrent_current


def _scan(current: torch.Tensor, w_rec: Optional[torch.Tensor],
          tau: torch.Tensor, rho: torch.Tensor, v0: torch.Tensor,
          a0: torch.Tensor, s0: Optional[torch.Tensor], v_th: float,
          beta: float):
    dt = current.dtype
    tau32 = tau.float()
    rho32 = rho.float()
    w32 = None if w_rec is None else w_rec.float()
    c32 = current.float()
    v = v0.float()
    a = a0.float()
    s = None if s0 is None else s0.float()
    spikes = []
    for t in range(current.shape[0]):
        u = tau32 * v + c32[t]
        if w32 is not None:
            u = u + recurrent_current(s, w32)
        s = (u >= v_th + beta * a).float()
        v = u * (1.0 - s)
        a = rho32 * a + s
        spikes.append(s.to(dt))
    out = torch.stack(spikes) if spikes else current.new_empty(current.shape)
    return out, v.to(dt), a.to(dt)


def alif_scan_ref(current: torch.Tensor, tau: torch.Tensor,
                  rho: torch.Tensor, v0: torch.Tensor, a0: torch.Tensor,
                  v_th: float = 1.0, beta: float = 1.8):
    """current: (T, B, N); tau, rho: (N,); v0, a0: (B, N).

    Returns (spikes (T, B, N), v_final (B, N), a_final (B, N))."""
    return _scan(current, None, tau, rho, v0, a0, None, v_th, beta)


def alifrec_scan_ref(current: torch.Tensor, w_rec: torch.Tensor,
                     tau: torch.Tensor, rho: torch.Tensor, v0: torch.Tensor,
                     a0: torch.Tensor, s0: torch.Tensor, v_th: float = 1.0,
                     beta: float = 1.8):
    """current: (T, B, N); w_rec: (N, N); tau, rho: (N,); v0/a0/s0: (B, N).

    Returns (spikes (T, B, N), v_final (B, N), a_final (B, N))."""
    return _scan(current, w_rec, tau, rho, v0, a0, s0, v_th, beta)
