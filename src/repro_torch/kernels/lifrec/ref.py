"""Plain version of the fused recurrent-LIF time scan (the SRNN hidden
layer, paper §V-B3):

    u_t = tau * v_{t-1} + c_t + s_{t-1} @ W_rec
    s_t = [u_t >= v_th]
    v_t = u_t * (1 - s_t)

`c` is the feed-forward current, hoisted out of the time loop by the plan
compiler (one all-T spikemm); only the self-term is serial.
"""

from __future__ import annotations

import torch


def recurrent_current(s: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """s (B, N) 0/1 spikes @ w (N, N) in a fixed order: starting from
    zeros, add s[:, i] * w[i] for i ascending.

    A silent i adds +-0, which changes nothing, so this is exactly what the
    kernels' event-driven loop computes: add w[i] for each spiking i in
    ascending order. A library matmul would sum in its own order and miss
    that by a rounding now and then."""
    rec = torch.zeros_like(s)
    for i in range(w.shape[0]):
        rec = rec + s[:, i, None] * w[i]
    return rec


def lifrec_scan_ref(current: torch.Tensor, w_rec: torch.Tensor,
                    tau: torch.Tensor, v0: torch.Tensor, s0: torch.Tensor,
                    v_th: float = 1.0):
    """current: (T, B, N); w_rec: (N, N); tau: (N,); v0, s0: (B, N).

    Returns (spikes (T, B, N), v_final (B, N)). fp32 state, the same
    rounded steps as `csrc/lifrec.cu`: u = ((tau * v) + c) + rec."""
    dt = current.dtype
    tau32 = tau.float()
    w32 = w_rec.float()
    c32 = current.float()
    v = v0.float()
    s = s0.float()
    spikes = []
    for t in range(current.shape[0]):
        u = tau32 * v + c32[t] + recurrent_current(s, w32)
        s = (u >= v_th).float()
        v = u * (1.0 - s)
        spikes.append(s.to(dt))
    out = torch.stack(spikes) if spikes else current.new_empty(current.shape)
    return out, v.to(dt)
