"""Plain version of the fused LIF time scan (paper eqs. (1)-(3))."""

from __future__ import annotations

import torch


def lif_scan_ref(current: torch.Tensor, tau: torch.Tensor,
                 v0: torch.Tensor, v_th: float = 1.0, reset: str = "zero"):
    """current: (T, B, N); tau: (N,) per-neuron decay; v0: (B, N).

    v_t = tau * v_{t-1} + I_t;  s_t = [v_t >= v_th];  then the reset:
    "zero"     v_t <- v_t * (1 - s_t)   (hard reset, eq. (3))
    "subtract" v_t <- v_t - v_th * s_t  (soft reset: keep the residue)
    Returns (spikes (T, B, N), v_final (B, N)). fp32 state, the same
    rounded steps as `csrc/lif.cu`.
    """
    if reset not in ("zero", "subtract"):
        raise ValueError(f"lif: reset must be 'zero' or 'subtract', "
                         f"got {reset!r}")
    dt = current.dtype
    tau32 = tau.float()
    c32 = current.float()
    v = v0.float()
    spikes = []
    for t in range(current.shape[0]):
        v = tau32 * v + c32[t]
        s = (v >= v_th).float()
        v = v - v_th * s if reset == "subtract" else v * (1.0 - s)
        spikes.append(s.to(dt))
    out = torch.stack(spikes) if spikes else current.new_empty(current.shape)
    return out, v.to(dt)
