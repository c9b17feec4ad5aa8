"""Plain version of the fused LIF time scan (paper eqs. (1)-(3))."""

from __future__ import annotations

import torch

from repro_torch.kernels.lifrec.ref import sum_rows_ascending


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


def lif_scan_bwd_ref(current: torch.Tensor, tau: torch.Tensor,
                     v0: torch.Tensor, spikes: torch.Tensor,
                     g_spikes: torch.Tensor, g_vT: torch.Tensor,
                     v_th: float = 1.0, surrogate: str = "rectangle",
                     alpha: float = 1.0, reset: str = "zero",
                     need_tau: bool = True, need_v0: bool = True):
    """The VJP of `lif_scan_ref` with a surrogate spike gradient (STBP):
    (g_current (T, B, N), g_tau (N,), g_v0 (B, N)) from the forward's
    inputs, its spikes and the cotangents of (spikes, v_final); g_tau and
    g_v0 None where not needed.

    First the pre-reset membrane u_t = tau * v_{t-1} + I_t is recomputed
    forward along the saved spikes (their resets; nothing is
    re-thresholded), then the reverse scan, with g the surrogate at
    u_t - v_th and Gv the membrane's cotangent (Gv_{T-1} = g_vT):
      zero:     Gu = Gv (1 - s) + (Gs - Gv u) g
      subtract: Gu = Gv (1 - v_th g) + Gs g
      Gv_{t-1} = tau Gu_t
    g_current = Gu, g_v0 = tau Gu_0 and g_tau = sum over (t, b) of
    Gu_t v_{t-1}, summed per lane in descending t (`lif_scan_bwd_partials`)
    and then over B in ascending b (`sum_rows_ascending`): the order of
    `csrc/lif_bwd.cu`, which equals this one bit for bit (every step is
    one rounded fp32 operation)."""
    g_cur, part, g_v0 = lif_scan_bwd_partials(
        current, tau, v0, spikes, g_spikes, g_vT, v_th, surrogate, alpha,
        reset)
    return (g_cur, sum_rows_ascending(part).to(tau.dtype) if need_tau
            else None, g_v0 if need_v0 else None)


def lif_scan_bwd_partials(current: torch.Tensor, tau: torch.Tensor,
                          v0: torch.Tensor, spikes: torch.Tensor,
                          g_spikes: torch.Tensor, g_vT: torch.Tensor,
                          v_th: float = 1.0, surrogate: str = "rectangle",
                          alpha: float = 1.0, reset: str = "zero"):
    """`lif_scan_bwd_ref`'s reverse scan: (g_current (T, B, N), the
    per-lane g_tau partials (B, N) in fp32, g_v0 (B, N)); the partial of
    lane (b, n) is sum over t of Gu_t v_{t-1}, in descending t."""
    from repro_torch.core.surrogate import surrogate_grad

    if reset not in ("zero", "subtract"):
        raise ValueError(f"lif: reset must be 'zero' or 'subtract', "
                         f"got {reset!r}")
    T = current.shape[0]
    tau32, c32, s32 = tau.float(), current.float(), spikes.float()
    v = v0.float()
    us, v_prev = [], []
    for t in range(T):
        v_prev.append(v)
        u = tau32 * v + c32[t]
        us.append(u)
        v = u - v_th * s32[t] if reset == "subtract" else u * (1.0 - s32[t])
    gs = g_spikes.float()
    gv = g_vT.float()
    g_tau = torch.zeros_like(v)
    gu_all = [None] * T
    for t in range(T - 1, -1, -1):
        g = surrogate_grad(us[t] - v_th, surrogate, alpha)
        if reset == "subtract":
            gu = gv * (1.0 - v_th * g) + gs[t] * g
        else:
            gu = gv * (1.0 - s32[t]) + (gs[t] - gv * us[t]) * g
        gu_all[t] = gu
        g_tau = g_tau + gu * v_prev[t]
        gv = tau32 * gu
    g_cur = (torch.stack(gu_all) if T else c32.new_empty(current.shape))
    return g_cur.to(current.dtype), g_tau, gv.to(v0.dtype)
