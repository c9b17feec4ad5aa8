"""Plain version of the fused recurrent-LIF time scan (the SRNN hidden
layer, paper §V-B3), and of its backward:

    u_t = tau * v_{t-1} + c_t + s_{t-1} @ W_rec
    s_t = [u_t >= v_th]
    v_t = u_t * (1 - s_t)

`c` is the feed-forward current, hoisted out of the time loop by the plan
compiler (one all-T spikemm); only the self-term is serial.

`scan_bwd_core` is the STBP adjoint shared by `lifrec`, `alif` and
`alifrec` (the JAX package's `_lifrec_bwd` and `_bwd_core`), in the
rounding order of their backward kernels (`csrc/rec_bwd.cu`,
`csrc/alif_bwd.cu`); `lif/ref.py::lif_scan_bwd_ref` sums over B in its
order too (`sum_rows_ascending`).
"""

from __future__ import annotations

from typing import Optional

import torch


def recurrent_current(s: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """s (B, N) 0/1 spikes @ w (N, N) in a fixed order: starting from
    zeros, add s[:, i] * w[i] for i ascending.

    A silent i adds +-0, which changes nothing, so this is exactly what the
    kernels' event-driven loop computes: add w[i] for each spiking i in
    ascending order; the loop skips the i silent in every row. A library
    matmul would sum in its own order and miss that by a rounding now and
    then."""
    rec = torch.zeros_like(s)
    for i in torch.nonzero(s.any(0)).flatten().tolist():
        rec = rec + s[:, i, None] * w[i]
    return rec


def sum_rows_ascending(x: torch.Tensor) -> torch.Tensor:
    """x (B, N) summed over B as ((x[0] + x[1]) + x[2]) + ..., one rounded
    add a row in ascending order: the order of `csrc/lane_bwd.cuh`'s
    in-kernel sums over B (`alif_bwd`, `lif_bwd`; zeros for B = 0)."""
    if x.shape[0] == 0:
        return torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    out = x[0]
    for b in range(1, x.shape[0]):
        out = out + x[b]
    return out


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


def recurrent_adjoint(gu: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """gu (B, N) @ w.T in a fixed order: starting from zeros, add
    gu[:, k] * w[:, k] for k ascending, each product and sum rounded, so
    rec[:, j] = sum_k gu[:, k] w[j, k] as `csrc/rec_bwd.cu` sums it."""
    w_t = w.t().contiguous()                 # w_t[k] = w[:, k]
    gu_t = gu.t().contiguous().unsqueeze(-1)   # gu_t[k] = gu[:, k, None]
    rec = torch.zeros_like(gu)
    term = torch.empty_like(gu)
    for k in range(w.shape[0]):
        torch.mul(gu_t[k], w_t[k], out=term)
        rec.add_(term)
    return rec


def scan_bwd_core(current: torch.Tensor, w_rec: Optional[torch.Tensor],
                  tau: torch.Tensor, rho: Optional[torch.Tensor],
                  v0: torch.Tensor, a0: Optional[torch.Tensor],
                  s0: Optional[torch.Tensor], spikes: torch.Tensor,
                  g_spikes: torch.Tensor, g_vT: torch.Tensor,
                  g_aT: Optional[torch.Tensor], v_th: float, beta: float,
                  surrogate: str, alpha: float, need_tau: bool = True,
                  need_rho: bool = True, need_v0: bool = True,
                  need_a0: bool = True, need_s0: bool = True,
                  sum_b=None):
    """The VJP of the hard-reset LIF scan with a surrogate spike gradient
    (STBP): recurrent where `w_rec` is given, adaptive (ALIF) where `rho`
    is. Returns (g_current, g_tau, g_rho, g_v0, g_a0, g_s0), None where the
    input is absent or its `need_*` is False. g_W is not computed here:
    it is the spike product sum_t s_{t-1}^T Gu_t (`ops.rec_g_w`).

    First the pre-reset membrane u_t (and a_{t-1}) is recomputed forward
    along the saved spikes with the forward's rounded steps, u =
    ((tau v) + c) + rec (nothing is re-thresholded). Then the reverse
    scan, with (Gv, Ga) the cotangents of (v_t, a_t) (g_vT, g_aT at
    T - 1), th = v_th (+ beta a_{t-1}) and g the surrogate at u - th:
      rec_t  = sum_k Gu_{t+1}[k] W[j, k]   (+0 at t = T - 1; recurrent)
      Gs~    = (gs_t [+ Ga]) [+ rec_t]
      Sig    = (Gs~ - Gv u) g;  Gu = Gv (1 - s) + Sig
      Gv    <- tau Gu;  Ga <- rho Ga - beta Sig
    g_current = Gu, g_v0 = Gv and g_a0 = Ga after t = 0, g_s0 = sum_k
    Gu_0[k] W[j, k]; g_tau sums Gu_t v_{t-1} and g_rho Ga_t a_{t-1} per
    lane in descending t, then over B with `sum_b` (default `.sum(0)`, the
    wrappers' of `rec_bwd.cu`; `alif` passes `sum_rows_ascending`, its
    kernel's). Every step is one rounded fp32 operation, the order of the
    kernels, which equal this bit for bit."""
    from repro_torch.core.surrogate import surrogate_grad

    adapt = rho is not None
    T = current.shape[0]
    tau32, c32, s32 = tau.float(), current.float(), spikes.float()
    rho32 = rho.float() if adapt else None
    w32 = None if w_rec is None else w_rec.float()
    v = v0.float()
    a = a0.float() if adapt else None
    s_prev = None if w32 is None else s0.float()
    us, v_prev, a_prev = [], [], []
    for t in range(T):
        v_prev.append(v)
        u = tau32 * v + c32[t]
        if w32 is not None:
            u = u + recurrent_current(s_prev, w32)
            s_prev = s32[t]
        us.append(u)
        if adapt:
            a_prev.append(a)
            a = rho32 * a + s32[t]
        v = u * (1.0 - s32[t])
    gs = g_spikes.float()
    gv = g_vT.float()
    ga = g_aT.float() if adapt else None
    g_tau = torch.zeros_like(gv)
    g_rho = torch.zeros_like(gv)
    gu_all = [None] * T
    gu = None
    for t in range(T - 1, -1, -1):
        gst = gs[t] + ga if adapt else gs[t]
        if w32 is not None:
            rec = (torch.zeros_like(gst) if gu is None
                   else recurrent_adjoint(gu, w32))
            gst = gst + rec
        th = v_th + beta * a_prev[t] if adapt else v_th
        g = surrogate_grad(us[t] - th, surrogate, alpha)
        sig = (gst - gv * us[t]) * g
        gu = gv * (1.0 - s32[t]) + sig
        gu_all[t] = gu
        g_tau = g_tau + gu * v_prev[t]
        if adapt:
            g_rho = g_rho + ga * a_prev[t]
            ga = rho32 * ga - beta * sig
        gv = tau32 * gu
    g_cur = (torch.stack(gu_all) if T else c32.new_empty(current.shape))
    g_s0 = None
    if w32 is not None and need_s0:
        g_s0 = (recurrent_adjoint(gu, w32) if T
                else torch.zeros_like(gv)).to(s0.dtype)
    sum_b = sum_b or (lambda x: x.sum(0))
    return (g_cur.to(current.dtype),
            sum_b(g_tau).to(tau.dtype) if need_tau else None,
            sum_b(g_rho).to(rho.dtype) if adapt and need_rho else None,
            gv.to(v0.dtype) if need_v0 else None,
            ga.to(a0.dtype) if adapt and need_a0 else None,
            g_s0)


def lifrec_scan_bwd_ref(current: torch.Tensor, w_rec: torch.Tensor,
                        tau: torch.Tensor, v0: torch.Tensor,
                        s0: torch.Tensor, spikes: torch.Tensor,
                        g_spikes: torch.Tensor, g_vT: torch.Tensor,
                        v_th: float = 1.0, surrogate: str = "rectangle",
                        alpha: float = 1.0, need_tau: bool = True,
                        need_v0: bool = True, need_s0: bool = True):
    """The VJP of `lifrec_scan_ref` but for g_W (`scan_bwd_core`):
    (g_current (T, B, N), g_tau (N,), g_v0 (B, N), g_s0 (B, N)), None
    where not needed."""
    g_cur, g_tau, _, g_v0, _, g_s0 = scan_bwd_core(
        current, w_rec, tau, None, v0, None, s0, spikes, g_spikes, g_vT,
        None, v_th, 0.0, surrogate, alpha, need_tau=need_tau,
        need_v0=need_v0, need_s0=need_s0)
    return g_cur, g_tau, g_v0, g_s0
