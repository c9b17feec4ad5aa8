"""Plain version of the DIFF recurrence  y_t = a_t * y_{t-1} + x_t."""

from __future__ import annotations

import torch

from repro_torch.kernels.lifrec.ref import sum_rows_ascending


def linrec_ref(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor):
    """Sequential fold over axis 0. x: (T, ...); a broadcastable to x;
    h0: x.shape[1:]. Returns (y (T, ...), h_final (...)). fp32 state.

    Each step is a rounded product then a rounded sum, the same arithmetic
    as `csrc/linrec.cu`, so the two agree bit for bit."""
    dt = x.dtype
    a = a.float().expand(x.shape)
    x32 = x.float()
    h = h0.float()
    ys = []
    for t in range(x.shape[0]):
        h = a[t] * h + x32[t]
        ys.append(h)
    y = torch.stack(ys) if ys else x32.new_empty(x.shape)
    return y.to(dt), h.to(dt)


# The JAX package's sequential-scan oracle (its `linrec_ref` is an
# associative scan); here the plain version already is that fold.
linrec_naive = linrec_ref


def lanes_decay(a: torch.Tensor, D: int) -> bool:
    """Whether the decay `a` is one value a lane for every step and row: a
    (D,) tensor, or (1, D) or (1, 1, D). Its gradient is then summed over
    T and B by the backward itself (`csrc/linrec_bwd.cu`'s GA_SUM) and
    comes back in a's shape."""
    return (1 <= a.dim() <= 3 and a.shape[-1] == D
            and all(n == 1 for n in a.shape[:-1]))


def linrec_bwd_ref(a: torch.Tensor, y: torch.Tensor, h0: torch.Tensor,
                   g_y: torch.Tensor, g_hT, need_a: bool = True,
                   need_h0: bool = True):
    """The VJP of `linrec_ref`: (g_a, g_x, g_h0) from the decay, the
    forward's output y (T, B, D), h0 and the cotangents of (y, h_final).

      gy_{T-1} += g_hT
      gx_t = a_{t+1} gx_{t+1} + gy_t   (t = T-1 ... 0, a_T = 0, from 0)
      ga_t = gx_t y_{t-1}              (y_{-1} = h0)
      gh0  = gx_0 a_0

    g_y is (T, B, D), or (T, B, N) with D = K N, the cotangent of a sum
    over K branches: lane (b, k N + n) takes g_y[t, b, n]. g_hT (B, D) may
    be None (zero). Each gx step is a rounded product then a rounded sum,
    so this equals `csrc/linrec_bwd.cu` bit for bit, and equals the
    forward recurrence run on the time-reversed, one-shifted decay. g_a
    comes back in x's shape, or where `lanes_decay(a)` in a's own: each
    lane's ga_t summed in descending t from +0, then those partials over B
    in ascending b (`sum_rows_ascending`), the kernel's order. None where
    `need_a` / `need_h0` is false."""
    T, B, D = y.shape
    dt = y.dtype
    a32 = a.float().expand(y.shape)
    N = g_y.shape[-1]
    gy = g_y.float()
    if N != D:
        gy = gy[:, :, None, :].expand(T, B, D // N, N).reshape(T, B, D)
    g_last = (torch.zeros((B, D), dtype=torch.float32, device=y.device)
              if g_hT is None else g_hT.float())
    gx = torch.zeros_like(h0, dtype=torch.float32)
    a_next = torch.zeros_like(gx)
    gxs = [None] * T
    for t in range(T - 1, -1, -1):
        g = gy[t] + g_last if t == T - 1 else gy[t]
        gx = a_next * gx + g
        gxs[t] = gx
        a_next = a32[t]
    g_x = torch.stack(gxs) if T else y.float().new_empty(y.shape)
    g_a = g_h0 = None
    if need_a:
        y_prev = torch.cat([h0.float()[None], y.float()[:-1]]) if T else g_x
        terms = g_x * y_prev
        if lanes_decay(a, D):
            acc = torch.zeros((B, D), dtype=torch.float32, device=y.device)
            for t in range(T - 1, -1, -1):
                acc = acc + terms[t]
            g_a = sum_rows_ascending(acc).reshape(a.shape).to(a.dtype)
        else:
            g_a = terms.to(dt)
    if need_h0:
        g_h0 = (gx * a32[0] if T else g_last).to(h0.dtype)
    return g_a, g_x.to(dt), g_h0
