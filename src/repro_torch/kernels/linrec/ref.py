"""Plain version of the DIFF recurrence  y_t = a_t * y_{t-1} + x_t."""

from __future__ import annotations

import torch


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
