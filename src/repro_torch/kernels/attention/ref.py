"""Plain version: dense softmax attention (single head-batch layout)."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (BH, T, d); k, v: (BH, S, d). Returns (BH, T, d) in q's dtype.

    Scores in fp32, scaled by d^-1/2 after the product; (t, s) is allowed
    when t - s >= 0 (causal) and t - s < window (window > 0), positions
    counted from 0 on both axes; the rest are set to -1e30 before the
    softmax, so a row with no allowed key averages v."""
    T, S = q.shape[1], k.shape[1]
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("btd,bsd->bts", q.float(), k.float()) * scale
    if causal or window > 0:
        dpos = (torch.arange(T, device=q.device)[:, None]
                - torch.arange(S, device=q.device)[None, :])
        ok = torch.ones((T, S), dtype=torch.bool, device=q.device)
        if causal:
            ok &= dpos >= 0
        if window > 0:
            ok &= dpos < window
        s.masked_fill_(~ok, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bts,bsd->btd", p, v.float()).to(q.dtype)
