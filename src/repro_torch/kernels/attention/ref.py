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


def _tile_range(q0: int, t_last: int, S: int, causal: bool, window: int,
                bk: int):
    """[j_lo, j_hi]: the KV tiles of `bk` keys a q tile of rows
    q0..t_last needs (all of them if one of its rows has no allowed
    key), as `csrc/flash_attention.cu` skips tiles."""
    nk = -(-S // bk)
    j_lo, j_hi = 0, nk - 1
    if not (window > 0 and t_last >= S + window - 1):
        if causal:
            j_hi = min(j_hi, t_last // bk)
        if window > 0 and q0 - window + 1 > 0:
            j_lo = (q0 - window + 1) // bk
    return j_lo, j_hi


def attention_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        nsplit: int, *, causal: bool = True, window: int = 0,
                        bq: int = 128, bk: int = 128) -> torch.Tensor:
    """Plain version of the tensor-core route's split over KV: the same
    function as `attention_ref`, computed as the split kernel and its
    combine compute it.

    Each q tile of `bq` rows cuts the KV tiles it needs into `nsplit`
    whole-tile chunks (split s takes tiles j_lo + s n / nsplit up to
    j_lo + (s + 1) n / nsplit, n the tile count; a chunk may be empty).
    Each split gives per row, in fp32 and log2 units, its max m (from
    -1e30), its sum l of 2^(s - m) and its unnormalised o; an allowed
    score is (q . k) d^-1/2 log2(e), a row with no allowed key scores
    -1e30 at every key, and the other masked keys weigh 0. The combine
    takes M = max m_s and o = sum_s o_s 2^(m_s - M) / max(sum_s l_s
    2^(m_s - M), 1e-30), in split order. Returns (BH, T, d) in q's
    dtype."""
    BH, T, d = q.shape
    S = k.shape[1]
    sc2 = d ** -0.5 * 1.4426950408889634
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.zeros((BH, T, d), dtype=torch.float32, device=q.device)
    if S == 0:
        return out.to(q.dtype)
    for q0 in range(0, T, bq):
        rows = torch.arange(q0, min(q0 + bq, T), device=q.device)
        t_last = int(rows[-1])
        none = (rows >= S + window - 1) if window > 0 else \
            torch.zeros_like(rows, dtype=torch.bool)
        j_lo, j_hi = _tile_range(q0, t_last, S, causal, window, bk)
        n = j_hi - j_lo + 1
        parts = []
        for sp in range(nsplit):
            a = (j_lo + sp * n // nsplit) * bk
            b = min((j_lo + (sp + 1) * n // nsplit) * bk, S)
            m = torch.full((BH, len(rows), 1), NEG_INF, device=q.device)
            if b <= a:
                parts.append((m, torch.zeros_like(m),
                              torch.zeros((BH, len(rows), d),
                                          device=q.device)))
                continue
            cols = torch.arange(a, b, device=q.device)
            s = torch.einsum("btd,bsd->bts", qf[:, q0:q0 + len(rows)],
                             kf[:, a:b]) * sc2
            dpos = rows[:, None] - cols[None, :]
            ok = torch.ones_like(dpos, dtype=torch.bool)
            if causal:
                ok &= dpos >= 0
            if window > 0:
                ok &= dpos < window
            masked = torch.where(none[:, None], torch.tensor(NEG_INF),
                                 torch.tensor(float("-inf")))
            s = torch.where(ok, s, masked.to(s.device))
            m = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp2(s - m)
            parts.append((m, p.sum(-1, keepdim=True),
                          torch.einsum("bts,bsd->btd", p, vf[:, a:b])))
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        L = torch.zeros_like(M)
        o = torch.zeros((BH, len(rows), d), device=q.device)
        for m, l_, o_ in parts:
            e = torch.exp2(m - M)
            L = L + l_ * e
            o = o + o_ * e
        out[:, q0:q0 + len(rows)] = o / L.clamp_min(1e-30)
    return out.to(q.dtype)
