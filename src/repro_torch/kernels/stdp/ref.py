"""Plain versions of the STDP weight updates.

`stdp_update_ref` — one pair-STDP step on precomputed traces:
    w' = clip((w + a_plus * x_pre^T s_post) - a_minus * s_pre^T x_post)
`stdp_seq_ref` — K signed outer-product term planes over T serial steps:
    w <- clip(w + sum_k amp_k * P_k[t]^T Q_k[t]) for t = 0 .. T-1
(the clip makes the recurrence non-associative, hence the serial loop).
`stdp_seq_sessions_ref` — the same with a session axis: S weights, session
s taking row t * S + s of each plane at step t (`stdp_seq_ref` at batch 1
on its rows, a session at a time).

All are loops in the kernels' order (`csrc/stdp.cu`; the session axis
`csrc/stdp_sessions.cu`): every outer product is summed from zeros over
the batch rows b ascending, one rounded product and one rounded sum per
row; the terms of a step are summed from zeros as dw + amp_k * s_k over k
ascending. So the card matches them bit for bit (the session kernel
drops the sum 0 + p q of its one row, which its header shows leaves
every bit as it was). Traces and spikes may be fp32 or bf16 (upcast exactly); the
weight is fp32 and the output has its dtype. Nothing is written in place:
the result is a new tensor, never the input w.
"""

from __future__ import annotations

import torch


def outer_sum(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """sum_b p[b]^T q[b] for p (B, M), q (B, N) fp32, summed from zeros
    over b ascending."""
    s = p.new_zeros((p.shape[1], q.shape[1]))
    for b in range(p.shape[0]):
        s = s + p[b, :, None] * q[b, None, :]
    return s


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as the fp32 scalar the kernel receives."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def stdp_update_ref(x_pre, s_post, s_pre, x_post, w, *, a_plus, a_minus,
                    w_min, w_max):
    """x_pre/s_pre: (B, M); s_post/x_post: (B, N); w: (M, N)."""
    pot = outer_sum(x_pre.float(), s_post.float())
    dep = outer_sum(s_pre.float(), x_post.float())
    w1 = (w.float() + _f32(a_plus, w) * pot) - _f32(a_minus, w) * dep
    return torch.clamp(w1, w_min, w_max).to(w.dtype)


def stdp_seq_ref(P, Q, w, *, amps, w_min, w_max, batch):
    """P: (K, T*B, M) pre-side term planes; Q: (K, T*B, N) post-side
    planes; w: (M, N); amps: K floats; batch: B."""
    K, TB, _ = P.shape
    P32, Q32 = P.float(), Q.float()
    amp = [_f32(a, w) for a in amps]
    w32 = w.float()
    for t in range(TB // batch):
        rows = slice(t * batch, (t + 1) * batch)
        dw = torch.zeros_like(w32)
        for k in range(K):
            dw = dw + amp[k] * outer_sum(P32[k, rows], Q32[k, rows])
        w32 = torch.clamp(w32 + dw, w_min, w_max)
    return w32.to(w.dtype)


def stdp_seq_sessions_ref(P, Q, w, *, amps, w_min, w_max):
    """P: (K, T*S, M); Q: (K, T*S, N); w: (S, M, N): `stdp_seq_ref` at
    batch 1 on each session's rows (every S-th, from s) and weight."""
    S = w.shape[0]
    return torch.stack([
        stdp_seq_ref(P[:, s::S], Q[:, s::S], w[s], amps=amps, w_min=w_min,
                     w_max=w_max, batch=1) for s in range(S)])
