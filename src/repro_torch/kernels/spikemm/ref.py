"""Plain version of event-driven current accumulation: a dense matmul.

The event-driven semantics (only firing neurons contribute) is exactly what
a dense matmul with 0/1 spikes computes; the kernel's value is *skipping*
the silent blocks, which must not change the result.
"""

from __future__ import annotations

import torch


def spikemm_ref(spikes: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """spikes: (M, K) 0/1 (any float dtype); w: (K, N). fp32 accumulate."""
    return torch.matmul(spikes.float(), w.float()).to(spikes.dtype)


def spikemm_chain_ref(spikes: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """spikes (M, K) @ w (K, N) as the CUDA kernel sums it: per output
    element the chain acc = acc + s[m, k] w[k, n] over k = 0..K-1 in
    ascending order, from +0, in fp32. For 0/1 spikes each product is
    exact, so every step rounds once, as the kernel's fmaf does, and the
    result equals the kernel's bit for bit on any device (the zero terms
    leave acc as it is, which is why the kernel may skip them)."""
    s, wf = spikes.float(), w.float()
    acc = torch.zeros((s.shape[0], wf.shape[1]), dtype=torch.float32,
                      device=s.device)
    for k in range(s.shape[1]):
        acc = acc + s[:, k, None] * wf[k]
    return acc
