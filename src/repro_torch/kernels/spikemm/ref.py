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
