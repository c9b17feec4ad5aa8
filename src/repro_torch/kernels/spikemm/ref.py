"""Plain version of event-driven current accumulation: a dense matmul.

The event-driven semantics (only firing neurons contribute) is exactly what
a dense matmul with 0/1 spikes computes; the kernel's value is *skipping*
the silent blocks, which must not change the result.
"""

from __future__ import annotations

from typing import Optional

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


def shifted_raster(spikes: torch.Tensor, rows: int,
                   head: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The (rows, K) raster whose first rows are `head`'s and the rest
    `spikes`' first ones: [head; spikes[:rows - H]] (`spikes` alone where
    `head` is None). The recurrent g_W's raster [s0; s_0 .. s_{T-2}] is
    head = s0 and spikes = the (T * B, N) spikes plane."""
    if head is None:
        return spikes[:rows]
    return torch.cat([head.to(spikes.dtype), spikes[:rows - head.shape[0]]])


def spikemm_wgrad_ref(spikes: torch.Tensor, g: torch.Tensor,
                      head: Optional[torch.Tensor] = None) -> torch.Tensor:
    """spikemm's weight gradient g_w = raster^T @ g, the plain product:
    raster (R, K) as `shifted_raster` makes it from `spikes` (and `head`),
    g (R, N). The JAX package computes it as the spike product on the
    transposed raster, and so does this, on the plain version
    (`spikemm_ref`)."""
    raster = shifted_raster(spikes, g.shape[0], head)
    return spikemm_ref(raster.t().contiguous(), g)


def spikemm_wgrad_chain_ref(spikes: torch.Tensor, g: torch.Tensor,
                            chunk: int,
                            head: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """g_w as `csrc/spikemm_wgrad.cu` sums it, bit for bit on any device:
    the R rows cut into chunks of `chunk` rows, each chunk's partial
    `spikemm_chain_ref`'s chain over its rows in ascending order, from +0,
    and the partials added in ascending chunk order, one rounded add each
    (the first partial as it is). R = 0 gives zeros."""
    raster = shifted_raster(spikes, g.shape[0], head).float()
    gf = g.float()
    out = torch.zeros((raster.shape[1], gf.shape[1]), dtype=torch.float32,
                      device=gf.device)
    for c, r0 in enumerate(range(0, gf.shape[0], chunk)):
        part = spikemm_chain_ref(raster[r0:r0 + chunk].t(),
                                 gf[r0:r0 + chunk])
        out = part if c == 0 else out + part
    return out
