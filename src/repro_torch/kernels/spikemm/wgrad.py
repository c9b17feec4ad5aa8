"""B3: spikemm's weight gradient g_w = raster^T g on a kernel of its own.

`spikemm_wgrad_cuda(spikes, g, head=None)` launches
`csrc/spikemm_wgrad.cu` on CUDA tensors: one launch, no host read, the
raster (R, K) and g (R, N) read in their own layouts (the raster's first
rows from `head` where given: the recurrent g_W's shifted raster). The
reduction over R is split into chunks of `wgrad_chunk(R, K, N)` rows, a
function of the shapes alone, so the result's bits do not depend on the
card; `spikemm_wgrad_chain_ref` (`ref.py`) is the same sum in plain
PyTorch. On CPU tensors the backward runs the plain product
`spikemm_wgrad_ref`. It is spikemm's `bwd` pair in the registry, counted
as `spikemm_wgrad`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

WGRAD_THREADS = 256    # threads a CTA
WGRAD_SUB = 16         # rows of a chunk a step of the ring; a chunk's multiple
# CTAs small products aim at: about as many clusters of 8 as the H100's
# GPCs hold at once (128 CTAs ran in two waves there)
WGRAD_CTAS = 64
WGRAD_MAX_CLUSTER = 8  # a tile's CTAs: one (portable) thread block cluster
# the output rows of a group's tile allowed at each column count: a group
# of whole warps, 4 rows x (4 at 64 columns, else 2) columns a thread
WGRAD_TILE_ROWS = {8: (32, 64), 16: (16, 32, 64), 32: (8, 16, 32, 64),
                   64: (8, 16, 32, 64), 128: (32, 64)}


def wgrad_groups(bm: int, cw: int) -> int:
    """Groups of threads a CTA of `csrc/spikemm_wgrad.cu` holds at a
    (bm, cw) tile, each walking a chunk of its own."""
    cpt = 2 if cw <= 32 else cw // 16
    return WGRAD_THREADS // ((cw // cpt) * (bm // 4))


def wgrad_tile(K: int, N: int) -> Tuple[int, int, int]:
    """(output rows, columns, CTAs of the cluster) of the kernel's tile for
    a (K, N) output, a cluster of WGRAD_MAX_CLUSTER CTAs a tile. Over 64
    rows, 64-row tiles (a group walking its events) of the least of 8,
    16, 32, 64, 128 columns that covers N (128 above). Else, of the
    allowed
    tiles no larger than covers (K, N), the largest whose tiles make
    WGRAD_CTAS CTAs, or the one with the most tiles (the larger columns on
    a tie): small products spread over more SMs, each streaming less."""
    cws = tuple(WGRAD_TILE_ROWS)
    cw_max = next((c for c in cws if N <= c), cws[-1])
    if K > 64:
        return 64, cw_max, WGRAD_MAX_CLUSTER

    def tiles(bm, cw):
        return -(-K // bm) * -(-N // cw)
    cands = []
    for cw in (c for c in cws if c <= cw_max):
        rows = WGRAD_TILE_ROWS[cw]
        cover = next((b for b in rows if b >= K), rows[-1])
        cands += [(bm, cw) for bm in rows if bm <= cover]
    wave = [c for c in cands
            if tiles(*c) * WGRAD_MAX_CLUSTER >= WGRAD_CTAS]
    if wave:
        bm, cw = max(wave, key=lambda c: (c[0] * c[1], c[1]))
    else:
        bm, cw = max(cands, key=lambda c: (tiles(*c), c[1]))
    return bm, cw, WGRAD_MAX_CLUSTER


def wgrad_tiles(K: int, N: int) -> Tuple[int, int]:
    """(output tiles along k, along n) of the kernel's grid."""
    bm, cw, _ = wgrad_tile(K, N)
    return -(-K // bm), -(-N // cw)


def wgrad_chunk(R: int, K: int, N: int) -> int:
    """Rows of a chunk of the split reduction, a multiple of WGRAD_SUB: the
    rows cut into one chunk a group of the tile's cluster (cluster x
    groups chunks). A function of the shapes alone, never of the card:
    the same inputs give the same bits on any card."""
    bm, cw, cluster = wgrad_tile(K, N)
    rows = -(-R // (cluster * wgrad_groups(bm, cw)))
    return max(WGRAD_SUB, -(-rows // WGRAD_SUB) * WGRAD_SUB)


def wgrad_chunks(R: int, K: int, N: int) -> int:
    """How many chunks `wgrad_chunk` cuts R rows into (1 for R = 0)."""
    return max(1, -(-R // wgrad_chunk(R, K, N)))


def _check(spikes: torch.Tensor, g: torch.Tensor,
           head: Optional[torch.Tensor]) -> None:
    for name, t in (("spikes", spikes), ("g", g), ("head", head)):
        if t is None:
            continue
        if not t.is_cuda:
            raise ValueError(f"spikemm_wgrad: the CUDA kernel takes CUDA "
                             f"tensors, got {name} on {t.device}")
        if t.dim() != 2:
            raise ValueError(f"spikemm_wgrad: {name} must be 2-D, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"spikemm_wgrad: {name} must be float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"spikemm_wgrad: {name} must be contiguous")
        if t.device != g.device:
            raise ValueError(f"spikemm_wgrad: {name} on {t.device}, g on "
                             f"{g.device}")
    H = 0 if head is None else head.shape[0]
    R, K = g.shape[0], spikes.shape[1]
    if (head is not None and head.shape[1] != K) or H > R \
            or spikes.shape[0] < R - H:
        raise ValueError(f"spikemm_wgrad: a raster of {R} rows from head "
                         f"{None if head is None else tuple(head.shape)} and "
                         f"spikes {tuple(spikes.shape)} does not chain with "
                         f"g {tuple(g.shape)}")


def spikemm_wgrad_cuda(spikes: torch.Tensor, g: torch.Tensor,
                       head: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch `csrc/spikemm_wgrad.cu` on CUDA tensors: g_w (K, N) =
    raster^T g, the raster's R = g.shape[0] rows being `head`'s, then
    `spikes`' first R - H. One launch (K = 0 or N = 0: none), no host
    read; `spikemm_wgrad_chain_ref` bit for bit."""
    _check(spikes, g, head)
    R, N = g.shape
    K = spikes.shape[1]
    out = torch.empty((K, N), dtype=torch.float32, device=g.device)
    if out.numel() == 0:
        return out
    chunks = wgrad_chunks(R, K, N)
    part = (torch.empty((chunks, K, N), dtype=torch.float32, device=g.device)
            if chunks > 1 else None)
    with torch.cuda.device(g.device):
        code = _build.library().spikemm_wgrad_f32(
            None if head is None else head.data_ptr(),
            0 if head is None else head.shape[0], spikes.data_ptr(),
            g.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), R, K, N,
            wgrad_chunk(R, K, N), *wgrad_tile(K, N),
            torch.cuda.current_stream().cuda_stream)
    _build.check("spikemm_wgrad", code)
    spikemm_wgrad_cuda.launches += 1
    return out


__all__ = ["spikemm_wgrad_cuda", "wgrad_tile", "wgrad_tiles", "wgrad_groups",
           "wgrad_chunk", "wgrad_chunks", "WGRAD_CTAS", "WGRAD_SUB",
           "WGRAD_MAX_CLUSTER", "WGRAD_THREADS", "WGRAD_TILE_ROWS"]
