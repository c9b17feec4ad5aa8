"""Block-sparse spikemm channel: visit only the occupied spike blocks.

The port of `repro/kernels/spikemm/sparse.py`. The dense kernel
(`csrc/spikemm.cu`) already skips the product of a silent (rows, 32) tile,
but its grid still walks every block of the lattice. This channel goes
the rest of the way, as the paper's event-driven claim asks: silent work
is never issued.

On CUDA tensors the channel is two launches of `csrc/spikemm_sparse.cu`,
with no host sync and no PyTorch op between them:

  1. `occupancy_cuda` measures the (bm, bk) spike blocks holding any
     event, at the kernel's block shape `SPARSE_BLOCK` (defined once, in
     `kernels/_build.py`, which compiles the kernel at it): the flags and
     their count, both on the card. `occupancy` runs it, or on CPU
     tensors `block_occupancy`, its plain version.
  2. The product: each CTA lists its block row's occupied k blocks in
     ascending k (`compact_blocks` row by row, the JAX package's list
     without its sentinels) and walks them; a block row with none writes
     zeros. `sparse_tile` sizes its CTAs.

`spikemm_sparse_cuda` is the counted wrapper around both; a router that
has already measured the flags hands them in (`flags=`) and only the
product launches. `spikemm_sparse_ref` is the plain version: drop the
silent block rows and block columns, one matmul over the occupied slab,
scatter the row blocks back (the JAX `_slab_matmul`).

Not ported: the JAX package pads the compacted list to its static
capacity, and the slab's index lists up a {1, 1.5} x 2^k ladder
(`_pad_count`), only so that a traced raster keeps a static shape under
`jit`. The port needs no list on the host at all. The threshold
autotuner (`tune_sparse_threshold`) is not ported either: its crossover
was timed on the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import SPARSE_BLOCK
from repro_torch.kernels.common import (check_matmul, check_raster,
                                        pad_axis, sm_count)
from repro_torch.kernels.registry import on_cuda


def block_occupancy(spikes: torch.Tensor, bm: int, bk: int) -> torch.Tensor:
    """(ceil(M/bm), ceil(K/bk)) int32: 1 where the spike block has any
    nonzero. Ragged edges count as zero-padded blocks."""
    nz, _ = pad_axis(spikes != 0, 0, bm, value=False)
    nz, _ = pad_axis(nz, 1, bk, value=False)
    M, K = nz.shape
    return nz.reshape(M, K // bk, bk).any(-1).reshape(
        M // bm, bm, K // bk).any(1).to(torch.int32)


def occupancy_cuda(spikes: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch `csrc/spikemm_sparse.cu`'s occupancy kernel on a CUDA raster:
    (flags, total), `block_occupancy(spikes, *SPARSE_BLOCK)` and its count
    as a (1,) int32, both left on the card. It has its own launch counter
    (`occupancy_cuda.launches`); it replaces no TPU kernel, so it is no
    registry family."""
    check_raster("spikemm_occupancy", spikes)
    M, K = spikes.shape
    bm, bk = SPARSE_BLOCK
    flags = torch.empty((-(-M // bm), -(-K // bk)), dtype=torch.int32,
                        device=spikes.device)
    total = torch.empty((1,), dtype=torch.int32, device=spikes.device)
    with torch.cuda.device(spikes.device):
        code = _build.library().spikemm_occupancy_f32(
            spikes.data_ptr(), flags.data_ptr(), total.data_ptr(), M, K,
            torch.cuda.current_stream().cuda_stream)
    _build.check("spikemm_occupancy", code)
    occupancy_cuda.launches += 1
    return flags, total


occupancy_cuda.launches = 0


def occupancy(spikes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(flags, total) of `spikes` at `SPARSE_BLOCK`: the kernel on a CUDA
    raster, `block_occupancy` and its sum on a CPU one."""
    if on_cuda((spikes,)):
        return occupancy_cuda(spikes)
    flags = block_occupancy(spikes, *SPARSE_BLOCK)
    return flags, flags.sum(dtype=torch.int32).reshape(1)


def occupancy_flags(spikes: torch.Tensor) -> torch.Tensor:
    """`block_occupancy` at the sparse kernel's block shape (on the card,
    by its occupancy kernel)."""
    return occupancy(spikes)[0]


def compact_blocks(flags: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compact an occupancy bitmap into (idx_i, idx_k, active) lists.

    flags: (Mb, Kb) int; returns three (n,) int32 tensors in row-major
    order, one entry per occupied block and one inactive sentinel
    (`active == 0`, `idx_k == 0`) per row block with none, so that every
    output row block is visited. Row i's active entries are the list a
    CTA of block row i builds in shared memory. The compile-time verifier
    (`repro_torch.analysis`, TB307) checks this table against the flags it
    compacts, on the CPU and on the card's own occupancy flags."""
    Mb, Kb = flags.shape
    occ = flags != 0
    aug = torch.cat([occ, ~occ.any(dim=1, keepdim=True)], dim=1)
    ii, cc = torch.nonzero(aug, as_tuple=True)        # row-major order
    active = cc < Kb
    kk = torch.where(active, cc, torch.zeros_like(cc))
    return (ii.to(torch.int32), kk.to(torch.int32), active.to(torch.int32))


# the square tiles a CTA of the product may own (T x T outputs)
SPARSE_TILES = (64, 16)


def sparse_tile(M: int, N: int, n_sm: int) -> int:
    """The tile T of a CTA of the product for an (M, N) output on a card
    of `n_sm` SMs: 64 (a thread 4 x 4) where the output holds a 64 x 64
    tile for every SM, else 16 (a thread one output), so that a narrow
    readout or few rows still spread over the card. Of the tiles of 16,
    32 and 64 rows and columns, these two were the fastest on an H100 at
    the sparse_integ path's calls (PERF.md): 64 x 64 at its hidden INTEG,
    16 x 16 at its readout."""
    return 64 if -(-M // 64) * -(-N // 64) >= n_sm else 16


def spikemm_sparse_ref(spikes: torch.Tensor, w: torch.Tensor,
                       flags: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: spikes (M, K) @ w (K, N) over the occupied slab.

    Block rows and block columns without an event anywhere are dropped
    before one matmul, at the sparse kernel's block shape; the skipped
    terms are exact zeros, so this is the dense product. `flags` are
    `occupancy_flags(spikes)`, measured here when not given."""
    bm, bk = SPARSE_BLOCK
    M, K = spikes.shape
    N = w.shape[1]
    s_p, _ = pad_axis(spikes, 0, bm)
    s_p, _ = pad_axis(s_p, 1, bk)
    w_p, _ = pad_axis(w.to(spikes.dtype), 0, bk)
    occ = (occupancy_flags(spikes) if flags is None else flags) != 0
    Mb, Kb = occ.shape
    rows = torch.nonzero(occ.any(dim=1)).flatten()
    cols = torch.nonzero(occ.any(dim=0)).flatten()
    out = torch.zeros((Mb, bm, N), dtype=spikes.dtype, device=spikes.device)
    if rows.numel():
        s_sel = s_p.reshape(Mb, bm, Kb, bk)[rows][:, :, cols]
        w_sel = w_p.reshape(Kb, bk, N)[cols]
        r, c = rows.numel(), cols.numel()
        prod = torch.matmul(s_sel.reshape(r * bm, c * bk),
                            w_sel.reshape(c * bk, N))
        out[rows] = prod.reshape(r, bm, N)
    return out.reshape(Mb * bm, N)[:M]


def launch_product(spikes: torch.Tensor, w: torch.Tensor,
                   flags: torch.Tensor, out: torch.Tensor,
                   tile: int) -> torch.Tensor:
    """Launch the product of `csrc/spikemm_sparse.cu` into `out` (M, N)
    on CTAs of `tile` x `tile` outputs (one of SPARSE_TILES; the C entry
    point refuses others), on CUDA tensors the wrapper has checked.
    Counts nothing: the counted call is `spikemm_sparse_cuda`."""
    M, K = spikes.shape
    with torch.cuda.device(spikes.device):
        code = _build.library().spikemm_sparse_f32(
            spikes.data_ptr(), w.data_ptr(), flags.data_ptr(),
            out.data_ptr(), M, K, w.shape[1], tile,
            torch.cuda.current_stream().cuda_stream)
    _build.check("spikemm_sparse", code)
    return out


def spikemm_sparse_cuda(spikes: torch.Tensor, w: torch.Tensor,
                        flags: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Launch `csrc/spikemm_sparse.cu` on CUDA tensors: the occupancy
    kernel (unless `flags`, `occupancy_flags(spikes)`, are handed in),
    then the product on `sparse_tile`'s CTAs. Nothing reads the card
    back; one counted launch."""
    check_matmul("spikemm_sparse", spikes, w)
    M, K = spikes.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=spikes.device)
    if out.numel() == 0:
        return out
    if flags is None:
        flags, _ = occupancy_cuda(spikes)
    bm, bk = SPARSE_BLOCK
    if (flags.dtype != torch.int32 or not flags.is_contiguous()
            or flags.device != spikes.device
            or tuple(flags.shape) != (-(-M // bm), -(-K // bk))):
        raise ValueError("spikemm_sparse: flags must be the raster's "
                         "contiguous int32 occupancy on its device")
    launch_product(spikes, w, flags, out,
                   sparse_tile(M, N, sm_count(spikes.device)))
    spikemm_sparse_cuda.launches += 1
    return out


spikemm_sparse_cuda.launches = 0


__all__ = ["block_occupancy", "compact_blocks", "launch_product",
           "occupancy", "occupancy_cuda", "occupancy_flags", "sparse_tile",
           "spikemm_sparse_cuda", "spikemm_sparse_ref", "SPARSE_BLOCK",
           "SPARSE_TILES"]
