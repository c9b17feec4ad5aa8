"""Block-sparse spikemm channel: visit only the occupied spike blocks.

The port of `repro/kernels/spikemm/sparse.py`. The dense kernel
(`csrc/spikemm.cu`) already skips the product of a silent (64, 16) block,
but its grid still walks every block of the lattice. This channel goes
the rest of the way, as the paper's event-driven claim asks: silent work
is never issued.

  1. `occupancy_flags` marks the (bm, bk) spike blocks holding any
     event, at the kernel's block shape `SPARSE_BLOCK` (defined once, in
     `kernels/_build.py`, which compiles the kernel at it).
  2. `compact_blocks` turns that bitmap into a row-major compacted list
     of occupied (i, k) block coordinates, with one inactive sentinel per
     silent row block (the JAX package's list, entry for entry), and
     `block_list` into the kernel's work list (row offsets, k, active).
     Its count is data-dependent, so the compaction costs one host sync,
     as it does in eager JAX.
  3. `launch_block_list` launches `csrc/spikemm_sparse.cu` over that
     list: one CTA per (row block, N tile) walks its row block's entries
     in ascending k. `spikemm_sparse_cuda` is the counted wrapper around
     steps 1-3. A router that has already measured the flags hands them
     in (`flags=`), so they are reduced once per call.
  4. `spikemm_sparse_ref` is the plain version: drop the silent block
     rows and block columns, one matmul over the occupied slab, scatter
     the row blocks back (the JAX `_slab_matmul`).

Not ported: the JAX package pads the compacted list to its static
capacity, and the slab's index lists up a {1, 1.5} x 2^k ladder
(`_pad_count`), only so that a traced raster keeps a static shape under
`jit`. The port has no tracers, so both lists have exactly their length.
The threshold autotuner (`tune_sparse_threshold`) is not ported either:
its crossover was timed on the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import SPARSE_BLOCK
from repro_torch.kernels.common import check_matmul, pad_axis


def block_occupancy(spikes: torch.Tensor, bm: int, bk: int) -> torch.Tensor:
    """(ceil(M/bm), ceil(K/bk)) int32: 1 where the spike block has any
    nonzero. Ragged edges count as zero-padded blocks."""
    nz, _ = pad_axis(spikes != 0, 0, bm, value=False)
    nz, _ = pad_axis(nz, 1, bk, value=False)
    M, K = nz.shape
    return nz.reshape(M, K // bk, bk).any(-1).reshape(
        M // bm, bm, K // bk).any(1).to(torch.int32)


def occupancy_flags(spikes: torch.Tensor) -> torch.Tensor:
    """`block_occupancy` at the sparse kernel's block shape."""
    return block_occupancy(spikes, *SPARSE_BLOCK)


def compact_blocks(flags: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Compact an occupancy bitmap into (idx_i, idx_k, active) lists.

    flags: (Mb, Kb) int; returns three (n,) int32 tensors in row-major
    order, one entry per occupied block and one inactive sentinel
    (`active == 0`, `idx_k == 0`) per row block with none, so that every
    output row block is visited."""
    Mb, Kb = flags.shape
    occ = flags != 0
    aug = torch.cat([occ, ~occ.any(dim=1, keepdim=True)], dim=1)
    ii, cc = torch.nonzero(aug, as_tuple=True)        # row-major order
    active = cc < Kb
    kk = torch.where(active, cc, torch.zeros_like(cc))
    return (ii.to(torch.int32), kk.to(torch.int32), active.to(torch.int32))


def block_list(spikes: torch.Tensor, flags: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's work list for `spikes`: (row_ptr, idx_k, active).

    `flags` are `occupancy_flags(spikes)`, measured here when not given.
    row_ptr (ceil(M/bm) + 1,) int32 holds the offsets of each row block's
    entries in the row-major `compact_blocks` list, so a CTA finds its
    row block's entries without a search."""
    flags = occupancy_flags(spikes) if flags is None else flags
    ii, kk, act = compact_blocks(flags)
    row_ptr = torch.searchsorted(
        ii, torch.arange(flags.shape[0] + 1, dtype=torch.int32,
                         device=ii.device), out_int32=True)
    return row_ptr, kk, act


def launch_block_list(spikes: torch.Tensor, w: torch.Tensor,
                      blocks: Tuple[torch.Tensor, ...], out: torch.Tensor
                      ) -> torch.Tensor:
    """Launch `csrc/spikemm_sparse.cu` over `blocks` (a `block_list`) into
    `out` (M, N) on CUDA tensors with K > 0. Counts nothing: the counted
    call is `spikemm_sparse_cuda`."""
    row_ptr, kk, act = blocks
    M, K = spikes.shape
    with torch.cuda.device(spikes.device):
        code = _build.library().spikemm_sparse_f32(
            spikes.data_ptr(), w.data_ptr(), row_ptr.data_ptr(),
            kk.data_ptr(), act.data_ptr(), out.data_ptr(), M, K,
            w.shape[1], torch.cuda.current_stream().cuda_stream)
    _build.check("spikemm_sparse", code)
    return out


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


def spikemm_sparse_cuda(spikes: torch.Tensor, w: torch.Tensor,
                        flags: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Launch `csrc/spikemm_sparse.cu` on CUDA tensors. `flags` are
    `occupancy_flags(spikes)`, measured here when not given."""
    check_matmul("spikemm_sparse", spikes, w)
    M, K = spikes.shape
    out = torch.empty((M, w.shape[1]), dtype=torch.float32,
                      device=spikes.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    launch_block_list(spikes, w, block_list(spikes, flags), out)
    spikemm_sparse_cuda.launches += 1
    return out


spikemm_sparse_cuda.launches = 0


__all__ = ["block_list", "block_occupancy", "compact_blocks",
           "launch_block_list", "occupancy_flags", "spikemm_sparse_cuda",
           "spikemm_sparse_ref", "SPARSE_BLOCK"]
