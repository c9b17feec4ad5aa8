"""Public spikemm entry: block occupancy + registry dispatch (dense channel).

`spikemm(spikes, w)` computes spikes (M, K) @ w (K, N). On CUDA tensors it
launches `csrc/spikemm.cu`, which skips every (BM, BK) spike block whose
occupancy flag is 0; the flags come from `block_occupancy` at the kernel's
own block shape (read from the built library). On CPU tensors it runs the
plain matmul.

Only the dense channel is ported. The JAX serve step runs under `jit`,
where a traced raster always routes dense, so dense is what the serving
path runs; the sparse channel and its occupancy router come with the
compressed-topology slice. Forward only: the straight-through gradient
comes with the training slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build, registry
from repro_torch.kernels.common import pad_axis
from repro_torch.kernels.spikemm.ref import spikemm_ref

_BLOCK: Optional[Tuple[int, int]] = None


def block_occupancy(spikes: torch.Tensor, bm: int, bk: int) -> torch.Tensor:
    """(ceil(M/bm), ceil(K/bk)) int32: 1 where the spike block has any
    nonzero. Ragged edges count as zero-padded blocks."""
    nz, _ = pad_axis(spikes != 0, 0, bm, value=False)
    nz, _ = pad_axis(nz, 1, bk, value=False)
    M, K = nz.shape
    return nz.reshape(M, K // bk, bk).any(-1).reshape(
        M // bm, bm, K // bk).any(1).to(torch.int32)


def kernel_block_shape() -> Tuple[int, int]:
    """(bm, bk): the occupancy block shape `csrc/spikemm.cu` skips at."""
    global _BLOCK
    if _BLOCK is None:
        lib = _build.library()
        _BLOCK = (lib.spikemm_block_m(), lib.spikemm_block_k())
    return _BLOCK


def _check(spikes: torch.Tensor, w: torch.Tensor) -> None:
    if not spikes.is_cuda:
        raise ValueError(f"spikemm: the CUDA kernel takes CUDA tensors, got "
                         f"{spikes.device}")
    if spikes.dim() != 2 or w.dim() != 2 or spikes.shape[1] != w.shape[0]:
        raise ValueError(f"spikemm: shapes {tuple(spikes.shape)} @ "
                         f"{tuple(w.shape)} do not chain")
    for nm, t in (("spikes", spikes), ("w", w)):
        if t.dtype != torch.float32:
            raise TypeError(f"spikemm: {nm} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"spikemm: {nm} must be contiguous")
    if spikes.device != w.device:
        raise ValueError(f"spikemm: spikes on {spikes.device}, "
                         f"w on {w.device}")


def spikemm_cuda(spikes: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch `csrc/spikemm.cu` on CUDA tensors."""
    _check(spikes, w)
    M, K = spikes.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=spikes.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    bm, bk = kernel_block_shape()
    flags = block_occupancy(spikes, bm, bk)
    with torch.cuda.device(spikes.device):
        code = _build.library().spikemm_f32(
            spikes.data_ptr(), w.data_ptr(), flags.data_ptr(), out.data_ptr(),
            M, K, N, torch.cuda.current_stream().cuda_stream)
    _build.check("spikemm", code)
    spikemm_cuda.launches += 1
    return out


def spikemm(spikes: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Event-gated spikes @ w. spikes: (M, K) 0/1; w: (K, N)."""
    return registry.dispatch("spikemm", (spikes, w))


def _make_inputs(generator: torch.Generator):
    M, K, N = 100, 300, 200                   # ragged against every block
    spikes = (torch.rand((M, K), generator=generator) < 0.13).float()
    w = torch.randn((K, N), generator=generator)
    return spikes, w


registry.register(registry.KernelSpec(
    name="spikemm", plain=spikemm_ref, cuda=spikemm_cuda,
    make_inputs=_make_inputs, tol=1e-4))

__all__ = ["spikemm", "spikemm_cuda", "spikemm_ref", "block_occupancy",
           "kernel_block_shape"]
