"""Flash attention public entry: registry dispatch and a straight-through
VJP.

`flash_attention(q, k, v, causal=, window=)` takes q (BH, T, d) and k, v
(BH, S, d) with heads folded into the batch. CUDA tensors launch
`csrc/flash_attention.cu` (fp32 or bf16, 1 <= d <= 256), CPU tensors run
the plain version `attention_ref`. The kernel is forward-only, as the
JAX package's is: `_FlashST` launches it in its forward and, in its
backward, differentiates the plain version, a straight-through gradient
that is exact because the forward equals it. A backward hand kernel is
the training slice's work.

The JAX entry's `bq`, `bk` and `force_pallas` are not ported: the first
two are VMEM block choices of the TPU kernel, the third a switch of its
dispatch chain, and the port dispatches by tensor device alone. Its
wrapper also zero-pads K/V up to the block, which lets padded keys into
the softmax of causal rows t >= S; the CUDA kernel masks ragged edges
itself and pads nothing.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, registry
from repro_torch.kernels.attention.ref import attention_ref

MAX_HEAD_DIM = 256          # the largest d `csrc/flash_attention.cu` takes
_TYPES = (torch.float32, torch.bfloat16)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int) -> torch.Tensor:
    """Check the arguments and launch the kernel on PyTorch's current
    stream; counts the launch on `flash_attention_cuda`."""
    if q.dim() != 3 or k.dim() != 3 or tuple(k.shape) != tuple(v.shape) \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not "
                         "chain: q (BH, T, d), k and v (BH, S, d)")
    BH, T, d = q.shape
    S = k.shape[1]
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} outside 1.."
                         f"{MAX_HEAD_DIM}")
    for nm, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.dtype not in _TYPES:
            raise TypeError(f"flash_attention: q, k and v must share one "
                            f"dtype of {_TYPES}, got {nm} {t.dtype} "
                            f"(q {q.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {nm} must be contiguous")
    if not q.is_cuda:
        raise ValueError(f"flash_attention: the CUDA kernel takes CUDA "
                         f"tensors, got {q.device}")
    for nm, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {nm} on {t.device}, q on "
                             f"{q.device}")
    if max(BH, T, S, abs(int(window))) >= 2 ** 31:
        raise ValueError(f"flash_attention: (BH, T, S, window) = "
                         f"{(BH, T, S, window)} exceeds the kernel's int32 "
                         "sizes")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.library()
    fn = (lib.flash_attention_f32 if q.dtype == torch.float32
          else lib.flash_attention_bf16)
    with torch.cuda.device(q.device):
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  BH, T, S, d, int(bool(causal)), int(window),
                  float(d ** -0.5), torch.cuda.current_stream().cuda_stream)
    _build.check("flash_attention", code)
    flash_attention_cuda.launches += 1
    return out


class _FlashST(torch.autograd.Function):
    """The kernel forward with the plain version's VJP."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _launch(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            args = [t.detach().requires_grad_(n)
                    for t, n in zip(ctx.saved_tensors, need)]
            out = attention_ref(*args, causal=ctx.causal, window=ctx.window)
            wrt = [a for a, n in zip(args, need) if n]
            grads = iter(torch.autograd.grad(out, wrt, g))
        return (*(next(grads) if n else None for n in need), None, None)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0
                         ) -> torch.Tensor:
    """Launch `csrc/flash_attention.cu` on CUDA tensors (differentiable
    through `_FlashST`)."""
    return _FlashST.apply(q, k, v, causal, window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (BH, T, d); k, v: (BH, S, d) — heads pre-folded into batch."""
    return registry.dispatch("attention", (q, k, v), causal=causal,
                             window=window)


def _make_inputs(generator: torch.Generator):
    BH, T, d = 2, 160, 64      # as the JAX family's: T not a multiple of 128
    q, k, v = (torch.randn((BH, T, d), generator=generator)
               for _ in range(3))
    return q, k, v


registry.register(registry.KernelSpec(
    name="attention", plain=attention_ref, cuda=flash_attention_cuda,
    make_inputs=_make_inputs, static=dict(causal=True), tol=2e-3,
    diff_argnums=(0, 1, 2)))

__all__ = ["flash_attention", "flash_attention_cuda", "attention_ref",
           "MAX_HEAD_DIM"]
