"""Surrogate gradients for the non-differentiable fire operation (STBP, §II-A).

The forward pass is an exact Heaviside step (spikes are binary, as on
chip); the backward pass substitutes a smooth proxy so BPTT can train
through the fire stage: `spike` is a `torch.autograd.Function` whose
backward is ct * g(v - v_th, alpha). The paper cites Wu et al. 2018
(STBP), which uses a rectangular window; sigmoid', arctan' and triangle
proxies are selectable per neuron, and `register` adds more.

Each proxy is written as the JAX package's, one rounded fp32 operation
at a time in the same order (alpha as an fp32 scalar), so that
`kernels/lif`'s backward kernel can compute the built-in four in
registers and equal the plain version bit for bit (sigmoid within the
accuracy of `expf`).
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

_SURROGATES: Dict[str, Callable[[torch.Tensor, torch.Tensor],
                                torch.Tensor]] = {}


def register(name: str):
    """Decorator: make `fn(x, alpha) -> d spike / d x` selectable as
    surrogate `name` (x = v - v_th; alpha an fp32 scalar tensor)."""
    def deco(fn):
        _SURROGATES[name] = fn
        return fn
    return deco


@register("rectangle")
def _rectangle_grad(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    # STBP h1: 1/alpha inside a window of width alpha around the threshold
    return (x.abs() < alpha / 2.0).to(x.dtype) / alpha


@register("sigmoid")
def _sigmoid_grad(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    s = torch.sigmoid(alpha * x)
    return alpha * s * (1.0 - s)


# pi / 2 as the fp32 scalar the JAX package's weak-typed product rounds to
_HALF_PI = math.pi / 2.0


@register("arctan")
def _arctan_grad(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    y = (torch.tensor(_HALF_PI, dtype=x.dtype, device=x.device) * alpha) * x
    return alpha / (2.0 * (1.0 + y * y))


@register("triangle")
def _triangle_grad(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(1.0 - (alpha * x).abs(), 0.0) * alpha


def surrogate_names():
    return sorted(_SURROGATES)


def check_surrogate(surrogate: str) -> None:
    if surrogate not in _SURROGATES:
        raise ValueError(f"unknown surrogate {surrogate!r}; "
                         f"expected one of {tuple(surrogate_names())}")


def surrogate_grad(x: torch.Tensor, surrogate: str,
                   alpha: float) -> torch.Tensor:
    """g(x, alpha) of surrogate `surrogate`, alpha cast to x's dtype."""
    check_surrogate(surrogate)
    return _SURROGATES[surrogate](
        x, torch.tensor(alpha, dtype=x.dtype, device=x.device))


class _Spike(torch.autograd.Function):
    """Heaviside forward, ct * g(v - v_th, alpha) backward."""

    @staticmethod
    def forward(ctx, v_minus_th, surrogate, alpha):
        ctx.save_for_backward(v_minus_th)
        ctx.surrogate, ctx.alpha = surrogate, alpha
        return (v_minus_th >= 0.0).to(v_minus_th.dtype)

    @staticmethod
    def backward(ctx, ct):
        (v_minus_th,) = ctx.saved_tensors
        return ct * surrogate_grad(v_minus_th, ctx.surrogate,
                                   ctx.alpha), None, None


def spike(v_minus_th: torch.Tensor, surrogate: str = "rectangle",
          alpha: float = 1.0) -> torch.Tensor:
    """Heaviside(v - v_th) with a surrogate gradient.

    surrogate: one of `surrogate_names()`; alpha: its sharpness. Returns
    binary spikes with the dtype of the input."""
    check_surrogate(surrogate)
    return _Spike.apply(v_minus_th, surrogate, alpha)


__all__ = ["spike", "register", "surrogate_names", "surrogate_grad",
           "check_surrogate"]
