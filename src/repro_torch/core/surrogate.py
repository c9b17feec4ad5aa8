"""Spike function and the surrogate-gradient name table (STBP, §II-A).

The forward pass is an exact Heaviside step (spikes are binary, as on
chip). The surrogate gradients themselves, and the `autograd.Function`
that applies them, come with the training slice; this module keeps the
forward spike and the names the neuron factories validate against.
"""

from __future__ import annotations

import torch

# the four surrogate proxies of the JAX package (repro/core/surrogate.py)
SURROGATES = ("arctan", "rectangle", "sigmoid", "triangle")


def spike(v_minus_th: torch.Tensor, surrogate: str = "rectangle",
          alpha: float = 1.0) -> torch.Tensor:
    """Heaviside(v - v_th): binary spikes with the dtype of the input.

    `surrogate` and `alpha` select the backward proxy; forward only here,
    so they are validated and otherwise unused."""
    if surrogate not in SURROGATES:
        raise ValueError(f"unknown surrogate {surrogate!r}; "
                         f"expected one of {SURROGATES}")
    return (v_minus_th >= 0.0).to(v_minus_th.dtype)


__all__ = ["spike", "SURROGATES"]
