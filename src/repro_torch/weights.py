"""Carry parameters between the JAX package and the port.

`jax.random` and `torch` draw different numbers from one seed, so a
parity check never re-draws weights: it takes the reference's parameter
tree as numpy arrays (`jax.tree_util.tree_map(np.asarray, params)` on the
JAX side) and turns it into the port's tensors here. Nested dicts map to
nested dicts, None stays None (e.g. a homogeneous model's "neuron"
entry), and every array is copied into a contiguous tensor on `device`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.kernels.common import DeviceLike, resolve_device


def params_from_numpy(tree: Any, device: DeviceLike = "cuda") -> Any:
    """numpy (or array-like) parameter tree -> torch tensors on `device`."""
    dev = resolve_device(device)

    def conv(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x, copy=True, order="C")).to(dev)

    return conv(tree)


def params_to_numpy(tree: Any) -> Any:
    """The inverse: torch tensors (any device) -> numpy arrays."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


__all__ = ["params_from_numpy", "params_to_numpy"]
