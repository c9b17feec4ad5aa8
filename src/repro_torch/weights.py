"""Carry parameters between the JAX package and the port.

`jax.random` and `torch` draw different numbers from one seed, so a
parity check never re-draws weights: it takes the reference's parameter
tree as numpy arrays (`jax.tree_util.tree_map(np.asarray, params)` on the
JAX side) and turns it into the port's tensors here. Nested dicts map to
nested dicts, None stays None (e.g. a homogeneous model's "neuron"
entry), and every array is copied into a contiguous tensor on `device`.

Gradients travel back the same way: `grads_to_numpy` takes the `.grad`
of each leaf, so a test compares the port's gradient tree with the
reference's `jax.grad` tree leaf for leaf.

A compressed topology is configuration, not an array: an `EncodedTopology`
leaf (the port's own, encoded from the same numpy arrays as the
reference's) passes through untouched, and its tables go to a device when
a kernel first needs them.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.topology import EncodedTopology
from repro_torch.kernels.common import DeviceLike, resolve_device


def params_from_numpy(tree: Any, device: DeviceLike = "cuda") -> Any:
    """numpy (or array-like) parameter tree -> torch tensors on `device`."""
    dev = resolve_device(device)

    def conv(x):
        if x is None or isinstance(x, EncodedTopology):
            return x
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return torch.from_numpy(np.array(x, copy=True, order="C")).to(dev)

    return conv(tree)


def params_to_numpy(tree: Any) -> Any:
    """The inverse: torch tensors (any device) -> numpy arrays."""
    if tree is None or isinstance(tree, EncodedTopology):
        return tree
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def grads_to_numpy(tree: Any) -> Any:
    """The `.grad` of every tensor leaf of a parameter tree as numpy (None
    where a leaf has none), shaped like the tree: to hold a backward pass
    against the JAX package's gradient tree leaf for leaf."""
    if tree is None or isinstance(tree, EncodedTopology):
        return None
    if isinstance(tree, dict):
        return {k: grads_to_numpy(v) for k, v in tree.items()}
    return None if tree.grad is None else params_to_numpy(tree.grad)


__all__ = ["params_from_numpy", "params_to_numpy", "grads_to_numpy"]
