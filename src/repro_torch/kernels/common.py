"""Shared kernel utilities: device resolution and padding.

`resolve_device` is the port's one rule for where work runs: the entry
points default to the card, run on the CPU only when the caller asks for
it, and raise when the card is asked for and there is none. Nothing in
the package continues on the CPU behind the caller's back.
"""

from __future__ import annotations

from typing import Any, Union

import torch
import torch.nn.functional as F

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """`device` as a torch.device; raises for a CUDA device when there is
    no usable card (pass device="cpu" to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def check_device(what: str, t: torch.Tensor, device: torch.device) -> None:
    """Raise unless tensor `t` lies on `device` (index-insensitive for a
    bare "cuda")."""
    if t.device.type != device.type or (
            device.index is not None and t.device.index != device.index):
        raise ValueError(f"{what} lies on {t.device}, expected {device}")


def tree_to(tree: Any, device: DeviceLike) -> Any:
    """A nested dict of tensors (None leaves allowed) moved to `device`."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def pad_axis(x: torch.Tensor, axis: int, mult: int, value=0.0):
    """Pad `axis` of x up to a multiple of `mult`. Returns (padded, orig_len)."""
    n = x.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return x, n
    axis = axis % x.dim()
    widths = [0, 0] * (x.dim() - axis - 1) + [0, pad]
    return F.pad(x, widths, value=value), n


__all__ = ["resolve_device", "check_device", "tree_to", "pad_axis",
           "DeviceLike"]
