"""Shared kernel utilities: device resolution, argument checks, padding.

`resolve_device` is the port's one rule for where work runs: the entry
points default to the card, run on the CPU only when the caller asks for
it, and raise when the card is asked for and there is none. Nothing in
the package continues on the CPU behind the caller's back.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

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


def check_scan(name: str, current: torch.Tensor,
               w_rec: Optional[torch.Tensor], per_neuron: Sequence,
               per_lane: Sequence) -> None:
    """The checks of a time-scan kernel's wrapper: CUDA tensors, a
    (T, B, N) current, an (N, N) `w_rec` unless None, (N,) per-neuron and
    (B, N) per-lane tensors given as (name, tensor) pairs, all float32,
    contiguous and on the current's device."""
    if not current.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"{current.device}")
    if current.dim() != 3:
        raise ValueError(f"{name}: current {tuple(current.shape)} must be "
                         "(T, B, N)")
    T, B, N = current.shape
    args = [("current", current, (T, B, N))]
    if w_rec is not None:
        args.append(("w_rec", w_rec, (N, N)))
    args += [(nm, t, (N,)) for nm, t in per_neuron]
    args += [(nm, t, (B, N)) for nm, t in per_lane]
    for nm, t, want in args:
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {nm} {tuple(t.shape)} must be {want} "
                             f"for current {tuple(current.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {nm} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")
        if t.device != current.device:
            raise ValueError(f"{name}: {nm} on {t.device}, current on "
                             f"{current.device}")


def check_rec_n(name: str, n: int) -> None:
    """Raise when a batch row of n neurons exceeds what the recurrent
    scan's block holds (`rec_scan_max_n` in the library)."""
    max_n = _build.library().rec_scan_max_n()
    if n > max_n:
        raise ValueError(f"{name}: N={n} neurons exceed the recurrent "
                         f"kernel's {max_n} per batch row")


def w_in_smem(n: int) -> bool:
    """Whether the recurrent kernels (`lifrec`, `alifrec`) keep an (n, n)
    W_rec in shared memory on the current device; else they read W_rec
    through L2."""
    code = _build.library().rec_scan_w_in_smem(n)
    _build.check("rec_scan", max(-code, 0))
    return bool(code)


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


__all__ = ["resolve_device", "check_device", "check_scan", "check_rec_n",
           "w_in_smem", "tree_to", "pad_axis", "DeviceLike"]
