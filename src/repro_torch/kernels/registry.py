"""Kernel registry: one registration and dispatch point per kernel family.

Each family registers a `KernelSpec` once, at the bottom of its `ops.py`:
its plain PyTorch version, its CUDA wrapper, a `make_inputs` for parity
checks, and the tolerance its parity is held to.

Dispatch goes by the device of the tensors, and by nothing else: tensors
on the CPU run the plain version, tensors on a CUDA device launch the hand
kernel. There is no environment switch that sends card tensors to the
plain version, and no fallback: when a build or a launch fails, the call
raises. (The JAX package's pallas -> interpret -> ref chain and its
autotuner are not ported; a TPU's block sizes are VMEM choices that mean
nothing here.)

Each CUDA wrapper keeps a plain integer count of its launches
(`wrapper.launches`), which `launch_counts()` reads and `reset_launches()`
zeroes, so a run can show that it went through the kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Everything dispatch and the parity checks need for one family."""

    name: str
    plain: Callable[..., Any]          # plain PyTorch version (any device)
    cuda: Callable[..., Any]           # hand-kernel wrapper (CUDA tensors)
    make_inputs: Optional[Callable[..., tuple]] = None  # (generator) -> args
    tol: float = 1e-4


_REGISTRY: Dict[str, KernelSpec] = {}

_KERNEL_MODULES = (
    "repro_torch.kernels.spikemm.ops",
    "repro_torch.kernels.linrec.ops",
    "repro_torch.kernels.lif.ops",
    "repro_torch.kernels.lifrec.ops",
    "repro_torch.kernels.alifrec.ops",
)


def register(spec: KernelSpec) -> KernelSpec:
    """Idempotent by name; the wrapper starts with a launch count of 0."""
    if not hasattr(spec.cuda, "launches"):
        spec.cuda.launches = 0
    _REGISTRY[spec.name] = spec
    return spec


def ensure_registered() -> None:
    import importlib

    for mod in _KERNEL_MODULES:
        importlib.import_module(mod)


def get(name: str) -> KernelSpec:
    if name not in _REGISTRY:
        ensure_registered()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown kernel {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def names() -> tuple:
    ensure_registered()
    return tuple(sorted(_REGISTRY))


def on_cuda(args: Sequence[Any]) -> bool:
    """True when every tensor argument lies on a CUDA device, False when
    every one lies on the CPU; raises on a mix."""
    kinds = {a.device.type for a in args if isinstance(a, torch.Tensor)}
    if kinds == {"cuda"}:
        return True
    if kinds <= {"cpu"}:
        return False
    raise ValueError(f"kernel arguments span devices {sorted(kinds)}")


def dispatch(name: str, args: Sequence[Any], **static) -> Any:
    """Run family `name`: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. `static` kwargs are forwarded to either."""
    spec = get(name)
    fn = spec.cuda if on_cuda(args) else spec.plain
    return fn(*args, **static)


def launch_counts() -> Dict[str, int]:
    ensure_registered()
    return {n: s.cuda.launches for n, s in sorted(_REGISTRY.items())}


def reset_launches() -> None:
    ensure_registered()
    for s in _REGISTRY.values():
        s.cuda.launches = 0


__all__ = ["KernelSpec", "register", "get", "names", "dispatch",
           "ensure_registered", "on_cuda", "launch_counts",
           "reset_launches"]
