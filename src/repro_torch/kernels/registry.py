"""Kernel registry: one registration and dispatch point per kernel family.

Each family registers a `KernelSpec` once, at the bottom of its `ops.py`:
its plain PyTorch version, its CUDA wrapper, a `make_inputs` for parity
checks, the tolerance its parity is held to and, for a differentiable
family, the arguments whose gradients `parity.py` compares, its backward
pair (`bwd`: plain and CUDA, where the gradient is a kernel of its own:
`lif`, `linrec`, `lifrec`, `alif`, `alifrec`, and `spikemm`'s weight
gradient) and `vjp(fwd, bwd, *args, **static)`, its
`torch.autograd.Function` run on a given forward and backward, so that
the parity harness can hold the CUDA pair against the plain pair. The
public entries run the same Function with the implementations chosen by
device (`dispatch`, `dispatch_bwd`).

Dispatch goes by the device of the tensors, and by nothing else: tensors
on the CPU run the plain version, tensors on a CUDA device launch the hand
kernel. There is no environment switch that sends card tensors to the
plain version, and no fallback: when a build or a launch fails, the call
raises. So do the injected infrastructure faults (`core/faults.py`), on
either device, before the device is chosen: a `compile_fail` that targets
the family raises `FaultInjectedError` where the JAX package would fall
back to its reference, and so does any active `vmem_limit`. (The JAX package's pallas -> interpret -> ref chain and its
autotuner are not ported; a TPU's block sizes are VMEM choices that mean
nothing here.)

A family may register alternative implementation `channels` (as the
JAX `KernelSpec` does: `spikemm`'s block-sparse channel) and a
`select_channel` router. The router picks the channel per call, before
the device decides between that channel's CUDA wrapper and its plain
version; it returns the channel's key (None for the family's own pair)
and the keyword arguments it hands that channel: what it measured to
decide, so the channel does not measure it again. There is no fallback
from one channel to another: a router that raises fails the call.

Each CUDA wrapper keeps a plain integer count of its launches
(`wrapper.launches`), which `launch_counts()` reads and `reset_launches()`
zeroes, so a run can show that it went through the kernels. A channel's
wrapper counts on its own, listed as `<family>_<channel>`, and so does a
backward kernel's, as `<family>_bwd` or its spec's `bwd_name`
(`spikemm_wgrad`).
"""

from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, Mapping, Optional, Sequence,
                    Tuple)

import torch

from repro_torch.core import faults


@dataclasses.dataclass(frozen=True)
class Channel:
    """An alternative implementation pair of a family: the same function,
    computed another way that wins on some inputs."""

    plain: Callable[..., Any]
    cuda: Callable[..., Any]


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Everything dispatch and the parity checks need for one family."""

    name: str
    plain: Callable[..., Any]          # plain PyTorch version (any device)
    cuda: Callable[..., Any]           # hand-kernel wrapper (CUDA tensors)
    make_inputs: Optional[Callable[..., tuple]] = None  # (generator) -> args
    # keyword arguments a call on make_inputs' tensors needs beside them
    # (the JAX spec's `tune_static`)
    static: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    tol: float = 1e-4
    # the arguments whose gradients the parity harness holds against the
    # plain version's (the JAX spec's); () for forward-only families
    diff_argnums: Tuple[int, ...] = ()
    # the backward pair: bwd.plain / bwd.cuda(*saved, *cotangents, **static)
    bwd: Optional[Channel] = None
    # its launch counter's name in `launch_counts()` (default <name>_bwd)
    bwd_name: Optional[str] = None
    # vjp(fwd, bwd, *args, **static): the family's autograd.Function with
    # `fwd` forward and `bwd` backward
    vjp: Optional[Callable[..., Any]] = None
    # named alternative channels and the router that picks one per call:
    # select_channel(*args, traced=...) -> (a key of `channels` or None for
    # the (plain, cuda) pair above, kwargs for the chosen implementation)
    channels: Mapping[str, Channel] = dataclasses.field(default_factory=dict)
    select_channel: Optional[Callable[..., Tuple[Optional[str],
                                                 Dict[str, Any]]]] = None

    def wrappers(self) -> Dict[str, Callable[..., Any]]:
        """{counter name: CUDA wrapper}: the family's own and one per
        channel."""
        out = {self.name: self.cuda}
        out.update({f"{self.name}_{k}": c.cuda
                    for k, c in sorted(self.channels.items())})
        if self.bwd is not None:
            out[self.bwd_name or f"{self.name}_bwd"] = self.bwd.cuda
        return out


_REGISTRY: Dict[str, KernelSpec] = {}

_KERNEL_MODULES = (
    "repro_torch.kernels.spikemm.ops",
    "repro_torch.kernels.linrec.ops",
    "repro_torch.kernels.lif.ops",
    "repro_torch.kernels.lifrec.ops",
    "repro_torch.kernels.alifrec.ops",
    "repro_torch.kernels.spikemm.gather",
    "repro_torch.kernels.stdp.ops",
    "repro_torch.kernels.attention.ops",
)


def register(spec: KernelSpec) -> KernelSpec:
    """Idempotent by name; each wrapper starts with a launch count of 0."""
    for fn in spec.wrappers().values():
        if not hasattr(fn, "launches"):
            fn.launches = 0
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


def dispatch(name: str, args: Sequence[Any], traced: bool = False,
             **static) -> Any:
    """Run family `name`: the router's channel (or the family's own pair),
    then the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. `traced` goes to the router only (see `spikemm`); `static`
    kwargs, and those the router hands its channel, are forwarded to the
    implementation."""
    faults.check_dispatch(name)
    spec = get(name)
    impl: Any = spec
    if spec.select_channel is not None:
        choice, measured = spec.select_channel(*args, traced=traced)
        if choice is not None:
            impl = spec.channels[choice]
        static = {**static, **measured}
    fn = impl.cuda if on_cuda(args) else impl.plain
    return fn(*args, **static)


def dispatch_bwd(name: str, args: Sequence[Any], **static) -> Any:
    """Run family `name`'s backward: its CUDA kernel for CUDA tensors,
    its plain version for CPU tensors."""
    faults.check_dispatch(name)
    bwd = get(name).bwd
    if bwd is None:
        raise ValueError(f"kernel {name!r} has no backward of its own")
    return (bwd.cuda if on_cuda(args) else bwd.plain)(*args, **static)


def launch_counts() -> Dict[str, int]:
    """{wrapper: launches} of every family and channel."""
    ensure_registered()
    out: Dict[str, int] = {}
    for s in _REGISTRY.values():
        out.update({n: fn.launches for n, fn in s.wrappers().items()})
    return dict(sorted(out.items()))


def reset_launches() -> None:
    ensure_registered()
    for s in _REGISTRY.values():
        for fn in s.wrappers().values():
            fn.launches = 0


__all__ = ["Channel", "KernelSpec", "register", "get", "names", "dispatch",
           "dispatch_bwd",
           "ensure_registered", "on_cuda", "launch_counts",
           "reset_launches"]
