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

Each family also declares the CTA tiles its wrappers launch, for the
static checks (`repro_torch.analysis`, TB230 and TB3xx): `block_axes`
(the tile's dimensions), `dims_of` (the logical dims of a call),
`plan(dims, n_sm, overrides)` (the wrappers' own plan functions, which
`resolve_blocks` calls: `spikemm.ops.col_tile`, `common.lane_plan`, ...),
`candidates` (every route dispatch can take: dims or tiles that reach
it) and a `TileModel`: how the grid covers the output, the CTA's
shared-memory buffers, and each kernel launch of the route (grid,
threads, shared memory), which `chip_smoke.py` holds against the card's
own launches (a CUDA graph of the call, and the profiler's trace). Its
backward kernel's tiles are declared the same way on `bwd_tiles`.

Each CUDA wrapper keeps a plain integer count of its launches
(`wrapper.launches`), which `launch_counts()` reads and `reset_launches()`
zeroes, so a run can show that it went through the kernels. A channel's
wrapper counts on its own, listed as `<family>_<channel>`, and so does a
backward kernel's, as `<family>_bwd` or its spec's `bwd_name`
(`spikemm_wgrad`).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import (Any, Callable, Dict, Iterator, Mapping, Optional,
                    Sequence, Tuple)

import torch

from repro_torch.core import faults


@dataclasses.dataclass(frozen=True)
class Channel:
    """An alternative implementation pair of a family: the same function,
    computed another way that wins on some inputs."""

    plain: Callable[..., Any]
    cuda: Callable[..., Any]


@dataclasses.dataclass(frozen=True)
class BlockAxis:
    """One dimension of the CTA tile a family's wrappers launch.

    `name` is its key in the blocks dict (`KernelSpec.resolve_blocks`);
    `dim` names the logical dimension (`KernelSpec.dims_of`) it tiles;
    `preferred` is the largest tile the plan picks and `align` the step it
    picks in. An `exact` axis must divide its dim: a recurrence's time
    axis, chained inside one CTA, is taken whole."""

    name: str
    dim: str
    preferred: int
    align: int
    exact: bool = False


@dataclasses.dataclass(frozen=True)
class Launch:
    """One kernel launch of a route: the kernel's name (its function name,
    as the profiler's trace spells it inside the demangled signature), its
    grid of CTAs, its threads a CTA, the dynamic shared memory it asks for
    and the static shared memory its source declares, in bytes."""

    kernel: str
    grid: Tuple[int, int, int]
    threads: int
    dynamic_smem: int
    static_smem: int = 0

    @property
    def smem(self) -> int:
        return self.dynamic_smem + self.static_smem


@dataclasses.dataclass(frozen=True)
class TileModel:
    """Static description of a family's CTA grid and shared memory.

    out:      the output's dims in order, each paired with the block axis
              that tiles it (None: the dim rides whole in every CTA).
    tiles:    (dims, blocks) -> {buffer: shape} of a CTA's shared-memory
              buffers, in 4-byte words (the analyzer's TB304/305 operand
              tiles).
    launches: (dims, blocks) -> the route's kernel launches, in order.
    coverage: optional override returning, per CTA, the per-output-axis
              (start, stop) ranges it writes; defaults to the dense
              row-major tiling of `out`.
    """

    out: Tuple[Tuple[str, Optional[str]], ...]
    tiles: Callable[[Mapping[str, int], Mapping[str, int]],
                    Mapping[str, Tuple[int, ...]]]
    launches: Optional[Callable[[Mapping[str, int], Mapping[str, int]],
                                Tuple[Launch, ...]]] = None
    coverage: Optional[Callable[[Mapping[str, int], Mapping[str, int]],
                                Any]] = None


def tile_cells(*axes: Tuple[int, int]) -> Iterator[Tuple[Tuple[int, int],
                                                        ...]]:
    """The cells of a dense row-major tiling: `axes` are (size, tile)
    pairs, one per output dim; each cell is its (start, stop) per dim, the
    last tile of a dim cut at its size."""
    per = [[(i * b, min((i + 1) * b, n)) for i in range(max(1, -(-n // b)))]
           for n, b in axes]
    return itertools.product(*per)


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
    # the CTA tiles (see the module docstring): their axes, the call's
    # logical dims dims_of(*args, **static), the wrappers' plan
    # plan(dims, n_sm, overrides) -> blocks, the routes dispatch can take
    # (dicts of dims and/or block axes that reach each), and the model
    block_axes: Tuple[BlockAxis, ...] = ()
    dims_of: Optional[Callable[..., Dict[str, int]]] = None
    plan: Optional[Callable[[Mapping[str, int], int, Mapping[str, int]],
                            Dict[str, int]]] = None
    candidates: Tuple[Mapping[str, int], ...] = ()
    tile_model: Optional[TileModel] = None
    # the backward kernel's tiles, declared the same way on a spec of its
    # own (named as its launch counter; its dims are those of the forward
    # call on make_inputs' arguments)
    bwd_tiles: Optional["KernelSpec"] = None

    def resolve_blocks(self, dims: Mapping[str, int],
                       overrides: Optional[Mapping[str, int]] = None,
                       n_sm: Optional[int] = None) -> Dict[str, int]:
        """The CTA tile the wrappers launch at `dims` on a card of `n_sm`
        SMs (default: the current card's, `common.plan_sms`), with the
        tile axes in `overrides` pinned where the plan takes them."""
        if self.plan is None:
            raise ValueError(f"kernel {self.name!r} declares no tile plan")
        if n_sm is None:
            from repro_torch.kernels.common import plan_sms
            n_sm = plan_sms()
        return dict(self.plan(dims, n_sm, dict(overrides or {})))

    def launches(self, dims: Mapping[str, int],
                 blocks: Mapping[str, int]) -> Tuple[Launch, ...]:
        """The route's kernel launches at `dims` and `blocks`."""
        if self.tile_model is None or self.tile_model.launches is None:
            return ()
        return tuple(self.tile_model.launches(dims, blocks))

    def smem_bytes(self, dims: Mapping[str, int],
                   blocks: Mapping[str, int]) -> int:
        """The model of the route's shared memory: the most any of its
        launches asks of a CTA, static plus dynamic, in bytes."""
        return max((x.smem for x in self.launches(dims, blocks)), default=0)

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


__all__ = ["BlockAxis", "Channel", "KernelSpec", "Launch", "TileModel",
           "tile_cells", "register", "get", "names", "dispatch",
           "dispatch_bwd",
           "ensure_registered", "on_cuda", "launch_counts",
           "reset_launches"]
