"""Deterministic, seedable fault injection for the execution runtime.

The port of `repro/core/faults.py`. Neuromorphic deployments are
fault-prone by design: spike packets drop on the NoC, cores die and leave
their neuron rows silent (or stuck firing), weight SRAM takes bit-flips.
A runtime that serves always-on streaming workloads has to stay
correct-enough, and above all *defined*, under those faults, so this
module makes them injectable on demand:

  data faults (applied inside the engines, fully deterministic)
    drop_blocks   packet loss: whole (bt x bn) tiles of the input raster
                  zeroed.            p=<frac>, bt=8, bn=128, seed=<int>
    dead_rows     dead/stuck neuron rows at node outputs.
                  frac=<frac>, mode=dead|stuck, node=<name or *>, seed
    bitflip       weight-plane sign flips on "w_*" params.
                  frac=<frac>, seed
    nan_weights   weight-plane NaN poisoning on "w_*" params.
                  frac=<frac>, seed

  infrastructure faults (applied at kernel dispatch)
    compile_fail  makes `kernels/registry.py`'s dispatch of the targeted
                  families raise `FaultInjectedError`, on either device.
                  kernels=<name|name2|...| * >, p=<frac>, seed (autotune=
                  parses and changes nothing: the port has no autotuner)
    vmem_limit    parses (mb=<float>); while it is active every dispatch
                  raises `FaultInjectedError`, because it models a Pallas
                  VMEM budget, which has no counterpart on the card

The JAX package exercises its pallas -> interpret -> ref fallback chain
with the two infrastructure faults. The port has no fallback chain (a
kernel that fails on the card must raise, not quietly leave the kernel),
so here they make the failure raise where the reference would degrade.

Faults are specified as `kind:key=val,key=val` clauses joined with ";",
either in the `REPRO_FAULTS` env var or pushed with the `inject()` context
manager (which *replaces* the env spec while active, so tests are
deterministic under a chaos-CI environment).

The masks are the JAX package's, bit for bit. There every mask is
`jax.random.uniform` on `fold_in(PRNGKey(seed), crc32(site))`; here the
same threefry-2x32 counter hash, key derivation and float conversion are
written out in numpy (`_threefry2x32`, `_site_key`, `_uniform`). A mask is
drawn once on the host and cached on the device it is applied on, keyed by
its kind, seed, site, shape and parameters (`mask_cache_info()` counts the draws
and the hits), so a served window redraws nothing. The masks of node
outputs depend only on the neuron axis, so the fused plan engine and the
per-step stepper see exactly the same fault.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import zlib
from collections import OrderedDict
from typing import (Any, Callable, Collection, Dict, List, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

_ENV = "REPRO_FAULTS"

KINDS = ("drop_blocks", "dead_rows", "bitflip", "nan_weights",
         "compile_fail", "vmem_limit")


class FaultInjectedError(RuntimeError):
    """The exception injected infrastructure faults raise."""


@dataclasses.dataclass(frozen=True)
class Fault:
    kind: str
    params: Tuple[Tuple[str, str], ...] = ()

    def get(self, key: str, default: Any = None) -> Any:
        for k, v in self.params:
            if k == key:
                return v
        return default

    def getf(self, key: str, default: float) -> float:
        return float(self.get(key, default))

    def geti(self, key: str, default: int) -> int:
        return int(float(self.get(key, default)))


def parse(spec: str) -> Tuple[Fault, ...]:
    """Parse a REPRO_FAULTS spec string into Fault clauses."""
    out: List[Fault] = []
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        kind, _, rest = clause.partition(":")
        kind = kind.strip()
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} in {_ENV} "
                             f"(known: {', '.join(KINDS)})")
        params = []
        for kv in rest.split(","):
            kv = kv.strip()
            if not kv:
                continue
            k, sep, v = kv.partition("=")
            if not sep:
                raise ValueError(f"fault param {kv!r} is not key=value "
                                 f"(clause {clause!r})")
            params.append((k.strip(), v.strip()))
        out.append(Fault(kind, tuple(params)))
    return tuple(out)


# ---------------------------------------------------------------------------
# active-fault resolution: context stack overrides env
# ---------------------------------------------------------------------------

_STACK: List[Tuple[Fault, ...]] = []
_ENV_CACHE: Tuple[str, Tuple[Fault, ...]] = ("", ())


def active() -> Tuple[Fault, ...]:
    """The faults in effect: innermost `inject()` context, else REPRO_FAULTS."""
    if _STACK:
        return _STACK[-1]
    global _ENV_CACHE
    spec = os.environ.get(_ENV, "")
    if spec != _ENV_CACHE[0]:
        _ENV_CACHE = (spec, parse(spec) if spec else ())
    return _ENV_CACHE[1]


@contextlib.contextmanager
def inject(spec: str = ""):
    """Install a fault spec for the dynamic extent of the with-block.

    The spec *replaces* whatever REPRO_FAULTS / outer contexts carry
    (inject("") therefore disables all faults), keeping tests
    deterministic under a chaos-CI environment.
    """
    _STACK.append(parse(spec) if spec else ())
    try:
        yield
    finally:
        _STACK.pop()


def _select(kind: str) -> Tuple[Fault, ...]:
    return tuple(f for f in active() if f.kind == kind)


def _hits(name: str, patterns: str) -> bool:
    pats = [p for p in patterns.split("|") if p]
    return "*" in pats or name in pats


# ---------------------------------------------------------------------------
# the JAX package's counter-based PRNG (threefry-2x32), in numpy
# ---------------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _threefry2x32(key: Tuple[int, int], x0: np.ndarray, x1: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds of the counter words (x0, x1) under the
    key words: the hash `jax.random` runs on every key."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(_KS_PARITY))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x0 ^ x1
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _prng_key(seed: int) -> Tuple[int, int]:
    """`jax.random.PRNGKey(seed)`'s two key words."""
    return 0, seed & 0xFFFFFFFF


def _fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """`jax.random.fold_in(key, data)`: the key hashes the counter (0, data)."""
    y0, y1 = _threefry2x32(key, np.zeros(1, np.uint32),
                           np.full(1, data & 0xFFFFFFFF, np.uint32))
    return int(y0[0]), int(y1[0])


def _site_key(seed: int, site: str) -> Tuple[int, int]:
    """Deterministic PRNG key for a (seed, site) pair; crc32 keeps the site
    hash stable across processes (Python's hash() is salted)."""
    return _fold_in(_prng_key(seed),
                    zlib.crc32(site.encode()) & 0x7FFFFFFF)


def _uniform(key: Tuple[int, int], shape: Tuple[int, ...]) -> np.ndarray:
    """`jax.random.uniform(key, shape)` in float32 on [0, 1): element i
    hashes the 64-bit counter i as its (high, low) words, XORs the two
    output words, and keeps 23 bits as the mantissa of a float in [1, 2)."""
    n = int(np.prod(shape, dtype=np.int64))
    i = np.arange(n, dtype=np.uint64)
    b0, b1 = _threefry2x32(key, (i >> np.uint64(32)).astype(np.uint32),
                           (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    bits = ((b0 ^ b1) >> np.uint32(9)) | np.uint32(0x3F800000)
    return (bits.view(np.float32) - np.float32(1.0)).reshape(shape)


# ---------------------------------------------------------------------------
# the mask cache: drawn once on the host, kept on the device it serves
# ---------------------------------------------------------------------------

_MASK_CACHE_SIZE = 256
_MASKS: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
_MASK_STATS = {"draws": 0, "hits": 0}


def _mask(kind: str, seed: int, site: str, shape: Tuple[int, ...],
          args: tuple, device: torch.device,
          make: Callable[[np.ndarray], np.ndarray]) -> torch.Tensor:
    """`make(uniform draw of (seed, site, shape))` on `device`, drawn on
    the host the first time and served from the cache after; `args` are
    the fault's parameters that `make` reads (its rate, its tile)."""
    key = (kind, seed, site, tuple(shape), args, str(device))
    m = _MASKS.get(key)
    if m is not None:
        _MASK_STATS["hits"] += 1
        _MASKS.move_to_end(key)
        return m
    _MASK_STATS["draws"] += 1
    m = torch.from_numpy(make(_uniform(_site_key(seed, site), shape))).to(
        device)
    _MASKS[key] = m
    if len(_MASKS) > _MASK_CACHE_SIZE:
        _MASKS.popitem(last=False)
    return m


def mask_cache_info() -> Dict[str, int]:
    """{"draws": masks drawn on the host, "hits": masks served from the
    cache, "size": masks held}."""
    return {**_MASK_STATS, "size": len(_MASKS)}


def clear_mask_cache() -> None:
    _MASKS.clear()
    _MASK_STATS.update(draws=0, hits=0)


# ---------------------------------------------------------------------------
# data faults
# ---------------------------------------------------------------------------


def perturb_input(x: torch.Tensor) -> torch.Tensor:
    """Apply `drop_blocks` packet loss to the (T, B, N) input raster.

    Whole (bt x bn) time-by-neuron tiles are zeroed across the batch —
    the software image of spike packets lost in transit. Identity when no
    drop_blocks fault is active.
    """
    for f in _select("drop_blocks"):
        p = f.getf("p", 0.05)
        bt, bn = f.geti("bt", 8), f.geti("bn", 128)
        seed = f.geti("seed", 0)
        T, N = x.shape[0], x.shape[-1]
        gt, gn = -(-T // bt), -(-N // bn)

        def tiles(u, p=p, bt=bt, bn=bn, T=T, N=N):
            keep = u >= p
            return np.repeat(np.repeat(keep, bt, 0)[:T], bn, 1)[:, :N]

        mask = _mask("drop_blocks", seed, f"drop_blocks:{T}x{N}", (gt, gn),
                     (p, bt, bn), x.device, tiles)
        shape = (T,) + (1,) * (x.dim() - 2) + (N,)
        x = x * mask.reshape(shape).to(x.dtype)
    return x


def perturb_output(node: str, out: torch.Tensor) -> torch.Tensor:
    """Apply `dead_rows` (dead / stuck-at-1 neuron rows) to a node output.

    The mask depends only on (seed, node, N) — never on time — so
    applying it per-step in the stepper and once on the full (T, B, N)
    tensor in the fused engine yields bit-identical results.
    """
    for f in _select("dead_rows"):
        if not _hits(node, str(f.get("node", "*"))):
            continue
        frac = f.getf("frac", 0.05)
        mode = str(f.get("mode", "dead"))
        seed = f.geti("seed", 0)
        N = out.shape[-1]
        hit = _mask("dead_rows", seed, f"dead_rows:{node}:{N}", (N,), (frac,),
                    out.device, lambda u, frac=frac: u < frac)
        if mode == "stuck":
            out = torch.where(hit, torch.ones((), dtype=out.dtype,
                                              device=out.device), out)
        else:
            out = out * (~hit).to(out.dtype)
    return out


def _poison_plane(w: torch.Tensor, site: str, frac: float, seed: int,
                  nan: bool, sessions: bool) -> torch.Tensor:
    """NaN (`nan`) or sign-flip a fraction of a weight plane. With
    `sessions` the plane's leading axis is a learning serve window's
    session axis: the mask is drawn on one session's shape, as the
    reference's per-session vmap draws it, and every session gets it."""
    if not w.dtype.is_floating_point:
        return w
    shape = tuple(w.shape[1:] if sessions else w.shape)
    hit = _mask("nan_weights" if nan else "bitflip", seed, site, shape,
                (frac,), w.device, lambda u: u < frac)
    if nan:
        return torch.where(hit, torch.full((), float("nan"), dtype=w.dtype,
                                           device=w.device), w)
    return torch.where(hit, -w, w)          # sign bit-flip


def perturb_params(params: Dict[str, Any],
                   sessions: Collection[Tuple[str, str]] = ()
                   ) -> Dict[str, Any]:
    """Apply `bitflip` / `nan_weights` poisoning to every "w_*" weight
    plane in a two-level SNN params dict. Identity when inactive.

    `sessions` names the (node, key) planes whose leading axis is a
    session axis (one weight a session, `plan.run`'s learning serve
    window): their mask is one session's, broadcast over the sessions."""
    flips = _select("bitflip")
    nans = _select("nan_weights")
    if not flips and not nans:
        return params
    out = dict(params)
    for node, sub in params.items():
        if not isinstance(sub, dict):
            continue
        new = dict(sub)
        for k, v in sub.items():
            if not k.startswith("w_") or not isinstance(v, torch.Tensor):
                continue
            per_session = (node, k) in sessions
            for f in flips:
                new[k] = _poison_plane(new[k], f"bitflip:{node}/{k}",
                                       f.getf("frac", 1e-3),
                                       f.geti("seed", 0), False, per_session)
            for f in nans:
                new[k] = _poison_plane(new[k], f"nan:{node}/{k}",
                                       f.getf("frac", 1e-3),
                                       f.geti("seed", 0), True, per_session)
        out[node] = new
    return out


# ---------------------------------------------------------------------------
# infrastructure faults
# ---------------------------------------------------------------------------


def _fails(f: Fault, kernel: str) -> bool:
    if not _hits(kernel, str(f.get("kernels", "*"))):
        return False
    p = f.getf("p", 1.0)
    if p >= 1.0:
        return True
    seed = f.geti("seed", 0)
    # deterministic per (kernel, seed): the same kernels fail all run long
    return (zlib.crc32(f"{kernel}:{seed}".encode()) % 10000) < p * 10000


def maybe_fail_compile(kernel: str) -> None:
    """Raise `FaultInjectedError` when a compile_fail fault targets
    `kernel`."""
    for f in _select("compile_fail"):
        if _fails(f, kernel):
            raise FaultInjectedError(
                f"injected kernel compile failure for {kernel!r}")


def vmem_limit_override_bytes() -> Optional[int]:
    """The smallest injected `vmem_limit` budget in bytes, or None when the
    fault is inactive (the reference's simulated VMEM pressure)."""
    faults = _select("vmem_limit")
    if not faults:
        return None
    return int(min(f.getf("mb", 1.0) for f in faults) * 2 ** 20)


def check_dispatch(kernel: str) -> None:
    """The infrastructure faults at a dispatch of `kernel`, before it
    chooses a device: raise for an active `vmem_limit` and for a
    `compile_fail` that targets the kernel. Nothing falls back."""
    budget = vmem_limit_override_bytes()
    if budget is not None:
        raise FaultInjectedError(
            f"injected vmem_limit ({budget} bytes) at {kernel!r}: the fault "
            "models a Pallas VMEM budget, which has no counterpart on the "
            "card (its hand kernels size their shared memory themselves)")
    maybe_fail_compile(kernel)


def describe(faults: Optional[Sequence[Fault]] = None) -> str:
    fs = active() if faults is None else tuple(faults)
    return "; ".join(
        f.kind + (":" + ",".join(f"{k}={v}" for k, v in f.params)
                  if f.params else "")
        for f in fs) or "(none)"


__all__ = ["Fault", "FaultInjectedError", "KINDS", "active", "describe",
           "inject", "maybe_fail_compile", "parse", "perturb_input",
           "perturb_output", "perturb_params", "vmem_limit_override_bytes",
           "check_dispatch", "mask_cache_info", "clear_mask_cache"]
