"""CUDA kernel <-> plain version parity harness, on the card.

Every family registers canonical inputs (`make_inputs`), its tolerance and
its differentiable arguments (`diff_argnums`) in its `KernelSpec`; this
module turns that into one check that the family's CUDA wrapper, and the
wrapper of each of its channels, agrees on the card with the plain
version on the same inputs, on

  * the forward outputs (every leaf of the output), and
  * the VJP: gradients of a fixed nonlinear scalar loss with respect to
    every `diff_argnums` input. For a family with a `vjp` (`lif`,
    `linrec`, `lifrec`, `alif`, `alifrec`, `spikemm`) that is its
    autograd.Function run on the CUDA forward and backward against the
    same Function on the plain forward and backward (`spikemm`'s
    backward pair is its weight-gradient kernel, under each channel's
    forward); `attention`'s CUDA wrapper is
    differentiable itself and is held against autograd through its plain
    version.

It compares on the CUDA device only. Without a card both sides would be
the plain version, so `check_kernel` raises there rather than compare the
plain version with itself.

`check_kernel` raises AssertionError naming the kernel and the leaf on a
mismatch and returns a numeric report on success;
`python -m repro_torch.kernels.parity` checks every family and prints one
line per kernel.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import registry


def _loss(out) -> torch.Tensor:
    """Fixed nonlinear scalar reduction: weights every output leaf, keeps
    cotangents O(1), and breaks the symmetry a plain sum() would miss."""
    total = 0.0
    for i, leaf in enumerate(_leaves(out)):
        total = total + torch.sum(torch.sin(leaf.float() * (0.7 + i)))
    return total


def _leaves(out) -> List[torch.Tensor]:
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.numel() == 0:
        return 0.0
    return float((a.float() - b.float()).abs().max())


def _card() -> torch.device:
    """The CUDA device to compare on; raises when there is no card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "parity holds the CUDA kernels against their plain versions and "
            "needs device=\"cuda\", but no CUDA device is available: on the "
            "CPU both sides would be the plain version")
    return torch.device("cuda")


def _forward(label: str, plain: Callable, cuda: Callable,
             args: Sequence[Any], spec: registry.KernelSpec) -> float:
    ref = _leaves(plain(*args, **spec.static))
    got = _leaves(cuda(*args, **spec.static))
    if len(ref) != len(got):
        raise AssertionError(f"{label}: {len(got)} output leaves, the plain "
                             f"version has {len(ref)}")
    worst = 0.0
    for i, (r, g) in enumerate(zip(ref, got)):
        if r.shape != g.shape:
            raise AssertionError(f"{label}: leaf {i} shape {tuple(g.shape)} "
                                 f"!= plain {tuple(r.shape)}")
        err = _max_err(r, g)
        worst = max(worst, err)
        if not err <= spec.tol:
            raise AssertionError(f"{label}: forward leaf {i} max|err| "
                                 f"{err:.3e} > tol {spec.tol}")
    return worst


def _grads(fn: Callable, args: Sequence[Any],
           spec: registry.KernelSpec) -> Tuple[torch.Tensor, ...]:
    args = [a.detach().requires_grad_() if i in spec.diff_argnums else a
            for i, a in enumerate(args)]
    wrt = [args[i] for i in spec.diff_argnums]
    grads = torch.autograd.grad(_loss(fn(*args, **spec.static)), wrt,
                                allow_unused=True)
    # an argument the output does not reach has a zero gradient
    return tuple(torch.zeros_like(a) if g is None else g
                 for a, g in zip(wrt, grads))


def _vjp_legs(name: str, spec: registry.KernelSpec):
    """[(label, plain differentiable fn, CUDA differentiable fn)]: the
    family's pair and, for a family with a `vjp`, each channel's."""
    if spec.vjp is None:
        return [(name, spec.plain, spec.cuda)]
    pairs = [(name, spec.plain, spec.cuda)] + [
        (f"{name}_{key}", ch.plain, ch.cuda)
        for key, ch in sorted(spec.channels.items())]
    legs = []
    for label, plain, cuda in pairs:
        bp, bc = ((spec.bwd.plain, spec.bwd.cuda) if spec.bwd is not None
                  else (plain, cuda))
        legs.append((label, functools.partial(spec.vjp, plain, bp),
                     functools.partial(spec.vjp, cuda, bc)))
    return legs


def check_kernel(name: str, *, seed: int = 0,
                 check_vjp: bool = True) -> Dict[str, Any]:
    """Assert forward (and VJP) parity of one family's CUDA wrappers with
    its plain versions on the card. The report holds `forward_max_err`,
    `vjp_max_err` for a differentiable family, and one report a channel
    under `channels`."""
    dev = _card()
    spec = registry.get(name)
    if spec.make_inputs is None:
        raise ValueError(f"kernel {name!r} registered without make_inputs")
    args = tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                 for a in spec.make_inputs(torch.Generator().manual_seed(
                     seed)))
    report: Dict[str, Any] = {
        "forward_max_err": _forward(name, spec.plain, spec.cuda, args,
                                    spec)}
    if spec.channels:
        report["channels"] = {
            f"{name}_{key}": {"forward_max_err": _forward(
                f"{name}_{key}", ch.plain, ch.cuda, args, spec)}
            for key, ch in sorted(spec.channels.items())}

    if check_vjp and spec.diff_argnums:
        for label, plain, cuda in _vjp_legs(name, spec):
            worst = 0.0
            for argnum, r, g in zip(spec.diff_argnums,
                                    _grads(plain, args, spec),
                                    _grads(cuda, args, spec)):
                err = _max_err(r, g)
                worst = max(worst, err)
                if not err <= spec.tol:
                    raise AssertionError(
                        f"{label}: VJP wrt arg {argnum} max|err| {err:.3e} "
                        f"> tol {spec.tol}")
            rep = report if label == name else report["channels"][label]
            rep["vjp_max_err"] = worst
    return report


def check_all(*, seed: int = 0, names: Optional[Sequence[str]] = None
              ) -> Dict[str, Dict[str, Any]]:
    """Parity-check every registered family; raises on the first
    failure."""
    _card()
    registry.ensure_registered()
    return {name: check_kernel(name, seed=seed)
            for name in (names or registry.names())}


def main() -> None:
    reports = check_all()
    rows = []
    for name, rep in reports.items():
        rows.append((name, rep))
        rows += list(rep.get("channels", {}).items())
    width = max(len(n) for n, _ in rows)
    for name, rep in rows:
        vjp = rep.get("vjp_max_err")
        vjp_s = f"vjp {vjp:.3e}" if vjp is not None else "forward-only"
        print(f"{name:<{width}}  fwd {rep['forward_max_err']:.3e}  {vjp_s}")
    print(f"parity OK for {len(rows)} kernels "
          f"(device={torch.cuda.get_device_name()})")


if __name__ == "__main__":
    main()


__all__ = ["check_kernel", "check_all"]
