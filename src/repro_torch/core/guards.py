"""Numerical guardrails for `plan.run`: finite checks, spike-rate
monitors, and chunked-online divergence detection.

The port of `repro/core/guards.py`. An always-on streaming SNN fails in
characteristic ways: a NaN sneaks into a weight plane and silently poisons
every window after it; a mis-tuned threshold drives a population silent
(rate 0) or saturated (rate ~1); an unstable plasticity rule blows the
learned weights up over a few windows. Guards make those states
*observable and survivable* instead of silent:

  policy (REPRO_GUARD env or `plan.run(guard=...)`):
    off       no checks, zero inserted ops, launches or host reads (the
              default)
    warn      violations emit a warning and a "guard" incident on the
              per-process log (`repro_torch.kernels.incidents()`)
    raise     violations raise `GuardViolation`; in the serve engine's
              window step this degrades to `warn`, as it does in the JAX
              package's jitted step (a traced value cannot abort it)
    sanitize  violations are repaired on the device, with no host read:
              nonfinite activations become 0, a diverged learned-weight
              window rolls back to its entry tensor

  checks:
    check_tensor   nonfinite values in activations / carried state
    check_spikes   population silence (mean rate <= rate_silence) and
                   saturation (mean rate >= rate_saturation)
    guard_learned  chunked-online divergence: nonfinite learned entries
                   fall back elementwise, and a weight-norm explosion
                   (||w1|| > w_ratio_max * (||w0|| + 1)) rolls the whole
                   window's learned tensor back to the entry weights

Two things the port adds, each keeping the reference's results:

  * One host read a run. Inside `collect(...)` (which `plan.run` opens)
    a check under warn or raise only queues its flag on the device; at the
    end of the run every queued flag is read in one copy and the incidents
    are recorded in the order the checks ran. Under raise the first
    violation is recorded and raised, as the reference's eager run does.
    A check outside `collect` reads its flag at once.
  * A session axis. The serve engine runs a learning window as one batch
    of sessions, where the reference `vmap`s one session at a time. Given
    `axis`, a check acts per index along it: one flag (and one incident) a
    session, a session's own spike rate, a session's own weight norms and
    rollback. The incidents come in the vmapped reference's order: a
    check's sessions in ascending order, check after check.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import warnings
from typing import List, Optional, Tuple, Union

import torch

# the submodule itself: the `repro_torch.kernels` package re-exports an
# `incidents()` *function* that shadows the module attribute of that name
from repro_torch.kernels.incidents import (FallbackEvent,
                                           record as _record_incident)

_ENV = "REPRO_GUARD"
POLICIES = ("off", "warn", "raise", "sanitize")


class GuardViolation(RuntimeError):
    """Raised by policy="raise" on a guard violation."""


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    policy: str = "off"
    finite: bool = True              # nonfinite activation/state check
    rate_silence: float = 0.0        # mean spike rate <= this => silent
    rate_saturation: float = 0.98    # mean spike rate >= this => saturated
    w_ratio_max: float = 16.0        # learned-vs-entry weight norm blowup

    @property
    def active(self) -> bool:
        return self.policy != "off"


def config(policy: Union[None, str, GuardConfig] = None) -> GuardConfig:
    """Resolve a guard policy: explicit arg > REPRO_GUARD env > off."""
    if isinstance(policy, GuardConfig):
        return policy
    if policy is None:
        policy = os.environ.get(_ENV, "off")
    if policy not in POLICIES:
        raise ValueError(f"{_ENV}={policy!r}: expected one of "
                         f"{', '.join(POLICIES)}")
    return GuardConfig(policy=policy)


def _notify(tag: str, msg: str, policy: str) -> None:
    """Record one violation, then raise or warn by policy."""
    _record_incident(FallbackEvent(
        kind="guard", family=tag, stage=policy, error=msg))
    if policy == "raise":
        raise GuardViolation(f"[REPRO_GUARD] {tag}: {msg}")
    warnings.warn(f"[REPRO_GUARD] {tag}: {msg}", RuntimeWarning,
                  stacklevel=3)


class _Pending:
    """The flags one run's checks queued, read together at its end."""

    def __init__(self, degrade: bool):
        self.degrade = degrade
        self.flags: List[Tuple[str, str, str, torch.Tensor]] = []

    def flush(self) -> None:
        flags, self.flags = self.flags, []
        if not flags:
            return
        bad = torch.cat([f.reshape(-1) for *_, f in flags]).cpu().tolist()
        i = 0
        for tag, msg, policy, f in flags:
            for b in bad[i:i + f.numel()]:
                if b:
                    _notify(tag, msg, policy)
            i += f.numel()


_PENDING: List[_Pending] = []


@contextlib.contextmanager
def collect(degrade_raise: bool = False):
    """Queue the flags of the checks within, read them in one host copy on
    exit, and act on them in the order they were queued. With
    `degrade_raise` a raise policy records and warns instead (the serve
    engine's window step, like the JAX package's jitted step). If the block
    raises, the flags queued before are still acted on, so a violation
    that would have raised first under the reference's eager run raises
    first here too."""
    pending = _Pending(degrade_raise)
    _PENDING.append(pending)
    try:
        yield
    except BaseException as exc:
        _PENDING.pop()
        try:
            pending.flush()
        except GuardViolation as violation:
            raise violation from exc
        raise
    _PENDING.pop()
    pending.flush()


def _flag(tag: str, bad: torch.Tensor, msg: str, cfg: GuardConfig) -> None:
    """Act on a bool violation flag: one element, or one a session."""
    if _PENDING:
        p = _PENDING[-1]
        policy = "warn" if p.degrade and cfg.policy == "raise" \
            else cfg.policy
        p.flags.append((tag, msg, policy, bad.detach()))
        return
    for b in bad.reshape(-1).cpu().tolist():
        if b:
            _notify(tag, msg, cfg.policy)


def _per(x: torch.Tensor, axis: Optional[int]) -> Tuple[int, ...]:
    """The dims a per-session reduction runs over: all, or all but `axis`."""
    return tuple(d for d in range(x.dim()) if d != axis)


def check_tensor(tag: str, x: torch.Tensor, cfg: GuardConfig,
                 axis: Optional[int] = None) -> torch.Tensor:
    """Finite check on one activation/state tensor. Returns x, sanitized
    (nonfinite -> 0) under policy="sanitize". With `axis`, one flag for
    each index along it (a session axis)."""
    if not cfg.active or not cfg.finite:
        return x
    if not x.dtype.is_floating_point:
        return x                       # integer spikes cannot be nonfinite
    finite = torch.isfinite(x)
    if cfg.policy == "sanitize":
        return torch.where(finite, x, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))
    ok = finite.all() if axis is None else finite.all(dim=_per(x, axis))
    _flag(tag, ~ok, "nonfinite values detected", cfg)
    return x


def check_spikes(tag: str, spikes: torch.Tensor, cfg: GuardConfig,
                 axis: Optional[int] = None) -> None:
    """Silence / saturation monitor on an emitted spike train: its mean
    rate, or with `axis` each session's own."""
    if not cfg.active or cfg.policy == "sanitize":
        return                         # rates are a symptom, not repairable
    s = spikes.float()
    rate = s.mean() if axis is None else s.mean(dim=_per(s, axis))
    _flag(tag, rate <= cfg.rate_silence,
          f"population silent (mean rate <= {cfg.rate_silence})", cfg)
    _flag(tag, rate >= cfg.rate_saturation,
          f"population saturated (mean rate >= {cfg.rate_saturation})", cfg)


def guard_learned(tag: str, w0: torch.Tensor, w1: torch.Tensor,
                  cfg: GuardConfig, axis: Optional[int] = None
                  ) -> torch.Tensor:
    """Chunked-online divergence guard on one window's learned weights.

    w0 is the window's entry tensor, w1 the learned result. Under
    "sanitize", nonfinite entries fall back elementwise — to the entry
    value, or to 0 where the entry itself is already poisoned — and a
    norm explosion rolls the whole window back (device-side selects);
    otherwise violations warn/raise and w1 passes through. With `axis`
    (the session axis of a learning serve window) the norms, the
    explosion test and the rollback are each session's own.
    """
    if not cfg.active:
        return w1
    finite = torch.isfinite(w1)
    zero = torch.zeros((), dtype=w1.dtype, device=w1.device)
    dims = _per(w1, axis)
    n0 = torch.linalg.vector_norm(w0.float(), dim=dims)
    n1 = torch.linalg.vector_norm(torch.where(finite, w1, zero).float(),
                                  dim=dims)
    exploded = n1 > cfg.w_ratio_max * (n0 + 1.0)
    if cfg.policy == "sanitize":
        safe0 = torch.where(torch.isfinite(w0), w0,
                            torch.zeros((), dtype=w0.dtype, device=w0.device))
        w1 = torch.where(finite, w1, safe0)
        if axis is not None:
            exploded = exploded.reshape(
                [-1 if d == axis else 1 for d in range(w1.dim())])
        return torch.where(exploded, safe0, w1)
    ok = finite.all() if axis is None else finite.all(dim=dims)
    _flag(tag, ~ok, "nonfinite learned weights", cfg)
    _flag(tag, exploded,
          f"learned-weight norm explosion (> {cfg.w_ratio_max}x entry)", cfg)
    return w1


__all__ = ["GuardConfig", "GuardViolation", "POLICIES", "config",
           "collect", "check_tensor", "check_spikes", "guard_learned"]
