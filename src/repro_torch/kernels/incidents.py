"""Per-process incident log for the resilient execution runtime.

Every degradation the runtime absorbs — a Pallas kernel falling back to
its reference implementation, a VMEM-model rejection, a numerical
guardrail firing, a serve-loop retry — is recorded here as a structured
`FallbackEvent` instead of (or in addition to) being printed. The log is
the operational story of a run: `repro.kernels.incidents()` answers "did
anything silently degrade?", which is exactly the question an always-on
streaming deployment has to be able to ask.

Policy lives here too: `REPRO_STRICT=1` (see `strict_mode`) turns every
silent degradation into a raised `FallbackError`, which is how CI's fast
tier guarantees the fast paths actually ran. The log is bounded (old
events fall off) and thread-safe (the serve loop and an async checkpoint
writer may both record).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

_MAX_EVENTS = 4096


class FallbackError(RuntimeError):
    """Raised (under REPRO_STRICT=1) instead of silently degrading."""


@dataclasses.dataclass(frozen=True)
class FallbackEvent:
    """One recorded degradation.

    kind:    "dispatch" (kernel fell back a stage), "vmem" (VMEM-model
             rejection), "channel" (implementation-channel router failed),
             "guard" (numerical guardrail fired), "autotune" (candidate or
             kernel skipped in a sweep), "serve" (request retry/degrade).
    family:  kernel family / subsystem the event belongs to.
    stage:   the stage that failed ("pallas", "interpret", ...).
    channel: implementation channel in use, if any (e.g. "sparse").
    dims:    logical dims of the call (shape fingerprint).
    error:   repr() of the underlying exception, or a description.
    """

    kind: str
    family: str
    stage: str
    error: str
    channel: Optional[str] = None
    dims: Dict[str, int] = dataclasses.field(default_factory=dict)
    blocks: Dict[str, int] = dataclasses.field(default_factory=dict)
    time_s: float = dataclasses.field(default_factory=time.time)


_LOCK = threading.Lock()
_LOG: list = []


def record(event: FallbackEvent) -> FallbackEvent:
    with _LOCK:
        _LOG.append(event)
        if len(_LOG) > _MAX_EVENTS:
            del _LOG[: len(_LOG) - _MAX_EVENTS]
    return event


def incidents(family: Optional[str] = None,
              kind: Optional[str] = None) -> Tuple[FallbackEvent, ...]:
    """Query the per-process incident log (newest last)."""
    with _LOCK:
        evs = tuple(_LOG)
    if family is not None:
        evs = tuple(e for e in evs if e.family == family)
    if kind is not None:
        evs = tuple(e for e in evs if e.kind == kind)
    return evs


def clear() -> None:
    with _LOCK:
        _LOG.clear()


# back-compat-friendly alias (docs refer to both spellings)
clear_incidents = clear


def strict_mode() -> bool:
    """REPRO_STRICT=1: degradations raise instead of silently falling back."""
    return os.environ.get("REPRO_STRICT") == "1"


def degrade(kind: str, family: str, stage: str, error: Any, *,
            channel: Optional[str] = None,
            dims: Optional[Dict[str, int]] = None,
            blocks: Optional[Dict[str, int]] = None) -> FallbackEvent:
    """Record a degradation; raise `FallbackError` under REPRO_STRICT=1.

    `error` may be an exception (chained into the strict raise) or a
    description string. Returns the recorded event when not strict.
    """
    ev = record(FallbackEvent(
        kind=kind, family=family, stage=stage,
        error=error if isinstance(error, str) else repr(error),
        channel=channel, dims=dict(dims or {}),
        blocks={k: int(v) for k, v in (blocks or {}).items()}))
    if strict_mode():
        exc = error if isinstance(error, BaseException) else None
        raise FallbackError(
            f"[REPRO_STRICT] {family}: {kind} degradation at stage "
            f"{stage!r}: {ev.error}") from exc
    return ev


__all__ = ["FallbackError", "FallbackEvent", "record", "incidents",
           "clear", "clear_incidents", "strict_mode", "degrade"]
