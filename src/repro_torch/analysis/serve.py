"""TB5xx: static checks over a serve-engine deployment.

A streaming deployment is a (model, EngineConfig) pair; most operational
pathologies are decidable before the first session opens, from exactly
the numbers the engine itself uses:

  TB501 error    cache_bytes below ONE session's state footprint — every
                 cohort gather spills every other tenant to host and
                 restores it next window; the cache degenerates into a
                 per-window host round-trip for the entire fleet.
  TB502 warning  cache_bytes below capacity x footprint — a full cohort
                 cannot stay hot simultaneously, so steady-state serving
                 thrashes the spill path even with zero queue.
  TB503 warning  the compiled plan has fallback (stepper) segments — the
                 resident window step multiplies that per-step cost by
                 every slot of every window; fix the program or accept
                 the throughput.
  TB504 warning  queue_limit (in buffered windows) below cohort capacity
                 — admission can never hold enough work to fill a cohort,
                 capping occupancy below 1 by construction.
  TB505 error    non-positive window / capacity / queue_limit /
                 cache_bytes — the configuration cannot run at all.

`check_serve(nodes, params, cfg)` returns `List[Diagnostic]` like every
other checker; the CLI (`python -m repro_torch.analysis --serve` /
`--all`) lints the shipped models under a representative config.

The port of `repro/analysis/serve.py`, over the port's `EngineConfig`,
`events.init_state` and `plan.state_nbytes`. The one-session state is
built on the parameters' own device (the card's parameters give a state
on the card, read only for its byte count), so the check moves no tensor
between devices and reads no value back.
"""

from __future__ import annotations

from typing import Any, List, Optional

import torch

from repro_torch.analysis.diagnostics import Diagnostic, make


def _params_device(params: Any) -> Optional[torch.device]:
    """The device of the first tensor in the parameter tree, None for a
    tree with none."""
    if isinstance(params, torch.Tensor):
        return params.device
    if isinstance(params, dict):
        for v in params.values():
            dev = _params_device(v)
            if dev is not None:
                return dev
    return None


def session_footprint(nodes: Any, params: Any,
                      dtype: torch.dtype = torch.float32) -> int:
    """Bytes of one session's full state tree (syn entries included), the
    state built on the parameters' own device."""
    from repro_torch.core import events
    from repro_torch.core.plan import state_nbytes
    dev = _params_device(params) or torch.device("cpu")
    return state_nbytes(events.init_state(nodes, 1, dtype, params,
                                          device=dev))


def check_serve(nodes: Any, params: Any, cfg: Any = None,
                plan: Any = None,
                dtype: torch.dtype = torch.float32) -> List[Diagnostic]:
    """TB5xx checks for serving `nodes` under EngineConfig `cfg`.

    `cfg` defaults to `serve.EngineConfig()`; `plan` is compiled from the
    nodes when not supplied. Duck-typed: any object with window/capacity/
    queue_limit/cache_bytes attributes works (tests pass SimpleNamespace
    to reach configurations EngineConfig's own validation refuses).
    """
    from repro_torch.core import plan as plan_mod
    from repro_torch.serve.engine import EngineConfig

    if cfg is None:
        cfg = EngineConfig()
    out: List[Diagnostic] = []

    window = int(getattr(cfg, "window", 0))
    capacity = int(getattr(cfg, "capacity", 0))
    queue_limit: Optional[int] = getattr(cfg, "queue_limit", None)
    cache_bytes: Optional[int] = getattr(cfg, "cache_bytes", None)

    for name, val, floor in (("window", window, 1), ("capacity", capacity, 1)):
        if val < floor:
            out.append(make(
                "TB505", f"cfg.{name}",
                f"{name}={val} must be >= {floor}",
                hint="the engine needs at least one timestep per window "
                     "and one cohort slot"))
    for name, val in (("queue_limit", queue_limit),
                      ("cache_bytes", cache_bytes)):
        if val is not None and val < 1:
            out.append(make(
                "TB505", f"cfg.{name}",
                f"{name}={val} must be positive (or None for unbounded)"))
    if any(d.severity == "error" for d in out):
        return out  # footprint math below assumes a sane config

    fp = session_footprint(nodes, params, dtype)
    if cache_bytes is not None:
        if cache_bytes < fp:
            out.append(make(
                "TB501", "cfg.cache_bytes",
                f"budget {cache_bytes} B < one session footprint {fp} B: "
                "every cohort gather spills the rest of the fleet to host "
                "and restores it next window",
                hint=f"raise cache_bytes to >= {capacity * fp} B "
                     f"(capacity x footprint) or shrink the model state"))
        elif cache_bytes < capacity * fp:
            hot = max(1, cache_bytes // fp)
            out.append(make(
                "TB502", "cfg.cache_bytes",
                f"budget {cache_bytes} B holds ~{hot} hot session(s) but "
                f"cohorts serve {capacity}: steady state thrashes the "
                "spill/restore path every window",
                hint=f"raise cache_bytes to >= {capacity * fp} B or lower "
                     "capacity"))

    if queue_limit is not None and queue_limit < capacity:
        out.append(make(
            "TB504", "cfg.queue_limit",
            f"queue_limit={queue_limit} buffered windows < "
            f"capacity={capacity} slots: admission can never hold enough "
            "work to fill a cohort, capping occupancy at "
            f"{queue_limit}/{capacity}",
            hint="set queue_limit >= capacity (several multiples for "
                 "smooth arrivals)"))

    if plan is None:
        plan = plan_mod.compile_program(list(nodes))
    fb = [s for s in plan.segments if s.kind == plan_mod.FALLBACK]
    if fb:
        names = ",".join(n for s in fb for n in s.names)
        out.append(make(
            "TB503", f"plan:{names}",
            f"{len(fb)} fallback segment(s) inside the resident window "
            "step: per-step stepper cost is paid by every slot of every "
            "window",
            hint="see plan.describe() / the TB2xx codes on each segment "
                 "for why fusion was refused"))
    return out


__all__ = ["check_serve", "session_footprint"]
