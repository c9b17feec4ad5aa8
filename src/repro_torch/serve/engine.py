"""Multi-tenant streaming serve engine over one `plan.run` window step.

The port of `repro/serve/engine.py` (the flat inference path). TaiBai
amortizes one resident program across many concurrent spike streams; this
is the software analogue. One compiled plan serves every open session: on
each window boundary the scheduler packs whichever sessions have a
runnable window into fixed cohort slots, the engine gathers their state
out of the LRU cache (`plan.pack_states`), runs one `plan.run` window on
the engine's device, scatters the per-slot results back
(`plan.unpack_state`), and retires/admits sessions for the next window.
Free slots are zero-padded and their results discarded, so every window
runs at one shape.

PyTorch runs the step eagerly, so there is no step cache: the plan is
compiled once per engine and the kernels are built once per process.

  * `BatchedEngine` — the continuous-batching engine: sessions
    concatenated along the batch axis.
  * `NaiveEngine` — the one-session-at-a-time baseline: same scheduler,
    same cache, same semantics, but every served session pays its own B=1
    window.

Isolation invariant: a session's output trajectory and final state are
bit-identical whether it runs alone, interleaved with strangers, or is
evicted to host and restored mid-stream. The flat path earns this because
every per-slot computation in the kernels is row-independent (the spike
matmul sums each row in a fixed order with no split-K; the recurrences
are per-lane) and solo and packed cohorts run at the same shape;
evict/restore because spill is a pure device<->host copy.

Not ported yet: `learn=True` (the per-session vmapped plasticity path)
and `guard=`; both raise NotImplementedError naming their ROADMAP.md
items.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import events
from repro_torch.core import plan as plan_mod
from repro_torch.kernels.common import DeviceLike, check_device, resolve_device
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.sessions import Session, StateCache


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Knobs for the streaming engines.

    window:      scheduling quantum in timesteps.
    capacity:    cohort slots — max sessions per window step.
    queue_limit: admission bound, in buffered-but-unserved windows summed
                 over all sessions; a submit that would exceed it is
                 rejected (backpressure). None = unbounded.
    cache_bytes: hot-state byte budget for the LRU cache; LRU sessions
                 spill to host beyond it. None = unbounded.
    learn:       per-session on-chip plasticity (not ported yet: raises).
    guard:       numerical guardrail policy (not ported yet: raises).
    """

    window: int = 32
    capacity: int = 8
    queue_limit: Optional[int] = 256
    cache_bytes: Optional[int] = None
    learn: bool = False
    guard: Optional[str] = None

    def __post_init__(self):
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if self.capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {self.capacity}")


def _check_params(params: Dict[str, Any], device: torch.device,
                  path: str = "params") -> None:
    for k, v in params.items():
        if isinstance(v, dict):
            _check_params(v, device, f"{path}[{k!r}]")
        elif isinstance(v, torch.Tensor):
            check_device(f"{path}[{k!r}]", v, device)


class BatchedEngine:
    """Continuous-batching multi-tenant engine (see module docstring)."""

    kind = "batched"

    def __init__(self, nodes: List[events.LayerNode], params: Dict[str, Any],
                 cfg: EngineConfig = EngineConfig(),
                 plan: Optional[plan_mod.Plan] = None,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = "cuda"):
        if cfg.learn:
            raise NotImplementedError(
                "EngineConfig(learn=True), the per-session plasticity path, "
                "is not ported yet: ROADMAP.md, Open items 1, item 7 "
                "(plasticity in serving)")
        plan_mod._refuse_unported(cfg.guard)
        self.device = resolve_device(device)
        _check_params(params, self.device)
        self.nodes = list(nodes)
        self.params = params
        self.cfg = cfg
        self.plan = plan if plan is not None \
            else plan_mod.compile_program(self.nodes)
        self.dtype = events.state_dtype(dtype)
        self.n_in = self._infer_n_in()
        self.n_out = self.nodes[-1].out_dim
        self.metrics = ServeMetrics()
        self.scheduler = Scheduler(cfg.window, self.n_in,
                                   queue_limit=cfg.queue_limit,
                                   metrics=self.metrics)
        self.cache = StateCache(cfg.cache_bytes, metrics=self.metrics,
                                device=self.device)
        self._sid_counter = 0

    def _infer_n_in(self) -> int:
        for n in self.nodes:
            for c in n.connections:
                if c.src == "input":
                    return int(self.params[n.name][c.weight_key].shape[-2])
        raise ValueError("no node reads 'input'; cannot infer n_in")

    # -- lifecycle ----------------------------------------------------------

    def open(self, sid: Optional[str] = None) -> str:
        """Open a streaming session with fresh state; returns its id."""
        if sid is None:
            sid = f"s{self._sid_counter}"
            self._sid_counter += 1
        self.scheduler.open(sid)
        state = events.init_state(self.nodes, 1, self.dtype, self.params,
                                  device=self.device)
        self.cache.put(sid, state)
        return sid

    def submit(self, sid: str, chunk: np.ndarray) -> bool:
        """Buffer (T, n_in) input steps; False = backpressure (rejected)."""
        return self.scheduler.submit(sid, chunk)

    def close(self, sid: str) -> None:
        """End of stream: remaining buffered steps still run (the final
        partial window is zero-padded and its outputs trimmed)."""
        self.scheduler.close(sid)

    def finished(self, sid: str) -> bool:
        return self.scheduler.sessions[sid].finished

    def outputs(self, sid: str) -> np.ndarray:
        """All output steps produced so far, (steps, n_out)."""
        s = self.scheduler.sessions[sid]
        if not s.outputs:
            return np.zeros((0, self.n_out), np.float32)
        return np.concatenate(s.outputs, axis=0)

    def state_of(self, sid: str) -> Dict[str, Any]:
        """The session's current state tree (restored to the device)."""
        return self.cache.get(sid)

    def retire(self, sid: str) -> np.ndarray:
        """Drop a finished (or abandoned) session; returns its outputs."""
        out = self.outputs(sid)
        self.cache.drop(sid)
        self.scheduler.sessions.pop(sid, None)
        return out

    # -- execution ----------------------------------------------------------

    def step(self) -> int:
        """Run one cohort window; returns the number of sessions served.
        The outputs are copied to the host, so the window has finished on
        the device when this returns."""
        self.metrics.queue_depth.observe(self.scheduler.ready_count)
        cohort = self.scheduler.next_cohort(self.cfg.capacity)
        if not cohort:
            return 0
        t0 = time.perf_counter()
        states = [self.cache.get(s.sid) for s, _, _ in cohort]
        new_states, outs = self._run_cohort(cohort, states)
        for (s, _, _), ns in zip(cohort, new_states):
            self.cache.put(s.sid, ns)
        for (s, _, valid), out in zip(cohort, outs):
            s.outputs.append(out[:valid])
        dt = time.perf_counter() - t0
        self.metrics.bump("windows_run")
        self.metrics.bump("session_windows", len(cohort))
        self.metrics.bump("steps_run", sum(v for _, _, v in cohort))
        self.metrics.window_latency_s.observe(dt)
        self.metrics.occupancy.observe(len(cohort) / self.cfg.capacity)
        return len(cohort)

    def drain(self) -> int:
        """Step until no session is schedulable; returns windows run."""
        n = 0
        while self.step():
            n += 1
        return n

    def stats(self) -> Dict[str, Any]:
        snap = self.metrics.snapshot()
        snap.update(engine=self.kind, window=self.cfg.window,
                    capacity=self.cfg.capacity,
                    cache_hot_bytes=self.cache.hot_bytes,
                    cache_spilled=len(self.cache.spilled),
                    sessions_open=len(self.scheduler.sessions))
        return snap

    def publish_metrics(self) -> None:
        """Snapshot onto the incident log (kind="serve", stage="metrics")."""
        self.metrics.publish(family=self.kind)

    # cohort execution — the part engines differ in ------------------------

    def _window(self, xs: List[np.ndarray], slots: int) -> torch.Tensor:
        """(W, slots, n_in) input on the device; slot i holds xs[i]."""
        x = np.zeros((self.cfg.window, slots, self.n_in), np.float32)
        for i, xw in enumerate(xs):
            x[:, i, :] = xw
        return torch.from_numpy(x).to(device=self.device, dtype=self.dtype)

    def _run_cohort(self, cohort: List[Tuple[Session, np.ndarray, int]],
                    states: List[Dict[str, Any]]
                    ) -> Tuple[List[Dict[str, Any]], List[np.ndarray]]:
        # flat path: sessions concatenated along the batch axis, padded to
        # capacity with zero slots whose results are discarded
        C = self.cfg.capacity
        packed = plan_mod.pack_states(states, pad_to=C)
        x = self._window([xw for _, xw, _ in cohort], C)
        ns, out, _ = plan_mod.run(self.nodes, self.params, x, state=packed,
                                  plan=self.plan, device=self.device)
        out_np = out.cpu().numpy()              # one transfer per window
        return ([plan_mod.unpack_state(ns, i) for i in range(len(cohort))],
                [out_np[:, i, :] for i in range(len(cohort))])


class NaiveEngine(BatchedEngine):
    """One-session-at-a-time baseline: same scheduler, cache, and
    semantics, but each served session pays its own B=1 window."""

    kind = "naive"

    def _run_cohort(self, cohort, states):
        news: List[Dict[str, Any]] = []
        outs: List[np.ndarray] = []
        for (_, xw, _), state in zip(cohort, states):
            ns, out, _ = plan_mod.run(self.nodes, self.params,
                                      self._window([xw], 1), state=state,
                                      plan=self.plan, device=self.device)
            news.append(ns)
            outs.append(out.cpu().numpy()[:, 0, :])
        return news, outs


def make_engine(nodes, params, cfg: EngineConfig = EngineConfig(),
                kind: str = "batched", **kw) -> BatchedEngine:
    """Factory: kind = "batched" (continuous batching) | "naive".
    `device` (default "cuda") and the other keywords go to the engine."""
    cls = {"batched": BatchedEngine, "naive": NaiveEngine}.get(kind)
    if cls is None:
        raise ValueError(f"unknown engine kind {kind!r}; "
                         "expected 'batched' or 'naive'")
    return cls(nodes, params, cfg, **kw)


__all__ = ["EngineConfig", "BatchedEngine", "NaiveEngine", "make_engine"]
