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
compiled once per engine and the kernels are built once per process. The
JAX engine's step is jitted, where a traced raster routes spikemm's
`auto` to the dense channel; the port's step passes `_traced=True` to
`plan.run` for the same routing, so a window launches the same kernels
whatever its occupancy and adds no occupancy sync.

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

A program with plastic connections serves with frozen weights
(`EngineConfig(learn=False)`, as in the reference): each session's synapse
("syn:") entries stay in its own state tree, are never packed into a cohort
(their weight plane has no batch axis), and come back unchanged.

With `EngineConfig(learn=True)` on a plastic program every session learns
on its own synapses, as the reference's per-session `vmap` of a learning
`plan.run` does; here the `vmap` is written out as a session axis. The
cohort's states, free slots as the zero template, are stacked along the
batch axis, their `syn:` weights into one (S, n_pre, n_post) tensor a
connection (`_stack_sessions`), which `plasticity.apply_learned` hands the
forward as one weight a batch row (the chunked-online contract, per
session). One `plan.run(learn=True)` serves the window for every session:
the plastic connection's INTEG is the session-batched spike product
(`spikemm_sessions`) and its learning pass the session-batched `stdp_seq`
(`stdp_seq_sessions`), one launch each a window whatever the number of
live sessions; the lane scans, the traces and the non-plastic readout run
on the flat batch as they do unbatched. The results are unstacked per
session. Both kernels give each session, bit for bit, what they give its
rows alone, so the isolation invariant holds with learning on. The naive
engine runs the same path a session at a time (S = 1).

Resilience composes as in the reference: `REPRO_FAULTS` / `faults.inject`
and `EngineConfig.guard` (or `REPRO_GUARD`) reach `plan.run` on both
cohorts. The JAX engine caches its jitted step by the active fault spec;
the port has no step cache, so each window reads the spec in effect when
it runs. A window step runs as the reference's jitted step does
(`_traced=True`): a guard's raise policy records and warns instead of
raising. In a learning window the faults and guards act per session (see
`core/plan.py`). Kernel dispatch has no fallback: an injected
`compile_fail` raises `FaultInjectedError` out of `step()`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import events, guards, plasticity
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
    learn:       per-session on-chip plasticity (the `learn=` path of
                 `plan.run`, one weight a session); with False a plastic
                 program serves with frozen weights.
    guard:       numerical guardrail policy for `plan.run` (a policy
                 string or a `GuardConfig`; None defers to REPRO_GUARD).
    """

    window: int = 32
    capacity: int = 8
    queue_limit: Optional[int] = 256
    cache_bytes: Optional[int] = None
    learn: bool = False
    guard: Union[None, str, guards.GuardConfig] = None

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


def _split_syn(state: Dict[str, Any]
               ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Split a session state into (packable core, per-session syn tree)."""
    core: Dict[str, Any] = {}
    syn: Dict[str, Any] = {}
    for node, nd in state.items():
        core[node] = {k: v for k, v in nd.items()
                      if not k.startswith("syn:")}
        s = {k: v for k, v in nd.items() if k.startswith("syn:")}
        if s:
            syn[node] = s
    return core, syn


def _merge_syn(core: Dict[str, Any], syn: Dict[str, Any]) -> Dict[str, Any]:
    out = {node: dict(nd) for node, nd in core.items()}
    for node, s in syn.items():
        out[node].update(s)
    return out


def _stack_sessions(states: List[Dict[str, Any]]) -> Dict[str, Any]:
    """One cohort state of batch-1 session states: the neuron state packed
    along the batch axis (`plan.pack_states`), each `syn:` weight stacked
    into (S, n_pre, n_post) and each trace concatenated along its batch
    axis."""
    cores, syns = zip(*(_split_syn(s) for s in states))
    stacked: Dict[str, Any] = {}
    for node, entries in syns[0].items():
        stacked[node] = {
            key: {k: (torch.stack if k == "w" else torch.cat)(
                [sy[node][key][k] for sy in syns]) for k in syn0}
            for key, syn0 in entries.items()}
    return _merge_syn(plan_mod.pack_states(list(cores)), stacked)


def _sessions_of(state: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """The first n sessions' batch-1 states out of a stacked cohort state:
    the inverse of their `_stack_sessions` slots. Their `syn:` entries are
    copies, not views: a view of the stacked (S, n_pre, n_post) weight
    would keep the whole stack alive while a session's cache entry counts
    its own share only. All of them are copied at once
    (`torch._foreach_copy_`, a multi-tensor copy: a launch or a few for the
    cohort, not one a tensor)."""
    core, syn = _split_syn(state)
    views = [(i, node, key, k, v[i] if k == "w" else v[i:i + 1])
             for i in range(n) for node, entries in syn.items()
             for key, entry in entries.items() for k, v in entry.items()]
    owned = [torch.empty_like(v) for *_, v in views]
    if owned:
        torch._foreach_copy_(owned, [v for *_, v in views])
    syns: List[Dict[str, Any]] = [{} for _ in range(n)]
    for (i, node, key, k, _), t in zip(views, owned):
        syns[i].setdefault(node, {}).setdefault(key, {})[k] = t
    return [_merge_syn(plan_mod.unpack_state(core, i), syns[i])
            for i in range(n)]


class BatchedEngine:
    """Continuous-batching multi-tenant engine (see module docstring)."""

    kind = "batched"

    def __init__(self, nodes: List[events.LayerNode], params: Dict[str, Any],
                 cfg: EngineConfig = EngineConfig(),
                 plan: Optional[plan_mod.Plan] = None,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = "cuda"):
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
        self._learn = cfg.learn and bool(self.plan.plastic)
        self._sid_counter = 0
        # zero template for padding free learning slots (results discarded)
        self._zero_full = None
        if self._learn:
            tmpl = events.init_state(self.nodes, 1, self.dtype, params,
                                     device=self.device)
            self._zero_full = {
                node: {k: ({kk: torch.zeros_like(vv) for kk, vv in v.items()}
                           if isinstance(v, dict) else torch.zeros_like(v))
                       for k, v in nd.items()}
                for node, nd in tmpl.items()}

    def _infer_n_in(self) -> int:
        for n in self.nodes:
            for c in n.connections:
                if c.src == "input":
                    topo = events.resolve_topology(c, n.name, self.params)
                    w = (topo if topo is not None
                         else self.params[n.name][c.weight_key])
                    return int(w.shape[-2])
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

    @torch.no_grad()
    def _run_learning(self, xs: List[np.ndarray],
                      states: List[Dict[str, Any]], slots: int
                      ) -> Tuple[List[Dict[str, Any]], np.ndarray]:
        """One learning window of `slots` sessions (free slots the zero
        template): their states stacked, each session's learned weights its
        connection's weight of its batch row, one `plan.run(learn=True)`.
        Returns the live sessions' new states and the (W, slots, n_out)
        outputs on the host."""
        sts = list(states) + (slots - len(states)) * [self._zero_full]
        stacked = _stack_sessions(sts)
        params = plasticity.apply_learned(self.nodes, self.params, stacked)
        ns, out, _ = plan_mod.run(self.nodes, params,
                                  self._window(xs, slots), state=stacked,
                                  plan=self.plan, learn=True,
                                  guard=self.cfg.guard, device=self.device,
                                  _traced=True)
        out_np = out.cpu().numpy()              # one transfer per window
        return _sessions_of(ns, len(states)), out_np

    @torch.no_grad()     # serving builds no graph, whatever params require
    def _run_cohort(self, cohort: List[Tuple[Session, np.ndarray, int]],
                    states: List[Dict[str, Any]]
                    ) -> Tuple[List[Dict[str, Any]], List[np.ndarray]]:
        C = self.cfg.capacity
        if self._learn:
            # the session axis: every slot owns its learned weights
            news, out_np = self._run_learning([xw for _, xw, _ in cohort],
                                              states, C)
            return news, [out_np[:, i, :] for i in range(len(cohort))]
        # flat path: sessions concatenated along the batch axis, padded to
        # capacity with zero slots whose results are discarded; syn entries
        # stay per session
        cores, syns = zip(*(_split_syn(s) for s in states))
        packed = plan_mod.pack_states(list(cores), pad_to=C)
        x = self._window([xw for _, xw, _ in cohort], C)
        ns, out, _ = plan_mod.run(self.nodes, self.params, x, state=packed,
                                  plan=self.plan, learn=False,
                                  guard=self.cfg.guard, device=self.device,
                                  _traced=True)
        out_np = out.cpu().numpy()              # one transfer per window
        return ([_merge_syn(plan_mod.unpack_state(ns, i), syn)
                 for i, syn in enumerate(syns)],
                [out_np[:, i, :] for i in range(len(cohort))])


class NaiveEngine(BatchedEngine):
    """One-session-at-a-time baseline: same scheduler, cache, and
    semantics, but each served session pays its own B=1 window."""

    kind = "naive"

    @torch.no_grad()
    def _run_cohort(self, cohort, states):
        news: List[Dict[str, Any]] = []
        outs: List[np.ndarray] = []
        for (_, xw, _), state in zip(cohort, states):
            if self._learn:
                (ns,), out_np = self._run_learning([xw], [state], 1)
                news.append(ns)
                outs.append(out_np[:, 0, :])
                continue
            core, syn = _split_syn(state)
            ns, out, _ = plan_mod.run(self.nodes, self.params,
                                      self._window([xw], 1), state=core,
                                      plan=self.plan, learn=False,
                                      guard=self.cfg.guard,
                                      device=self.device, _traced=True)
            news.append(_merge_syn(ns, syn))
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
