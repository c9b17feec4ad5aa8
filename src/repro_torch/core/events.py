"""Event-driven INTEG/FIRE execution engine (paper §IV-A, Fig. 10).

The port of `repro/core/events.py`. One SNN timestep is an INTEG phase
(spike events drive current accumulation) followed by a FIRE phase
(membrane update, spike emission). The engine runs a `Program`: an ordered
list of `LayerNode`s whose inbound edges are `Connection` objects —
source, delay (delayed delivery, Fig. 8c, as a ring buffer of spike
tensors) and the weight-parameter key. The string micro-syntax ("name",
"name@d", "self") goes through `Connection.parse`.

The stepper (`step`/`run`) is the plain per-timestep interpreter: a Python
loop over time. `core/plan.py` lifts most programs off it onto whole-time
kernels; the stepper remains the reference and the fallback.

Not ported yet (each raises NotImplementedError naming its ROADMAP.md
item): plastic connections and compressed-topology connections.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.core.neuron import NeuronSpec
from repro_torch.kernels.common import DeviceLike, resolve_device

_PLASTIC_TODO = ("plastic connections are not ported yet: ROADMAP.md, "
                 "Open items 1, item 5 (plasticity)")
_TOPOLOGY_TODO = ("compressed-topology connections are not ported yet: "
                  "ROADMAP.md, Open items 1, item 6 (compressed topology)")


def _parse_src(src: str) -> Tuple[str, int]:
    if "@" in src:
        name, d = src.split("@")
        return name, int(d)
    return src, 0


@dataclasses.dataclass(frozen=True)
class Connection:
    """One inbound edge of a LayerNode.

    src:     source node name; "input" = the external spike tensor;
             "self" = this node's own output at t-1 (recurrence).
    delay:   delayed-fire depth in timesteps (ring-buffered delivery).
    weight:  params key holding this edge's weight; "" = the canonical
             convention ("w_<src>", "w_self").
    plastic, topology: not ported yet; anything but None raises.
    """

    src: str
    delay: int = 0
    weight: str = ""
    plastic: Optional[Any] = None
    topology: Optional[Any] = None

    def __post_init__(self):
        if not self.src:
            raise ValueError("Connection needs a source name")
        if self.delay < 0:
            raise ValueError(f"negative delay {self.delay} on connection "
                             f"from {self.src!r}")
        if self.plastic is not None:
            raise NotImplementedError(_PLASTIC_TODO)
        if self.topology is not None:
            raise NotImplementedError(_TOPOLOGY_TODO)

    @property
    def key(self) -> str:
        """The feed-dict key — identical to the string spelling."""
        return f"{self.src}@{self.delay}" if self.delay else self.src

    @property
    def weight_key(self) -> str:
        if self.weight:
            return self.weight
        return "w_self" if self.src == "self" else f"w_{self.src}"

    @classmethod
    def parse(cls, spec: Union[str, "Connection"]) -> "Connection":
        """"name" / "name@d" / "self" -> Connection."""
        if isinstance(spec, cls):
            return spec
        name, d = _parse_src(spec)
        return cls(src=name, delay=d)


@dataclasses.dataclass(frozen=True)
class LayerNode:
    """One population of neurons + its inbound connections.

    integrate: (params, inputs: dict[str, Tensor]) -> current  (INTEG stage)
    neuron:    NeuronSpec                                       (FIRE stage)
    inputs:    inbound edges — `Connection` objects or strings; normalized
               at construction: `.connections` holds the Connection view,
               `.inputs` the equivalent feed keys.
    """

    name: str
    neuron: NeuronSpec
    integrate: Callable[[Dict[str, Any], Dict[str, torch.Tensor]],
                        torch.Tensor]
    inputs: Tuple[Union[str, Connection], ...] = ("input",)
    out_dim: int = 0
    connections: Tuple[Connection, ...] = dataclasses.field(init=False)

    def __post_init__(self):
        conns = tuple(Connection.parse(s) for s in self.inputs)
        keys = [c.key for c in conns]
        if len(set(keys)) != len(keys):
            raise ValueError(f"node {self.name!r}: duplicate connection "
                             f"keys {keys}")
        canon = {}
        for c in conns:
            if c.weight and canon.setdefault(
                    "w_self" if c.src == "self" else f"w_{c.src}",
                    c.weight) != c.weight:
                raise ValueError(f"node {self.name!r}: conflicting weight "
                                 f"overrides for source {c.src!r}")
        object.__setattr__(self, "connections", conns)
        object.__setattr__(self, "inputs", tuple(keys))


def state_dtype(dtype) -> torch.dtype:
    """Neuron state must be float: integer spike inputs would otherwise
    build integer membranes that truncate every DIFF step. Callers pass
    x.dtype; ints and bools coerce to float32."""
    return dtype if dtype.is_floating_point else torch.float32


def init_state(nodes: List[LayerNode], batch: int, dtype=torch.float32,
               params: Optional[Dict[str, Any]] = None,
               device: DeviceLike = "cuda"):
    """Neuron states and skip-delay ring buffers for every node, on
    `device` (default the card; pass device="cpu" to run on the CPU)."""
    dev = resolve_device(device)
    dtype = state_dtype(dtype)
    state = {}
    max_delay: Dict[str, int] = {}
    for n in nodes:
        for c in n.connections:
            if c.delay:
                max_delay[c.src] = max(max_delay.get(c.src, 0), c.delay)
    for n in nodes:
        s = n.neuron.init_state((batch, n.out_dim), dtype, dev)
        s["out"] = torch.zeros((batch, n.out_dim), dtype=dtype, device=dev)
        if n.name in max_delay:
            s["ring"] = torch.zeros((max_delay[n.name], batch, n.out_dim),
                                    dtype=dtype, device=dev)
        state[n.name] = s
    return state


def _node_params(n: LayerNode, params: Dict[str, Any]) -> Dict[str, Any]:
    """Node params with custom `Connection.weight` keys aliased onto the
    canonical names, so the built-in integrate conventions pick them up."""
    p = params.get(n.name, {})
    remap = {("w_self" if c.src == "self" else f"w_{c.src}"): c.weight
             for c in n.connections if c.weight}
    if remap:
        p = dict(p)
        for canon, key in remap.items():
            p[canon] = p[key]
    return p


def step(nodes: List[LayerNode], params: Dict[str, Any],
         state: Dict[str, Any], x_t: torch.Tensor,
         ext: Optional[Dict[str, torch.Tensor]] = None
         ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """One INTEG+FIRE timestep through all nodes (in order).

    `ext` maps feed keys (e.g. "conv1", "conv1@2") to externally supplied
    per-timestep feeds — the plan compiler uses it to run a fallback
    segment whose neighbours were fused out of the time loop.
    """
    new_state = dict(state)
    emitted: Dict[str, torch.Tensor] = {"input": x_t}
    for n in nodes:
        feeds = {}
        for c in n.connections:
            if c.src == "self":
                feeds[c.key] = state[n.name]["out"]        # recurrent: t-1
            elif ext is not None and c.key in ext:
                feeds[c.key] = ext[c.key]                  # plan-fused source
            elif c.delay:
                feeds[c.key] = state[c.src]["ring"][c.delay - 1]  # delayed
            elif c.src in emitted:
                feeds[c.key] = emitted[c.src]              # same-timestep FF
            else:
                feeds[c.key] = state[c.src]["out"]         # not yet run: t-1
        current = n.integrate(_node_params(n, params), feeds)  # INTEG
        ns, s_out = n.neuron.fire(
            {k: v for k, v in state[n.name].items()
             if k not in ("out", "ring")},
            current, params.get(n.name, {}).get("neuron"))      # FIRE
        ns = dict(ns)
        ns["out"] = s_out
        if "ring" in state[n.name]:
            ring = state[n.name]["ring"]
            ns["ring"] = torch.cat([s_out[None].to(ring.dtype), ring[:-1]],
                                   dim=0)
        new_state[n.name] = ns
        emitted[n.name] = s_out
    return new_state, emitted[nodes[-1].name]


def run(nodes: List[LayerNode], params: Dict[str, Any], x: torch.Tensor,
        state: Optional[Dict[str, Any]] = None, record: Tuple[str, ...] = (),
        device: DeviceLike = "cuda"):
    """Step the INTEG/FIRE machine over time.

    x: (T, batch, n_in) input spikes (or floats), on `device`.
    Returns (final_state, outputs (T, batch, n_out), recorded dict).
    """
    dev = resolve_device(device)
    if x.device.type != dev.type:
        raise ValueError(f"x lies on {x.device}, expected {dev}")
    if state is None:
        state = init_state(nodes, x.shape[1], x.dtype, params, device=dev)
    outs: List[torch.Tensor] = []
    recs: Dict[str, List[torch.Tensor]] = {r: [] for r in record}
    for t in range(x.shape[0]):
        state, out = step(nodes, params, state, x[t])
        outs.append(out)
        for r in record:
            recs[r].append(state[r]["out"])
    return (state, torch.stack(outs),
            {r: torch.stack(v) for r, v in recs.items()})


__all__ = ["Connection", "LayerNode", "state_dtype", "init_state", "step",
           "run"]
