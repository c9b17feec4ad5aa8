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

A connection may be backed by compressed connectivity
(`Connection(topology=...)`, an `EncodedTopology` or a params key naming
one): both engines then execute it straight from its IE tables.

A connection may carry a `SynapseProgram` (`Connection(plastic=...)`,
core/plasticity.py), making the edge learnable on-chip. The stepper itself
is forward-only; plasticity runs at run granularity in `core/plan.py`, with
the synapse state carried here in `state[node]["syn:<conn>"]`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.core import faults
from repro_torch.core.neuron import NeuronSpec
from repro_torch.core.plasticity import (SynapseProgram, synapse_init,
                                         validate_synapse_program)
from repro_torch.core.topology import EncodedTopology
from repro_torch.kernels.common import DeviceLike, resolve_device


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
    plastic: optional `SynapseProgram` (core/plasticity.py); the edge's
             weight then learns on-chip under `plan.run` and the updated
             tensor is published in `state[node]["syn:<key>"]["w"]`.
    topology: optional compressed connectivity for this edge — an
             `EncodedTopology` instance, or a string naming one inside
             `params[node]`. The edge then executes straight from the IE
             tables (type-2 FC through `spikemm`, sparse/conv/pool through
             `spikemm_gather`) and no dense weight tensor is read.
             Mutually exclusive with both `plastic` (tables are not
             learnable) and a `weight` override (there is no dense tensor
             to alias).
    """

    src: str
    delay: int = 0
    weight: str = ""
    plastic: Optional[SynapseProgram] = None
    topology: Optional[Any] = None

    def __post_init__(self):
        if not self.src:
            raise ValueError("Connection needs a source name")
        if self.delay < 0:
            raise ValueError(f"negative delay {self.delay} on connection "
                             f"from {self.src!r}")
        if self.topology is not None:
            if not isinstance(self.topology, (str, EncodedTopology)):
                raise TypeError(
                    f"Connection.topology must be an EncodedTopology or a "
                    f"params key, got {type(self.topology).__name__}")
            if self.plastic is not None:
                raise ValueError(
                    f"connection from {self.src!r}: topology-backed edges "
                    "cannot be plastic (IE tables are static configuration)")
            if self.weight:
                raise ValueError(
                    f"connection from {self.src!r}: topology and a weight "
                    "override are mutually exclusive")
        if self.plastic is not None:
            validate_synapse_program(self.plastic)

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

    @classmethod
    def from_topology(cls, src: str, topology: Any,
                      delay: Optional[int] = None) -> "Connection":
        """Edge backed by compressed connectivity. `delay` defaults to the
        topology's own skip delay (Fig. 8c delayed-fire) when it carries
        one, else 0."""
        if delay is None:
            meta = getattr(topology, "meta", None) or {}
            delay = int(meta.get("delay", 0)) \
                if getattr(topology, "kind", "") == "skip" else 0
        return cls(src=src, delay=delay, topology=topology)


def resolve_topology(conn: Connection, node_name: str,
                     params: Dict[str, Any]) -> Optional[EncodedTopology]:
    """The EncodedTopology a connection executes through, or None.

    A string rides as a key into `params[node]`: the topology then lives
    with the rest of the node's parameters."""
    t = conn.topology
    if t is None:
        return None
    if isinstance(t, str):
        t = params.get(node_name, {}).get(t)
        if t is None:
            raise KeyError(
                f"node {node_name!r}: connection {conn.key!r} names topology "
                f"{conn.topology!r} but params[{node_name!r}] has no such "
                "entry")
    if not isinstance(t, EncodedTopology):
        raise TypeError(
            f"node {node_name!r}: params[{conn.topology!r}] is "
            f"{type(t).__name__}, expected EncodedTopology")
    return t


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
    """Neuron states, skip-delay ring buffers, and synapse (plasticity)
    state for every node, on `device` (default the card; pass device="cpu"
    to run on the CPU). Plastic connections need `params` to seed the
    learned weight (trace shapes derive from it); their "w" is the params
    tensor itself, which no update writes into."""
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
        for c in n.connections:
            if c.plastic is None:
                continue
            if params is None:
                raise ValueError(
                    f"node {n.name!r}: connection {c.key!r} is plastic; "
                    "init_state needs params=... to seed its weight")
            s[f"syn:{c.key}"] = synapse_init(
                c.plastic, params[n.name][c.weight_key], batch)
        state[n.name] = s
    return state


def _node_params(n: LayerNode, params: Dict[str, Any]) -> Dict[str, Any]:
    """Node params with custom `Connection.weight` keys aliased onto the
    canonical names, so the built-in integrate conventions pick them up.
    Topology-backed edges alias the canonical name to the EncodedTopology
    itself — `neuron.locacc` routes it through the compressed kernels."""
    p = params.get(n.name, {})
    remap = {("w_self" if c.src == "self" else f"w_{c.src}"): c.weight
             for c in n.connections if c.weight}
    topos = {("w_self" if c.src == "self" else f"w_{c.src}"):
             resolve_topology(c, n.name, params)
             for c in n.connections if c.topology is not None}
    if remap or topos:
        p = dict(p)
        for canon, key in remap.items():
            p[canon] = p[key]
        p.update(topos)
    return p


def step(nodes: List[LayerNode], params: Dict[str, Any],
         state: Dict[str, Any], x_t: torch.Tensor,
         ext: Optional[Dict[str, torch.Tensor]] = None
         ) -> Tuple[Dict[str, Any], torch.Tensor]:
    """One INTEG+FIRE timestep through all nodes (in order).

    `ext` maps feed keys (e.g. "conv1", "conv1@2") to externally supplied
    per-timestep feeds — the plan compiler uses it to run a fallback
    segment whose neighbours were fused out of the time loop. Synapse state
    rides through untouched (plasticity is a run-granularity pass).
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
             if k not in ("out", "ring") and not k.startswith("syn:")},
            current, params.get(n.name, {}).get("neuron"))      # FIRE
        # injected dead/stuck neuron rows (repro_torch.core.faults): the
        # faulty rows poison everything downstream of the emission —
        # recurrence, rings, same-timestep feeds — like a dead core would
        s_out = faults.perturb_output(n.name, s_out)
        ns = dict(ns)
        ns["out"] = s_out
        if "ring" in state[n.name]:
            ring = state[n.name]["ring"]
            ns["ring"] = torch.cat([s_out[None].to(ring.dtype), ring[:-1]],
                                   dim=0)
        for k, v in state[n.name].items():
            if k.startswith("syn:"):
                ns[k] = v
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


__all__ = ["Connection", "LayerNode", "resolve_topology", "state_dtype",
           "init_state", "step", "run"]
