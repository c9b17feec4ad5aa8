"""TB1xx: static checks over the events Program DAG and its IRs.

The port of `repro/analysis/program.py`, over the port's own IR
(`core/events.py`, `core/neuron.py`, `core/plasticity.py`); weight shapes
are read from the tensors' `.shape`, never their values.

Checks the `LayerNode` graph, each node's `NeuronProgram`, and each
plastic edge's `SynapseProgram` without running anything: width/shape
inference over the DAG, zero-delay cycles, dead or unreachable nodes,
unread state/trace variables, learned-parameter key collisions, plastic
edges bound to missing weight tensors, and degenerate decay/threshold
configurations that `validate_program` / `validate_synapse_program`
deliberately accept (they gate structure, not fitness).

Shape checks are params-gated: pass the params pytree to `check_nodes`
and every weight tensor is checked against the widths the DAG implies.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Set, Tuple

from repro_torch.core.events import LayerNode
from repro_torch.core.neuron import NeuronProgram, validate_program
from repro_torch.core.plasticity import SynapseProgram, validate_synapse_program

from repro_torch.analysis.diagnostics import Diagnostic, make

DEFAULT_EXTERNAL: Tuple[str, ...] = ("input",)


def _node_program(node: LayerNode) -> Optional[NeuronProgram]:
    try:
        return node.neuron.program
    except NotImplementedError:
        return None


# ---------------------------------------------------------------------------
# NeuronProgram checks
# ---------------------------------------------------------------------------


def check_program(prog: NeuronProgram, site: str = "program") -> List[Diagnostic]:
    """TB100/102/105/108/109 over one neuron program."""
    out: List[Diagnostic] = []
    try:
        validate_program(prog)
    except ValueError as e:
        out.append(make("TB100", site, str(e)))
        return out  # downstream checks assume structural validity

    # TB102: two learned decays bound to one params key
    seen: Dict[str, str] = {}
    for sv in prog.states:
        if sv.decay.kind != "const" and sv.decay.param:
            if sv.decay.param in seen:
                out.append(make(
                    "TB102", f"{site}.{sv.name}",
                    f"decay param {sv.decay.param!r} already bound by state "
                    f"{seen[sv.decay.param]!r}",
                    hint="give each learned decay its own params key"))
            else:
                seen[sv.decay.param] = sv.name

    # TB105: states nothing ever reads
    read: Set[str] = set()
    if prog.output != "spikes":
        read.add(prog.output)
    if prog.threshold is not None:
        read.add(prog.threshold.on)
        if prog.threshold.adapt:
            read.add(prog.threshold.adapt)
    for sv in prog.states:
        if sv.drive.startswith("sum:"):
            read.add(sv.drive[4:])
    for sv in prog.states:
        if sv.name not in read:
            out.append(make(
                "TB105", f"{site}.{sv.name}",
                "state is never read (not the output, not thresholded, "
                "not a branch-sum source)",
                hint="drop the state or wire it into the output/threshold"))

    # TB108: constant decay outside (0, 1]
    for sv in prog.states:
        if sv.decay.kind == "const" and not (0.0 < sv.decay.value <= 1.0):
            out.append(make(
                "TB108", f"{site}.{sv.name}",
                f"constant decay {sv.decay.value} outside (0, 1]",
                hint="decays in (0, 1] keep the membrane bounded"))

    # TB109: threshold that can never gate meaningfully
    th = prog.threshold
    if th is not None:
        if th.base <= 0.0 and not th.adapt:
            out.append(make(
                "TB109", site,
                f"threshold base {th.base} <= 0 with no adaptation: every "
                "positive membrane fires",
                hint="set base > 0 or add an adaptation state"))
        if th.adapt and th.scale == 0.0:
            out.append(make(
                "TB109", site,
                f"threshold adapts on {th.adapt!r} with scale=0: the "
                "adaptation state has no effect",
                hint="set scale != 0 or drop adapt"))
    return out


# ---------------------------------------------------------------------------
# SynapseProgram checks
# ---------------------------------------------------------------------------


def check_synapse(sp: SynapseProgram, site: str = "synapse") -> List[Diagnostic]:
    """TB100/102/106/108 over one synapse program."""
    out: List[Diagnostic] = []
    try:
        validate_synapse_program(sp)
    except ValueError as e:
        out.append(make("TB100", site, str(e)))
        return out

    seen: Dict[str, str] = {}
    for tr in sp.traces:
        if tr.decay.kind != "const" and tr.decay.param:
            if tr.decay.param in seen:
                out.append(make(
                    "TB102", f"{site}.{tr.name}",
                    f"trace decay param {tr.decay.param!r} already bound by "
                    f"trace {seen[tr.decay.param]!r}",
                    hint="give each learned trace decay its own params key"))
            else:
                seen[tr.decay.param] = tr.name

    used: Set[str] = set()
    for term in sp.terms:
        used.update(term.pre)
        used.update(term.post)
    for tr in sp.traces:
        if tr.name not in used:
            out.append(make(
                "TB106", f"{site}.{tr.name}",
                "trace appears in no update term",
                hint="drop the trace or reference it from an UpdateTerm"))

    for tr in sp.traces:
        if tr.decay.kind == "const" and not (0.0 < tr.decay.value <= 1.0):
            out.append(make(
                "TB108", f"{site}.{tr.name}",
                f"constant trace decay {tr.decay.value} outside (0, 1]",
                hint="1.0 accumulates, (0, 1) decays; <= 0 or > 1 diverges"))
    return out


# ---------------------------------------------------------------------------
# Node-graph checks
# ---------------------------------------------------------------------------


def _shape_of(w: Any) -> Optional[Tuple[int, ...]]:
    shape = getattr(w, "shape", None)
    if shape is None:
        return None
    try:
        return tuple(int(d) for d in shape)
    except TypeError:
        return None


def _check_weight_shapes(n: LayerNode, prog: Optional[NeuronProgram],
                         node_params: Mapping[str, Any],
                         widths: Mapping[str, int]) -> List[Diagnostic]:
    """TB110 under the built-in hoist conventions (ff / branch)."""
    out: List[Diagnostic] = []
    hoist = getattr(n.integrate, "hoist", None)
    if hoist not in ("ff", "branch"):
        return out  # custom integrate: weight layout is its own contract
    for c in n.connections:
        site = f"{n.name}.{c.key}"
        if getattr(c, "topology", None) is not None:
            # topology-backed edge: shape lives on the encoding, not a
            # dense weight tensor — check (n_pre, n_post) instead
            topo = c.topology
            if isinstance(topo, str):
                topo = node_params.get(topo)
            shape = _shape_of(topo)
            src_dim = (widths.get(n.name) if c.src == "self"
                       else widths.get(c.src))
            if shape is not None and (
                    shape[1] != n.out_dim
                    or (src_dim is not None and shape[0] != src_dim)):
                out.append(make(
                    "TB110", site,
                    f"topology has shape {shape}, expected "
                    f"({src_dim if src_dim is not None else '?'}, "
                    f"{n.out_dim})"))
            continue
        w = node_params.get(c.weight_key)
        if w is None:
            out.append(make(
                "TB110", site,
                f"integrate convention {hoist!r} reads weight "
                f"{c.weight_key!r} but params[{n.name!r}] has no such key",
                hint="add the tensor or set Connection.weight to the "
                     "key that holds it"))
            continue
        shape = _shape_of(w)
        if shape is None:
            continue
        src_dim = widths.get(n.name) if c.src == "self" else widths.get(c.src)
        if hoist == "ff":
            want = (src_dim, n.out_dim)
            ok = (len(shape) == 2 and shape[1] == n.out_dim
                  and (src_dim is None or shape[0] == src_dim))
            if not ok:
                out.append(make(
                    "TB110", site,
                    f"weight {c.weight_key!r} has shape {shape}, expected "
                    f"({want[0] if want[0] is not None else '?'}, {want[1]})"))
        else:  # branch
            kb = prog.n_branches if prog is not None else None
            ok = (len(shape) == 3 and shape[2] == n.out_dim
                  and (kb is None or shape[0] == kb)
                  and (src_dim is None or shape[1] == src_dim))
            if not ok:
                out.append(make(
                    "TB110", site,
                    f"weight {c.weight_key!r} has shape {shape}, expected "
                    f"(n_branches={kb if kb is not None else '?'}, "
                    f"{src_dim if src_dim is not None else '?'}, "
                    f"{n.out_dim})"))
    return out


def _zero_delay_cycles(nodes: Sequence[LayerNode]) -> List[List[str]]:
    """Cycles in the zero-delay cross-node feed graph (self edges excluded)."""
    names = {n.name for n in nodes}
    edges: Dict[str, List[str]] = {n.name: [] for n in nodes}
    for n in nodes:
        for c in n.connections:
            if c.delay == 0 and c.src != "self" and c.src in names:
                edges[c.src].append(n.name)
    cycles: List[List[str]] = []
    color: Dict[str, int] = {}
    stack: List[str] = []

    def visit(v: str) -> None:
        color[v] = 1
        stack.append(v)
        for w in edges[v]:
            if color.get(w, 0) == 0:
                visit(w)
            elif color.get(w) == 1:
                cycles.append(stack[stack.index(w):] + [w])
        stack.pop()
        color[v] = 2

    for n in nodes:
        if color.get(n.name, 0) == 0:
            visit(n.name)
    return cycles


def check_nodes_graph(nodes: Sequence[LayerNode],
                      params: Optional[Dict[str, Any]] = None,
                      external: Sequence[str] = DEFAULT_EXTERNAL
                      ) -> List[Diagnostic]:
    """TB1xx + TB231/232 over a node graph (no plan compilation)."""
    out: List[Diagnostic] = []
    names = [n.name for n in nodes]
    name_set = set(names)
    ext = set(external)

    dupes = {x for x in names if names.count(x) > 1}
    for d in sorted(dupes):
        out.append(make("TB100", d, "duplicate node name"))
    if dupes:
        return out

    widths = {n.name: n.out_dim for n in nodes}

    # TB101 / TB111 / per-node programs
    for n in nodes:
        if n.out_dim <= 0:
            out.append(make(
                "TB111", n.name, f"out_dim={n.out_dim} is not positive",
                hint="LayerNode needs its width for shape inference and "
                     "kernel lowering"))
        for c in n.connections:
            if c.src != "self" and c.src not in name_set and c.src not in ext:
                out.append(make(
                    "TB101", f"{n.name}.{c.key}",
                    f"source {c.src!r} is neither a node nor a declared "
                    f"external input {sorted(ext)}",
                    hint="fix the name or pass external=(...) to the check"))
        prog = _node_program(n)
        if prog is not None:
            out.extend(check_program(prog, site=n.name))

        node_params = (params or {}).get(n.name, {})

        # TB107: plastic edges need their weight seeded
        if params is not None:
            for c in n.connections:
                if c.plastic is not None and c.weight_key not in node_params:
                    out.append(make(
                        "TB107", f"{n.name}.{c.key}",
                        f"plastic edge learns {c.weight_key!r} but "
                        f"params[{n.name!r}] does not define it",
                        hint="seed the weight in params; init_state will "
                             "fail without it"))

        # TB231/232: weight-key aliasing hazards under chunked-online learning
        plastic_keys: Dict[str, str] = {}
        static_keys: Dict[str, str] = {}
        for c in n.connections:
            (plastic_keys if c.plastic is not None else static_keys)\
                .setdefault(c.weight_key, c.key)
        for c in n.connections:
            if c.plastic is None:
                continue
            first = plastic_keys.get(c.weight_key)
            if first is not None and first != c.key:
                out.append(make(
                    "TB231", f"{n.name}.{c.key}",
                    f"plastic edges {first!r} and {c.key!r} both learn "
                    f"weight {c.weight_key!r}: their updates overwrite each "
                    "other (last writer wins per chunk)",
                    hint="give each plastic edge its own weight key"))
            if c.weight_key in static_keys:
                out.append(make(
                    "TB232", f"{n.name}.{c.key}",
                    f"weight {c.weight_key!r} is learned here but also read "
                    f"by non-plastic edge {static_keys[c.weight_key]!r}; "
                    "the alias sees updated values mid-window",
                    hint="alias deliberately (weight sharing) or split keys"))
            out.extend(check_synapse(c.plastic, site=f"{n.name}.{c.key}"))

        if params is not None:
            out.extend(_check_weight_shapes(n, prog, node_params, widths))

    # TB103: zero-delay cross-node cycles
    for cyc in _zero_delay_cycles(nodes):
        out.append(make(
            "TB103", cyc[0],
            "zero-delay cycle " + " -> ".join(cyc) + ": later edges read "
            "stale t-1 outputs, silently, in declaration order",
            hint="add delay=1 on one edge to make the loop explicit"))

    # TB104: unreachable from any external input; dead outputs
    fed_by_ext = {n.name for n in nodes
                  for c in n.connections if c.src in ext}
    reach = set(fed_by_ext)
    frontier = list(fed_by_ext)
    consumers: Dict[str, List[str]] = {n.name: [] for n in nodes}
    for n in nodes:
        for c in n.connections:
            if c.src in name_set and c.src != n.name:
                consumers[c.src].append(n.name)
    while frontier:
        v = frontier.pop()
        for w in consumers[v]:
            if w not in reach:
                reach.add(w)
                frontier.append(w)
    for n in nodes:
        if n.name not in reach:
            out.append(make(
                "TB104", n.name,
                "no path from any external input reaches this node",
                hint="wire it to an input (directly or transitively) or "
                     "drop it"))
        elif not consumers[n.name] and nodes and n.name != nodes[-1].name:
            out.append(make(
                "TB104", n.name,
                "output feeds nothing and the node is not the terminal "
                "(last-declared) readout",
                hint="consume its output or move it last if it is a readout"))
    return out


__all__ = ["check_program", "check_synapse", "check_nodes_graph",
           "DEFAULT_EXTERNAL"]
