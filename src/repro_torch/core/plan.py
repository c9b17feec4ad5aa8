"""Program compiler: lower an event-driven Program to a fused execution plan.

The port of `repro/core/plan.py`. The stepper (`events.run`) interprets a
Program one timestep at a time. Most Program structure is static, so this
module analyzes it once and emits a plan of *segments*, each executed over
the whole time axis at once. Classification is structural pattern
matching on the neuron IR (`core/neuron.py::NeuronProgram`):

  pattern (on the program)                          FIRE lowering
  ------------------------------------------------  -------------------
  1 state, current-driven, no threshold, membrane    `linrec`
  output
  1 state, current-driven, constant threshold, zero   `lif` (+ `lifrec`
  or subtract reset, spike output                     when self-recurrent)
  2 states {membrane + spike-driven adaptation},      `alif` (+ `alifrec`
  affine threshold in the adaptation, hard reset      when self-recurrent)
  2 states {branch dendrites + sum-driven soma},      branch-integrate
  constant threshold, hard reset                      prologue (`linrec`
                                                      over the branch axis)
                                                      feeding `lif`

The matcher, the segment schedule and `Plan.describe()` (with its TB2xx
codes) are identical to the reference's. Every fused lowering runs on the
hand kernels: `li` on `linrec`, feed-forward `lif` on `lif`, `dhlif` on
`linrec` feeding `lif`, the self-recurrent `lif` on `lifrec`, and `alif`
on `alif` or, self-recurrent, `alifrec`. A recurrent kernel starts from
the node's previous output, `state[node]["out"]`, and the last step of
its spike train becomes the next `out`, so the recurrence carries across
windows and chunks. Segments that match no pattern run through the
port's stepper, as in the reference.

INTEG is hoisted out of the time loop for every fused segment: one
`spikemm` over the (T*B, fan_in) spike matrix per feed; the branch
convention hoists as one spikemm against the branch-flattened weights.
Delayed (`"src@d"`) reads of a fused source are exact: the ring buffer the
stepper would keep is a time-shift of the source's full output, seeded
from the initial ring state.

Not ported yet, each raising NotImplementedError that names its ROADMAP.md
item: numerical guardrails (`guard=`, REPRO_GUARD), fault injection
(REPRO_FAULTS), and learning (plastic connections cannot be built).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import torch

from repro_torch.core import events
from repro_torch.core.neuron import Decay, NeuronProgram
from repro_torch.kernels.common import DeviceLike, check_device, resolve_device
from repro_torch.kernels.alifrec.ops import alif_scan, alifrec_scan
from repro_torch.kernels.lif.ops import lif_scan
from repro_torch.kernels.lifrec.ops import lifrec_scan
from repro_torch.kernels.linrec.ops import linrec
from repro_torch.kernels.spikemm.ops import spikemm

Tensor = torch.Tensor

FUSED_FF = "fused_ff"
FUSED_REC = "fused_rec"
FALLBACK = "fallback"

# FIRE lowering families the pattern matcher can emit
LOWER_LI = "li"
LOWER_LIF = "lif"
LOWER_ALIF = "alif"
LOWER_DHLIF = "dhlif"

# Cross-engine agreement tolerance (fused plan vs stepper, port vs JAX).
#
# The same bound as the reference (repro/core/plan.py): fp32 addition is
# not associative, so two engines that fold the same recurrence in another
# order (an associative scan against a sequential fold, a blocked matmul
# against another blocking) accumulate different roundoff; ~1e-6 has been
# observed on DH-LIF membranes. Use this constant — not ad-hoc atol
# literals — whenever comparing engines.
CROSS_ENGINE_ATOL = 1e-5

_ROADMAP = "ROADMAP.md, Open items 1"


@dataclasses.dataclass(frozen=True)
class Segment:
    """One unit of the lowered schedule, executed over the full time axis."""

    kind: str                  # fused_ff | fused_rec | fallback
    names: Tuple[str, ...]     # node names (fused segments hold exactly one)
    reason: str = ""           # why the planner fell back (diagnostics)
    lower: str = ""            # FIRE kernel family for fused segments
    codes: Tuple[str, ...] = ()  # TB2xx codes, one per merged fallback node


@dataclasses.dataclass(frozen=True)
class Plan:
    segments: Tuple[Segment, ...]

    @property
    def fully_fallback(self) -> bool:
        return all(s.kind == FALLBACK for s in self.segments)

    def describe(self) -> str:
        """Segment schedule, with every fallback's TB-code inline."""
        parts = []
        for s in self.segments:
            tag = f"{s.kind}[{','.join(s.names)}]"
            if s.lower:
                tag += f":{s.lower}"
            if s.reason:
                tag += f"({s.reason})"
            parts.append(tag)
        return " -> ".join(parts)


def _hoist_tag(node: events.LayerNode) -> Optional[str]:
    """INTEG hoist convention: "ff" = per-feed `s @ w` matmuls against each
    connection's weight key, "branch" = the single-feed dendritic einsum
    (fixed key "w_input"). Untagged integrates keep the stepper."""
    return getattr(node.integrate, "hoist", None)


def _match_fire_pattern(prog: NeuronProgram
                        ) -> Tuple[Optional[str], str, str]:
    """Structurally match a NeuronProgram against the fused FIRE kernels.

    Returns (lowering family, "", "") on a match, else
    (None, TB-code, reason). Driven ONLY by program structure."""
    th = prog.threshold
    if not prog.states:
        return None, "TB206", "empty program"
    if th is None:
        sv = prog.states[0]
        if (len(prog.states) == 1 and not sv.branch
                and sv.drive == "current" and prog.output == sv.name):
            return LOWER_LI, "", ""
        return None, "TB206", "unfusable non-spiking program"
    if prog.output != "spikes":
        return None, "TB206", "state readout on a spiking program"
    if prog.reset not in ("zero", "subtract"):
        return None, "TB206", f"reset={prog.reset}"
    mem = next((s for s in prog.states if s.name == th.on), None)
    if mem is None or mem.branch:
        return None, "TB206", "threshold not on a plain membrane state"
    others = [s for s in prog.states if s.name != th.on]
    if mem.drive == "current" and not others and not th.adapt:
        return LOWER_LIF, "", ""
    if prog.reset != "zero":
        # the alif/dhlif kernels implement the hard reset only
        return None, "TB206", "subtract reset on a multi-state program"
    if (mem.drive == "current" and len(others) == 1
            and others[0].drive == "spikes" and not others[0].branch
            and th.adapt == others[0].name):
        return LOWER_ALIF, "", ""
    if (len(others) == 1 and others[0].branch
            and others[0].drive == "current"
            and mem.drive == f"sum:{others[0].name}" and not th.adapt):
        # the prologue feeds the soma the branches' NEW values, which is the
        # interpreter's semantics only when the branch state updates first
        names = [s.name for s in prog.states]
        if names.index(others[0].name) < names.index(mem.name):
            return LOWER_DHLIF, "", ""
        return None, "TB206", "soma declared before its branches"
    return None, "TB206", "program shape matches no fused FIRE kernel"


def _classify(node: events.LayerNode, order: Dict[str, int]
              ) -> Tuple[str, str, str, str]:
    """-> (segment kind, TB-code, fallback reason, lowering family)."""
    hoist = _hoist_tag(node)
    if hoist not in ("ff", "branch"):
        return FALLBACK, "TB202", "integrate not hoistable", ""
    n_self = 0
    for c in node.connections:
        if c.src == "self":
            if c.delay:
                return FALLBACK, "TB203", "delayed self", ""
            n_self += 1
        elif c.src != "input" and order[c.src] >= order[node.name]:
            return FALLBACK, "TB201", "back reference", ""
    if n_self > 1:
        return FALLBACK, "TB204", "multiple self feeds", ""
    try:
        prog = node.neuron.program
    except NotImplementedError:
        return FALLBACK, "TB205", "neuron declares no program", ""
    family, code, why = _match_fire_pattern(prog)
    if family is None:
        return FALLBACK, code, why, ""
    needs_branch = family == LOWER_DHLIF
    if needs_branch != (hoist == "branch"):
        return FALLBACK, "TB207", (
            f"{family} program needs "
            f"{'branch' if needs_branch else 'ff'} integrate, "
            f"got {hoist}"), ""
    if hoist == "branch":
        n_feeds = sum(1 for c in node.connections if c.src != "self")
        if n_feeds != 1:
            return FALLBACK, "TB207", \
                f"branch integrate with {n_feeds} feeds", ""
    if n_self:
        if family == LOWER_LIF and prog.reset != "zero":
            return FALLBACK, "TB208", "recurrent subtract reset", ""
        if family in (LOWER_LIF, LOWER_ALIF):
            return FUSED_REC, "", "", family
        return FALLBACK, "TB208", f"recurrent {family}", ""
    return FUSED_FF, "", "", family


def compile_program(nodes: List[events.LayerNode]) -> Plan:
    """Analyze the node DAG and emit the segment plan."""
    order = {n.name: i for i, n in enumerate(nodes)}
    # Any previous-timestep read of a later node couples the whole Program
    # per-timestep: compile to one stepper segment (exactly events.run).
    for n in nodes:
        for c in n.connections:
            if c.src not in ("input", "self") and order[c.src] >= order[n.name]:
                return Plan((Segment(
                    FALLBACK, tuple(x.name for x in nodes),
                    f"{n.name}: TB201 reads later node {c.src}",
                    codes=("TB201",)),))

    segments: List[Segment] = []
    pending: List[str] = []
    reasons: List[str] = []
    codes: List[str] = []

    def flush():
        if pending:
            segments.append(Segment(FALLBACK, tuple(pending),
                                    "; ".join(reasons), codes=tuple(codes)))
            pending.clear()
            reasons.clear()
            codes.clear()

    for n in nodes:
        kind, code, reason, family = _classify(n, order)
        if kind == FALLBACK:
            pending.append(n.name)
            codes.append(code)
            reasons.append(f"{n.name}: {code} {reason}")
        else:
            flush()
            segments.append(Segment(kind, (n.name,), lower=family))
    flush()
    return Plan(tuple(segments))


# ---------------------------------------------------------------------------
# plan execution
# ---------------------------------------------------------------------------


def _feed_full(outs: Dict[str, Tensor], state: Dict[str, Any], name: str,
               d: int, T: int) -> Tensor:
    """Full-time feed of source `name` delayed by `d` steps.

    feed_t = out_{t-d}; times < 0 come from the source's initial ring
    (zeros when the Program starts cold), the stepper's delayed-fire
    semantics."""
    s_full = outs[name]
    if d == 0:
        return s_full
    ring = state.get(name, {}).get("ring")
    if ring is not None:
        prefix = torch.flip(ring[:d], dims=(0,)).to(s_full.dtype)
    else:                                            # s_{-d} ... s_{-1}
        prefix = s_full.new_zeros((d,) + tuple(s_full.shape[1:]))
    return torch.cat([prefix, s_full], dim=0)[:T]


def _advance_ring(ring: Tensor, out_full: Tensor) -> Tensor:
    """Ring state after the whole run: ring[k] = out_{T-1-k}, seeded from
    the initial ring for T < k."""
    stacked = torch.cat([torch.flip(ring, dims=(0,)),
                         out_full.to(ring.dtype)], dim=0)
    return torch.flip(stacked[-ring.shape[0]:], dims=(0,))


def _as_float(s: Tensor, dtype: torch.dtype) -> Tensor:
    """Integer spike rasters are cast before INTEG (locacc's rule)."""
    return s if s.dtype.is_floating_point else s.to(dtype)


def _hoisted_current(node: events.LayerNode, params: Dict[str, Any],
                     outs: Dict[str, Tensor], state: Dict[str, Any],
                     T: int, B: int) -> Tensor:
    """All-T INTEG: one event-gated spikemm per inbound connection.

    The "branch" convention hoists the dendritic einsum as a single
    spikemm against the branch-flattened (n_in, K*n_out) weight view,
    yielding a (T, B, K, n_out) per-branch current block."""
    if _hoist_tag(node) == "branch":
        conn = next(c for c in node.connections if c.src != "self")
        w = params[node.name]["w_input"]             # (K, n_in, n_out)
        K, n_in, n_out = w.shape
        s = _as_float(_feed_full(outs, state, conn.src, conn.delay, T),
                      w.dtype)
        w2 = w.permute(1, 0, 2).reshape(n_in, K * n_out).contiguous()
        c = spikemm(s.reshape(T * B, -1).contiguous(), w2)
        return c.reshape(T, B, K, n_out)
    cur = None
    for conn in node.connections:
        if conn.src == "self":
            continue
        w = params[node.name][conn.weight_key]
        s = _as_float(_feed_full(outs, state, conn.src, conn.delay, T),
                      w.dtype)
        c = spikemm(s.reshape(T * B, -1).contiguous(),
                    w.contiguous()).reshape(T, B, -1)
        cur = c if cur is None else cur + c
    if cur is None:
        x = outs["input"]
        cur = torch.zeros((T, B, node.out_dim),
                          dtype=events.state_dtype(x.dtype), device=x.device)
    return cur


def _decay_vec(decay: Decay, nparams: Optional[Dict[str, Tensor]], n: int,
               device: torch.device, n_branches: int = 0) -> Tensor:
    """Resolve a program Decay to the kernel-facing contiguous fp32 decay
    tensor: (N,) for per-neuron states, (K, N) for branch states."""
    shape = (n_branches, n) if n_branches else (n,)
    p = (nparams or {}).get(decay.param) if decay.kind != "const" else None
    if p is not None:
        return torch.sigmoid(p.float()).expand(shape).contiguous()
    return torch.full(shape, decay.value, dtype=torch.float32, device=device)


def _self_weight(node: events.LayerNode, params: Dict[str, Any]) -> Tensor:
    conn = next(c for c in node.connections if c.src == "self")
    return params[node.name][conn.weight_key].contiguous()


def _run_fused(node: events.LayerNode, kind: str, lower: str,
               params: Dict[str, Any], outs: Dict[str, Tensor],
               state: Dict[str, Any], new_state: Dict[str, Any],
               T: int, B: int) -> None:
    cur = _hoisted_current(node, params, outs, state, T, B)
    prog = node.neuron.program
    nparams = params.get(node.name, {}).get("neuron")
    th = prog.threshold
    N = node.out_dim
    dev = cur.device
    st = state[node.name]

    if lower == LOWER_LI:
        sv = prog.states[0]
        tau = _decay_vec(sv.decay, nparams, N, dev).to(cur.dtype)
        out, vT = linrec(tau.expand(cur.shape), cur,
                         st[sv.name].contiguous())
        ns = {sv.name: vT}
    elif lower == LOWER_LIF:
        tau = _decay_vec(prog.states[0].decay, nparams, N, dev)
        v0 = st[th.on].contiguous()
        if kind == FUSED_REC:
            out, vT = lifrec_scan(cur, _self_weight(node, params), tau, v0,
                                  st["out"].contiguous(), th.base)
        else:
            out, vT = lif_scan(cur, tau, v0, th.base, prog.reset)
        ns = {th.on: vT}
    elif lower == LOWER_ALIF:
        mem = next(s for s in prog.states if s.name == th.on)
        ad = next(s for s in prog.states if s.name == th.adapt)
        tau = _decay_vec(mem.decay, nparams, N, dev)
        rho = _decay_vec(ad.decay, nparams, N, dev)
        v0, a0 = st[mem.name].contiguous(), st[ad.name].contiguous()
        if kind == FUSED_REC:
            out, vT, aT = alifrec_scan(cur, _self_weight(node, params), tau,
                                       rho, v0, a0, st["out"].contiguous(),
                                       th.base, th.scale)
        else:
            out, vT, aT = alif_scan(cur, tau, rho, v0, a0, th.base,
                                    th.scale)
        ns = {mem.name: vT, ad.name: aT}
    elif lower == LOWER_DHLIF:
        # branch-integrate prologue: the dendrites never reset, so they are
        # a pure linear recurrence -> one linrec over every (b, k, n) lane
        # (the lanes are laid out (B, K*N); elementwise this is the
        # reference's (B*K, N) layout), summed into the soma's LIF kernel.
        mem = next(s for s in prog.states if s.name == th.on)
        br = next(s for s in prog.states if s.branch)
        d0 = st[br.name]                             # (B, K, N)
        K = d0.shape[-2]
        tau_d = _decay_vec(br.decay, nparams, N, dev, n_branches=K)
        d_full, dT = linrec(
            tau_d.to(cur.dtype).reshape(K * N).expand(T, B, K * N),
            cur.reshape(T, B, K * N), d0.reshape(B, K * N).contiguous())
        d4 = d_full.reshape(T, B, K, N)
        # the soma sums its branches in a fixed order, so a lane's result
        # never depends on the shape of the batch it was packed into
        soma_cur = d4[:, :, 0]
        for k in range(1, K):
            soma_cur = soma_cur + d4[:, :, k]
        tau_s = _decay_vec(mem.decay, nparams, N, dev)
        out, vT = lif_scan(soma_cur.contiguous(), tau_s,
                           st[mem.name].contiguous(), th.base)
        ns = {mem.name: vT, br.name: dT.reshape(B, K, N)}
    else:  # pragma: no cover - compile_program only emits known families
        raise ValueError(f"unknown FIRE lowering {lower!r}")

    outs[node.name] = out
    ns["out"] = out[-1]
    if "ring" in st:
        ns["ring"] = _advance_ring(st["ring"], out)
    new_state[node.name] = ns


def _run_fallback(seg: Segment, nodes_by_name: Dict[str, events.LayerNode],
                  params: Dict[str, Any], x: Tensor, outs: Dict[str, Tensor],
                  state: Dict[str, Any], new_state: Dict[str, Any],
                  T: int) -> None:
    seg_nodes = [nodes_by_name[name] for name in seg.names]
    seg_names = set(seg.names)
    st = {name: state[name] for name in seg.names}
    ext: Dict[str, Tensor] = {}
    for n in seg_nodes:
        for c in n.connections:
            if c.src == "self" or c.src in seg_names or c.key in ext:
                continue
            if c.src == "input" and c.delay == 0:
                continue                 # events.step already emits x_t
            ext[c.key] = _feed_full(outs, state, c.src, c.delay, T)
    rec: Dict[str, List[Tensor]] = {name: [] for name in seg.names}
    for t in range(T):
        st, _ = events.step(seg_nodes, params, st, x[t],
                            ext={k: v[t] for k, v in ext.items()})
        for name in seg.names:
            rec[name].append(st[name]["out"])
    outs.update({name: torch.stack(v) for name, v in rec.items()})
    new_state.update(st)


def _refuse_unported(guard) -> None:
    """Raise for the reference's run-time hooks the port does not have
    yet, instead of silently running without them."""
    if guard is not None or os.environ.get("REPRO_GUARD", "off") != "off":
        raise NotImplementedError(
            "numerical guardrails (guard=, REPRO_GUARD) are not ported yet: "
            f"{_ROADMAP}, item 8 (runtime robustness)")
    if os.environ.get("REPRO_FAULTS"):
        raise NotImplementedError(
            "fault injection (REPRO_FAULTS) is not ported yet: "
            f"{_ROADMAP}, item 8 (runtime robustness)")


# ---------------------------------------------------------------------------
# session-state pack/unpack (the serve engine's gather/scatter primitives)
# ---------------------------------------------------------------------------
#
# A `plan.run` state tree is {node: {key: tensor}} where every per-neuron
# leaf carries the batch on axis 0 — except the delay ring, whose layout is
# (depth, batch, n). The serve engine multiplexes many batch-1 streaming
# sessions through one window step by concatenating their states into
# cohort slots along the batch axis and slicing them back out.


def _state_batch_axis(key: str) -> int:
    return 1 if key == "ring" else 0


def state_nbytes(state: Dict[str, Any]) -> int:
    """Total bytes of one state tree — the per-session footprint the serve
    cache budgets against."""
    total = 0
    for v in state.values():
        if isinstance(v, dict):
            total += state_nbytes(v)
        elif isinstance(v, torch.Tensor):
            total += v.numel() * v.element_size()
    return total


def pack_states(states: List[Dict[str, Any]], pad_to: Optional[int] = None
                ) -> Dict[str, Any]:
    """Concatenate per-session state trees into one cohort state.

    Every leaf joins along its batch axis (axis 0; axis 1 for delay
    rings); `pad_to` right-pads the cohort with zero slots up to a fixed
    capacity, so every window step runs at one shape."""
    if not states:
        raise ValueError("pack_states needs at least one state")
    total = sum(next(iter(s.values()))["out"].shape[0] for s in states)
    pad = 0 if pad_to is None else pad_to - total
    if pad < 0:
        raise ValueError(f"pack_states: {total} batch rows exceed "
                         f"pad_to={pad_to}")
    out: Dict[str, Any] = {}
    for node in states[0]:
        nd: Dict[str, Any] = {}
        for k in states[0][node]:
            ax = _state_batch_axis(k)
            parts = [s[node][k] for s in states]
            if pad:
                shape = list(parts[0].shape)
                shape[ax] = pad
                parts.append(parts[0].new_zeros(shape))
            nd[k] = torch.cat(parts, dim=ax)
        out[node] = nd
    return out


def unpack_state(state: Dict[str, Any], index: int,
                 width: int = 1) -> Dict[str, Any]:
    """Slice one session (batch rows [index, index+width)) back out of a
    packed cohort state — the exact inverse of its `pack_states` slot."""
    out: Dict[str, Any] = {}
    for node, nd in state.items():
        out[node] = {
            k: (v[:, index:index + width] if _state_batch_axis(k) == 1
                else v[index:index + width])
            for k, v in nd.items()}
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


@torch.no_grad()
def run(nodes: List[events.LayerNode], params: Dict[str, Any], x: Tensor,
        state: Optional[Dict[str, Any]] = None, record: Tuple[str, ...] = (),
        plan: Optional[Plan] = None, guard: Optional[str] = None,
        device: DeviceLike = "cuda"):
    """Drop-in replacement for `events.run` through the compiled plan.

    x: (T, batch, n_in) on `device` (default the card; pass device="cpu"
    to run on the CPU). Returns (final_state, outputs (T, batch, n_out),
    recorded dict) — equivalent to the stepper within CROSS_ENGINE_ATOL.
    """
    _refuse_unported(guard)
    dev = resolve_device(device)
    check_device("x", x, dev)
    if plan is None:
        plan = compile_program(nodes)
    if plan.fully_fallback:
        return events.run(nodes, params, x, state, record, device=dev)
    T, B = x.shape[0], x.shape[1]
    if state is None:
        state = events.init_state(nodes, B, x.dtype, params, device=dev)
    nodes_by_name = {n.name: n for n in nodes}
    outs: Dict[str, Tensor] = {"input": x}
    new_state = dict(state)
    for seg in plan.segments:
        if seg.kind == FALLBACK:
            _run_fallback(seg, nodes_by_name, params, x, outs, state,
                          new_state, T)
        else:
            _run_fused(nodes_by_name[seg.names[0]], seg.kind, seg.lower,
                       params, outs, state, new_state, T, B)
    return new_state, outs[nodes[-1].name], {r: outs[r] for r in record}


def run_stream(nodes: List[events.LayerNode], params: Dict[str, Any],
               chunks: Iterable[Tensor],
               state: Optional[Dict[str, Any]] = None,
               plan: Optional[Plan] = None, guard: Optional[str] = None,
               device: DeviceLike = "cuda"
               ) -> Iterator[Tuple[Dict[str, Any], Tensor]]:
    """Chunked/streaming execution: yields `(state, outputs)` after each
    (T_chunk, batch, n_in) chunk, carrying neuron state and delay rings
    across chunk boundaries, so concatenating the yielded outputs equals
    the one-shot `run` on the concatenated stream."""
    if plan is None:
        plan = compile_program(nodes)
    for x in chunks:
        state, out, _ = run(nodes, params, x, state=state, plan=plan,
                            guard=guard, device=device)
        yield state, out


__all__ = ["Plan", "Segment", "compile_program", "run", "run_stream",
           "CROSS_ENGINE_ATOL", "state_nbytes", "pack_states",
           "unpack_state", "FUSED_FF", "FUSED_REC", "FALLBACK",
           "LOWER_LI", "LOWER_LIF", "LOWER_ALIF", "LOWER_DHLIF"]
