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

Synapse programs (`core/plasticity.py::SynapseProgram`, attached to a
`Connection(plastic=...)`) are matched the same way: a rule of at most four
traces and four update terms lowers to the `stdp_seq` kernel — trace DIFFs
hoisted through all-T `linrec`, then every outer-product update term
applied over the window in one launch — while larger rules (TB210) run
through the per-step interpreter (`plasticity.synapse_run` over the
realized spike trains). Either way, on-chip learning runs *inside*
`plan.run` (and, under REPRO_SNN_ENGINE=stepper, as the same pass after the
interpreted forward): within one run window the forward uses the entry
weights, and the learned weight + final traces are published in
`state[node]["syn:<conn>"]` (chunked-online semantics; merge with
`plasticity.apply_learned` between windows). The learned weight is a new
tensor: params and the entry state are never written. A plastic weight
with a leading batch axis, (B, n_pre, n_post), is one weight a batch row
(the serve engine's learning cohort, a session a row): its INTEG runs on
`spikemm_sessions` and its `stdp_seq` lowering on `stdp_seq_sessions`,
each row against its own weight; everything else runs on the flat batch.

The matchers, the segment schedule and `Plan.describe()` (with its TB2xx
codes and its `| learn` tag) are identical to the reference's. Every fused
lowering runs on the hand kernels: `li` on `linrec`, feed-forward `lif` on
`lif`, `dhlif` on `linrec` feeding `lif`, the self-recurrent `lif` on
`lifrec`, and `alif` on `alif` or, self-recurrent, `alifrec`. A recurrent kernel starts from
the node's previous output, `state[node]["out"]`, and the last step of
its spike train becomes the next `out`, so the recurrence carries across
windows and chunks. Segments that match no pattern run through the
port's stepper, as in the reference.

INTEG is hoisted out of the time loop for every fused segment: one
`spikemm` over the (T*B, fan_in) spike matrix per feed (its dense or its
block-sparse channel, by occupancy); the branch convention hoists as one
spikemm against the branch-flattened weights. A topology-backed
connection hoists through its compressed tables instead
(`EncodedTopology.apply_spikes`: `spikemm_gather`, or spikemm for type-2
FC).
Delayed (`"src@d"`) reads of a fused source are exact: the ring buffer the
stepper would keep is a time-shift of the source's full output, seeded
from the initial ring state.

Env knobs: REPRO_SNN_ENGINE = plan | stepper | auto (auto = plan; set
`stepper` to force the interpreted engine, `events.run`, e.g. when
bisecting a numerics difference). REPRO_SNN_EXPLAIN=1 prints every compiled
schedule (`Plan.describe()`) as Programs are lowered. A bad value of either
raises the reference's ValueError.

Resilience hooks, at the reference's places: active faults (REPRO_FAULTS
/ `faults.inject`, `core/faults.py`) perturb the input raster and the weight
planes once at the run's entry and each node's output inside both engines,
identically; REPRO_GUARD (or `run(guard=...)`) arms the numerical
guardrails (`core/guards.py`) on the input, on every segment's output and
new state, on the stepper's output and on each window's learned weights.
Their flags are read once a run. In a learning serve window (a plastic
weight with a session axis) the weight faults draw one session's mask and
every guard acts per session, as under the reference's per-session vmap.

REPRO_CHECK = off | warn | raise runs the compile-time verifier
(`repro_torch.analysis`) once at the end of every `compile_program`, where
the reference runs it: warn logs warnings and worse on the kernel incident
log (kind "check", the TB code as the stage), raise raises
`analysis.DiagnosticError` on errors. A plan compiled once is checked
once; `run` with a compiled plan, and so every served window, checks
nothing. The checks read shapes, never values: they launch nothing and
read nothing back from the card.
"""

from __future__ import annotations

import dataclasses
import os
from typing import (Any, Dict, Iterable, Iterator, List, Optional, Tuple,
                    Union)

import torch

from repro_torch.core import events, faults, guards, plasticity
from repro_torch.core.neuron import Decay, NeuronProgram, decay_array
from repro_torch.kernels.incidents import FallbackEvent, record
from repro_torch.kernels.common import DeviceLike, check_device, resolve_device
from repro_torch.kernels.alifrec.ops import alif_scan, alifrec_scan
from repro_torch.kernels.lif.ops import lif_scan
from repro_torch.kernels.lifrec.ops import lifrec_scan
from repro_torch.kernels.linrec.ops import linrec, linrec_branches
from repro_torch.kernels.spikemm.ops import spikemm, spikemm_sessions
from repro_torch.kernels.stdp.ops import stdp_seq, stdp_seq_sessions

Tensor = torch.Tensor

FUSED_FF = "fused_ff"
FUSED_REC = "fused_rec"
FALLBACK = "fallback"

# FIRE lowering families the pattern matcher can emit
LOWER_LI = "li"
LOWER_LIF = "lif"
LOWER_ALIF = "alif"
LOWER_DHLIF = "dhlif"

# synapse-program lowerings
SYN_SEQ = "stdp_seq"
SYN_STEP = "step"

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


def engine_mode() -> str:
    mode = os.environ.get("REPRO_SNN_ENGINE", "auto")
    if mode not in ("auto", "plan", "stepper"):
        raise ValueError(f"REPRO_SNN_ENGINE={mode!r}: "
                         "expected 'plan', 'stepper', or 'auto'")
    return mode


def check_mode() -> str:
    mode = os.environ.get("REPRO_CHECK", "off")
    if mode not in ("off", "warn", "raise"):
        raise ValueError(f"REPRO_CHECK={mode!r}: "
                         "expected 'off', 'warn', or 'raise'")
    return mode


@dataclasses.dataclass(frozen=True)
class Segment:
    """One unit of the lowered schedule, executed over the full time axis."""

    kind: str                  # fused_ff | fused_rec | fallback
    names: Tuple[str, ...]     # node names (fused segments hold exactly one)
    reason: str = ""           # why the planner fell back (diagnostics)
    lower: str = ""            # FIRE kernel family for fused segments
    codes: Tuple[str, ...] = ()  # TB2xx codes, one per merged fallback node


@dataclasses.dataclass(frozen=True)
class PlasticLower:
    """Lowering decision for one plastic Connection (run-granularity pass)."""

    node: str                  # destination node name
    conn: str                  # Connection.key
    lower: str                 # stdp_seq | step
    reason: str = ""           # why the fused family was refused
    code: str = ""             # TB2xx code for a refused fused lowering


@dataclasses.dataclass(frozen=True)
class Plan:
    segments: Tuple[Segment, ...]
    plastic: Tuple[PlasticLower, ...] = ()

    @property
    def fully_fallback(self) -> bool:
        return all(s.kind == FALLBACK for s in self.segments)

    def describe(self) -> str:
        """Segment schedule, with every fallback's TB-code inline, and
        the plastic connections' lowerings after `| learn`."""
        parts = []
        for s in self.segments:
            tag = f"{s.kind}[{','.join(s.names)}]"
            if s.lower:
                tag += f":{s.lower}"
            if s.reason:
                tag += f"({s.reason})"
            parts.append(tag)
        out = " -> ".join(parts)
        if self.plastic:
            learns = []
            for p in self.plastic:
                tag = f"{p.node}.{p.conn}:{p.lower}"
                if p.reason:
                    tag += f"({p.code}: {p.reason})" if p.code \
                        else f"({p.reason})"
                learns.append(tag)
            out += " | learn " + ",".join(learns)
        return out


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


def _match_synapse_pattern(prog: plasticity.SynapseProgram
                           ) -> Tuple[str, str, str]:
    """Structurally match a SynapseProgram against the `stdp_seq` family.

    -> (SYN_SEQ, "", "") when the program is small enough for the fused
    plane stack; else (SYN_STEP, TB-code, reason) — the per-step
    interpreter over the realized spike trains, always correct. Learned
    per-synapse trace decays are fine: `linrec` takes a full decay plane,
    so a sigmoid-resolved learned decay hoists exactly like a constant.
    """
    if len(prog.traces) > 4:
        return SYN_STEP, "TB210", f"{len(prog.traces)} traces"
    if len(prog.terms) > 4:
        return SYN_STEP, "TB210", f"{len(prog.terms)} update terms"
    return SYN_SEQ, "", ""


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
    """Analyze the node DAG and emit the segment + plastic-lowering plan."""
    plan = _compile(nodes)
    if os.environ.get("REPRO_SNN_EXPLAIN") == "1":
        print(f"[repro_torch.plan] {plan.describe()}")
    _run_check_hook(nodes, plan)
    return plan


# Re-entrancy latch for the REPRO_CHECK hook: `analysis.check_nodes` may
# itself call `compile_program` (it reuses the planner for TB2xx), which
# must not re-trigger the hook.
_IN_CHECK = False


def _run_check_hook(nodes: List[events.LayerNode], plan: "Plan") -> None:
    """Opt-in static checking at compile time (REPRO_CHECK=warn|raise).

    warn: warning+ findings land on the kernel incident log (kind="check")
    — observable, never fatal, and record()ed rather than degrade()d so
    that REPRO_STRICT stays green. raise: error-severity findings abort
    compilation with `analysis.DiagnosticError`.
    """
    global _IN_CHECK
    mode = check_mode()
    if mode == "off" or _IN_CHECK:
        return
    from repro_torch import analysis  # deferred: analysis imports this module
    _IN_CHECK = True
    try:
        diags = analysis.check_nodes(nodes, plan=plan)
    finally:
        _IN_CHECK = False
    if mode == "raise":
        analysis.raise_if(diags, "error")
    for d in analysis.at_least(diags, "warning"):
        record(FallbackEvent(
            kind="check", family="plan", stage=d.code,
            error=f"{d.site}: {d.message}"))


def _compile(nodes: List[events.LayerNode]) -> Plan:
    order = {n.name: i for i, n in enumerate(nodes)}
    plastic = []
    for n in nodes:
        for c in n.connections:
            if c.plastic is None:
                continue
            lower, code, why = _match_synapse_pattern(c.plastic)
            plastic.append(PlasticLower(n.name, c.key, lower, why, code))
    plastic = tuple(plastic)
    # Any previous-timestep read of a later node couples the whole Program
    # per-timestep: compile to one stepper segment (exactly events.run).
    for n in nodes:
        for c in n.connections:
            if c.src not in ("input", "self") and order[c.src] >= order[n.name]:
                return Plan((Segment(
                    FALLBACK, tuple(x.name for x in nodes),
                    f"{n.name}: TB201 reads later node {c.src}",
                    codes=("TB201",)),), plastic)

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
    return Plan(tuple(segments), plastic)


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
                     T: int, B: int, traced: bool) -> Tensor:
    """All-T INTEG: one event-gated spikemm per inbound connection, or,
    for a topology-backed one, one pass through its compressed tables
    (`apply_spikes`: spikemm for type-2 FC, spikemm_gather for the other
    IE tables; `dense_equivalent()` never runs).

    The "branch" convention hoists the dendritic einsum as a single
    spikemm against the branch-flattened (n_in, K*n_out) weight view,
    yielding a (T, B, K, n_out) per-branch current block. `traced` is
    spikemm's `_traced` routing hint."""
    if _hoist_tag(node) == "branch":
        conn = next(c for c in node.connections if c.src != "self")
        w = params[node.name]["w_input"]             # (K, n_in, n_out)
        K, n_in, n_out = w.shape
        s = _as_float(_feed_full(outs, state, conn.src, conn.delay, T),
                      w.dtype)
        w2 = w.permute(1, 0, 2).reshape(n_in, K * n_out).contiguous()
        c = spikemm(s.reshape(T * B, -1).contiguous(), w2, _traced=traced)
        return c.reshape(T, B, K, n_out)
    cur = None
    for conn in node.connections:
        if conn.src == "self":
            continue
        s = _feed_full(outs, state, conn.src, conn.delay, T)
        topo = events.resolve_topology(conn, node.name, params)
        if topo is not None:
            s = _as_float(s, events.state_dtype(s.dtype))
            c = topo.apply_spikes(s.reshape(T * B, -1).contiguous(),
                                  _traced=traced).reshape(T, B, -1)
        else:
            w = params[node.name][conn.weight_key]
            s = _as_float(s, w.dtype)
            if w.dim() == 3:
                # one weight a batch row (a learning serve window's session
                # axis): row b's spikes against w[b], in one launch
                _check_sessions(node, conn, w, B)
                c = spikemm_sessions(s.contiguous(), w.contiguous())
            else:
                c = spikemm(s.reshape(T * B, -1).contiguous(),
                            w.contiguous(), _traced=traced).reshape(T, B, -1)
        cur = c if cur is None else cur + c
    if cur is None:
        x = outs["input"]
        cur = torch.zeros((T, B, node.out_dim),
                          dtype=events.state_dtype(x.dtype), device=x.device)
    return cur


def _check_sessions(node: events.LayerNode, conn: events.Connection,
                    w: Tensor, B: int) -> None:
    """A weight with a leading session axis is a plastic connection's, one
    (n_pre, n_post) weight a batch row."""
    if conn.plastic is None or w.shape[0] != B:
        raise ValueError(
            f"node {node.name!r}: connection {conn.key!r} has a weight of "
            f"shape {tuple(w.shape)}; a leading session axis is taken only "
            f"on a plastic connection, one weight a batch row (B = {B})")


def _decay_vec(decay: Decay, nparams: Optional[Dict[str, Tensor]], n: int,
               device: torch.device, n_branches: int = 0) -> Tensor:
    """Resolve a program Decay to the kernel-facing contiguous fp32 decay
    tensor: (N,) for per-neuron states, (K, N) for branch states."""
    shape = (n_branches, n) if n_branches else (n,)
    p = (nparams or {}).get(decay.param) if decay.kind != "const" else None
    if p is not None:
        d = torch.sigmoid(p.float())
        return (d if tuple(d.shape) == shape else d.expand(shape)).contiguous()
    return torch.full(shape, decay.value, dtype=torch.float32, device=device)


def _self_weight(node: events.LayerNode, params: Dict[str, Any]) -> Tensor:
    conn = next(c for c in node.connections if c.src == "self")
    return params[node.name][conn.weight_key].contiguous()


def _is_spiking(node: events.LayerNode) -> bool:
    """Whether the node emits a spike train (rate monitors make sense) as
    opposed to a membrane/state readout. Unknown programs count as spiking
    only if they declare a threshold."""
    try:
        return node.neuron.program.threshold is not None
    except NotImplementedError:
        return False


def _run_fused(node: events.LayerNode, kind: str, lower: str,
               params: Dict[str, Any], outs: Dict[str, Tensor],
               state: Dict[str, Any], new_state: Dict[str, Any],
               T: int, B: int, traced: bool,
               gcfg: guards.GuardConfig = guards.GuardConfig(),
               sessions: bool = False) -> None:
    cur = _hoisted_current(node, params, outs, state, T, B, traced)
    prog = node.neuron.program
    nparams = params.get(node.name, {}).get("neuron")
    th = prog.threshold
    sur, alpha = node.neuron.surrogate, node.neuron.alpha
    N = node.out_dim
    dev = cur.device
    st = state[node.name]

    if lower == LOWER_LI:
        sv = prog.states[0]
        tau = _decay_vec(sv.decay, nparams, N, dev).to(cur.dtype)
        out, vT = linrec(tau, cur, st[sv.name].contiguous())
        ns = {sv.name: vT}
    elif lower == LOWER_LIF:
        tau = _decay_vec(prog.states[0].decay, nparams, N, dev)
        v0 = st[th.on].contiguous()
        if kind == FUSED_REC:
            out, vT = lifrec_scan(cur, _self_weight(node, params), tau, v0,
                                  st["out"].contiguous(), th.base, sur,
                                  alpha)
        else:
            out, vT = lif_scan(cur, tau, v0, th.base, sur, alpha, prog.reset)
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
                                       th.base, th.scale, sur, alpha)
        else:
            out, vT, aT = alif_scan(cur, tau, rho, v0, a0, th.base,
                                    th.scale, sur, alpha)
        ns = {mem.name: vT, ad.name: aT}
    elif lower == LOWER_DHLIF:
        # branch-integrate prologue: the dendrites never reset, so they are
        # a pure linear recurrence -> one linrec over every (b, k, n) lane
        # (the lanes are laid out (B, K*N); elementwise this is the
        # reference's (B*K, N) layout), summed into the soma's LIF kernel
        # in a fixed order, so a lane's result never depends on the shape
        # of the batch it was packed into (`linrec_branches`: its backward
        # reads the soma's cotangent as it is)
        mem = next(s for s in prog.states if s.name == th.on)
        br = next(s for s in prog.states if s.branch)
        d0 = st[br.name]                             # (B, K, N)
        K = d0.shape[-2]
        tau_d = _decay_vec(br.decay, nparams, N, dev, n_branches=K)
        soma_cur, dT = linrec_branches(
            tau_d.to(cur.dtype).reshape(K * N), cur.reshape(T, B, K * N),
            d0.reshape(B, K * N).contiguous(), K)
        tau_s = _decay_vec(mem.decay, nparams, N, dev)
        out, vT = lif_scan(soma_cur, tau_s,
                           st[mem.name].contiguous(), th.base, sur, alpha)
        ns = {mem.name: vT, br.name: dT.reshape(B, K, N)}
    else:  # pragma: no cover - compile_program only emits known families
        raise ValueError(f"unknown FIRE lowering {lower!r}")

    # dead/stuck-row faults: the mask is time-independent, so masking the
    # full (T, B, N) train here equals the stepper's per-step masking for
    # everything downstream (feeds, rings, "out"). A fused *recurrent*
    # kernel's in-loop feedback runs pre-mask, unlike the stepper, as in
    # the reference. The DH-LIF branch call's output is the soma's input,
    # not a node output, so nothing is checked between branch and soma.
    # With `sessions` the batch rows are a learning window's sessions, and
    # each guard acts per row (axis 1 of the train, 0 of a state).
    out = faults.perturb_output(node.name, out)
    out = guards.check_tensor(f"{node.name}.out", out, gcfg,
                              1 if sessions else None)
    if lower != LOWER_LI:
        guards.check_spikes(node.name, out, gcfg, 1 if sessions else None)
    ns = {k: guards.check_tensor(f"{node.name}.{k}", v, gcfg,
                                 0 if sessions else None)
          for k, v in ns.items()}
    outs[node.name] = out
    ns["out"] = out[-1]
    if "ring" in st:
        ns["ring"] = _advance_ring(st["ring"], out)
    for k, v in st.items():
        if k.startswith("syn:"):
            ns[k] = v
    new_state[node.name] = ns


def _run_fallback(seg: Segment, nodes_by_name: Dict[str, events.LayerNode],
                  params: Dict[str, Any], x: Tensor, outs: Dict[str, Tensor],
                  state: Dict[str, Any], new_state: Dict[str, Any],
                  T: int,
                  gcfg: guards.GuardConfig = guards.GuardConfig()) -> None:
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
    full = {name: torch.stack(v) for name, v in rec.items()}
    if gcfg.active:
        for name in seg.names:
            full[name] = guards.check_tensor(f"{name}.out", full[name], gcfg)
            if _is_spiking(nodes_by_name[name]):
                guards.check_spikes(name, full[name], gcfg)
        st = {name: {k: (guards.check_tensor(f"{name}.{k}", v, gcfg)
                         if not k.startswith("syn:") else v)
                     for k, v in ns.items()}
              for name, ns in st.items()}
    outs.update(full)
    new_state.update(st)


def _session_conns(nodes: List[events.LayerNode], params: Dict[str, Any]
                   ) -> List[Tuple[str, events.Connection]]:
    """(node name, connection) of every plastic weight with a session axis:
    a weight of shape (S, n_pre, n_post), a learning serve window's one
    weight a session (batch row)."""
    return [(n.name, c) for n in nodes for c in n.connections
            if c.plastic is not None
            and torch.is_tensor(w := params.get(n.name, {}).get(c.weight_key))
            and w.dim() == 3]


def _refuse_sessions_off_the_plan(
        plan: Plan, sessions: List[Tuple[str, events.Connection]],
        mode: str, learn: bool) -> None:
    """A plastic weight with a session axis (a learning serve window) runs
    on the fused segments and learns on the `stdp_seq` lowering only: the
    stepper and the per-step synapse interpreter (TB210) read one weight
    for every batch row, so raise rather than mix the sessions' weights."""
    fallback = {n for s in plan.segments if s.kind == FALLBACK
                for n in s.names}
    step = {(p.node, p.conn) for p in plan.plastic if p.lower == SYN_STEP}
    for name, c in sessions:
        if mode == "stepper":
            where = "the stepper (REPRO_SNN_ENGINE=stepper)"
        elif name in fallback:
            where = "the stepper (a fallback segment)"
        elif learn and (name, c.key) in step:
            where = "the per-step synapse lowering (TB210)"
        else:
            continue
        raise NotImplementedError(
            f"node {name!r}: the session axis of a learning serve "
            f"window runs on the fused plan and the stdp_seq lowering, "
            f"not on {where}: {_ROADMAP}, item 7 (plasticity in "
            "serving)")


# ---------------------------------------------------------------------------
# session-state pack/unpack (the serve engine's gather/scatter primitives)
# ---------------------------------------------------------------------------
#
# A `plan.run` state tree is {node: {key: tensor}} where every per-neuron
# leaf carries the batch on axis 0 — except the delay ring, whose layout is
# (depth, batch, n). The serve engine multiplexes many batch-1 streaming
# sessions through one window step by concatenating their states into
# cohort slots along the batch axis and slicing them back out. Synapse
# ("syn:") entries are rejected: their weight plane has no batch axis (one
# tile per connection, batch-summed updates), so packing sessions that
# learn would alias their weights — the engine keeps them per session.


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
    capacity, so every window step runs at one shape. Raises on "syn:"
    entries — see the note above."""
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
            if k.startswith("syn:"):
                raise ValueError(
                    f"pack_states: node {node!r} carries synapse state "
                    f"{k!r}, which has no batch axis; keep syn entries "
                    "per-session (see repro_torch.serve)")
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
# the plasticity pass (run-granularity on-chip learning)
# ---------------------------------------------------------------------------


def _mod_full(mod: Any, T: int, B: int, N: int, dtype: torch.dtype,
              device: torch.device) -> Tensor:
    """Broadcast the run-level modulator to the (T, B, N) term plane.

    Accepts None (zeros: no reward, no update), (T,) global reward per
    step, (T, B) per-trial reward, or (T, B, N) per-neuron teaching
    signal."""
    if mod is None:
        return torch.zeros((T, B, N), dtype=dtype, device=device)
    m = torch.as_tensor(mod, dtype=dtype, device=device)
    if m.dim() == 1:
        m = m[:, None, None]
    elif m.dim() == 2:
        m = m[..., None]
    return m.expand(T, B, N)


def _learn_fused(prog: plasticity.SynapseProgram, syn0: Dict[str, Tensor],
                 pre_full: Tensor, post_full: Tensor,
                 mod_full: Optional[Tensor],
                 sparams: Optional[Dict[str, Tensor]] = None
                 ) -> Dict[str, Tensor]:
    """Fused `stdp_seq` lowering of one SynapseProgram window.

    Trace DIFFs are pure linear recurrences -> hoisted through all-T
    `linrec`; each term's pre/post factor products become (T*B, n) planes
    ("after" traces read the one-step-shifted trajectory); the stacked
    planes drive the serial-in-time `stdp_seq` kernel, one launch for the
    window. Learned per-synapse decays (`sparams`, the
    `params[node]["syn:<conn>"]` dict) resolve through `decay_array`
    exactly like the per-step interpreter and broadcast into the decay
    plane. The learned weight is the kernel's fresh output; syn0["w"] is
    read only.
    """
    T, B = pre_full.shape[:2]
    by_name = {t.name: t for t in prog.traces}
    traj: Dict[str, Tensor] = {}
    shifted: Dict[str, Tensor] = {}
    finals: Dict[str, Tensor] = {}
    for tr in prog.traces:
        s = pre_full if tr.source == "pre" else post_full
        h0 = syn0[tr.name].to(s.dtype).contiguous()
        a = decay_array(tr.decay, sparams, s.dtype, s.device)
        y, hT = linrec(a, (tr.scale * s).contiguous(), h0)
        traj[tr.name] = y
        finals[tr.name] = hT.to(syn0[tr.name].dtype)
        shifted[tr.name] = torch.cat([h0[None], y[:-1]], dim=0)

    def plane(factors, spikes):
        v = None
        for f in factors:
            if f == "spikes":
                x = spikes
            elif f == "mod":
                x = mod_full
            else:
                x = traj[f] if by_name[f].update == "before" else shifted[f]
            v = x if v is None else v * x
        return v.expand(T, B, -1).reshape(T * B, -1)

    P = torch.stack([plane(t.pre, pre_full) for t in prog.terms])
    Q = torch.stack([plane(t.post, post_full) for t in prog.terms])
    amps = tuple(t.amp for t in prog.terms)
    if syn0["w"].dim() == 3:
        # a weight a batch row (the session axis): row b of each step
        # updates w[b] alone, at batch 1
        w1 = stdp_seq_sessions(P, Q, syn0["w"].contiguous(), amps=amps,
                               w_min=prog.w_min, w_max=prog.w_max)
    else:
        w1 = stdp_seq(P, Q, syn0["w"].contiguous(), amps=amps,
                      w_min=prog.w_min, w_max=prog.w_max, batch=B)
    out = {"w": w1}
    out.update(finals)
    return out


def _learn_conn(node: events.LayerNode, conn: events.Connection, lower: str,
                params: Dict[str, Any], outs: Dict[str, Tensor],
                state: Dict[str, Any], new_state: Dict[str, Any],
                T: int, B: int, mod: Any, order: Dict[str, int],
                gcfg: guards.GuardConfig = guards.GuardConfig()) -> None:
    """Apply one plastic Connection's learning rule over the run window.

    The pre train is exactly the feed the stepper delivered: delay-shifted
    for "src@d" reads, and the *previous-step* output for "self" and for
    undelayed back-references (a source ordered at-or-after the node is
    read before it runs, i.e. at t-1, seeded from its initial "out"). The
    post train is the node's emitted output. The update is a weight write
    into the state, never into params or the entry state.
    """
    prog = conn.plastic
    key = f"syn:{conn.key}"
    syn0 = state[node.name][key]
    prev_step = conn.src == "self" or (
        conn.src != "input" and conn.delay == 0
        and order[conn.src] >= order[node.name])
    if prev_step:
        src_name = node.name if conn.src == "self" else conn.src
        s_full = outs[src_name]
        pre = torch.cat([state[src_name]["out"][None].to(s_full.dtype),
                         s_full[:-1]], dim=0)
    else:
        pre = _feed_full(outs, state, conn.src, conn.delay, T)
    post = outs[node.name]
    fdt = events.state_dtype(post.dtype)
    pre, post = pre.to(fdt), post.to(fdt)
    uses_mod = any("mod" in t.post for t in prog.terms)
    mod_f = (_mod_full(mod, T, B, post.shape[-1], fdt, post.device)
             if uses_mod else None)
    sparams = params.get(node.name, {}).get(key)
    if lower == SYN_SEQ:
        syn1 = _learn_fused(prog, syn0, pre, post, mod_f, sparams)
    else:
        syn1 = plasticity.synapse_run(prog, syn0["w"], pre, post, mod_f,
                                      sparams, syn=syn0)
    if gcfg.active:
        # chunked-online divergence guard: a window whose learned weights
        # go nonfinite or explode is flagged (warn/raise) or rolled back
        # to the entry tensor (sanitize) before it is published; a weight
        # with a session axis is guarded session by session
        syn1 = dict(syn1)
        syn1["w"] = guards.guard_learned(
            f"{node.name}.{conn.key}", syn0["w"], syn1["w"], gcfg,
            0 if syn0["w"].dim() == 3 else None)
    ns = dict(new_state[node.name])
    ns[key] = syn1
    new_state[node.name] = ns


@torch.no_grad()
def _learn_pass(plan: Plan, nodes: List[events.LayerNode],
                params: Dict[str, Any], outs: Dict[str, Tensor],
                state: Dict[str, Any], new_state: Dict[str, Any],
                T: int, B: int, mod: Any,
                gcfg: guards.GuardConfig = guards.GuardConfig()) -> None:
    """Every plastic connection's learning rule over the window, out of
    the autograd graph (the JAX package's `stop_gradient`): its weight and
    trace writes carry no `grad_fn`, whatever the spike trains, synapse
    state and modulator it reads require."""
    nodes_by_name = {n.name: n for n in nodes}
    order = {n.name: i for i, n in enumerate(nodes)}
    for p in plan.plastic:
        node = nodes_by_name[p.node]
        conn = next(c for c in node.connections if c.key == p.conn)
        _learn_conn(node, conn, p.lower, params, outs, state, new_state,
                    T, B, mod, order, gcfg)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _run_stepper(nodes: List[events.LayerNode], params: Dict[str, Any],
                 x: Tensor, state: Optional[Dict[str, Any]],
                 record: Tuple[str, ...], plan: Plan, mod: Any,
                 do_learn: bool, dev: torch.device,
                 gcfg: guards.GuardConfig = guards.GuardConfig()):
    """The interpreted engine (`events.run`), then, when learning, the
    same learning pass over the realized spike trains (recording what the
    plastic connections need). The guards check the last node's output."""

    def checked(out):
        out = guards.check_tensor(f"{nodes[-1].name}.out", out, gcfg)
        if gcfg.active and _is_spiking(nodes[-1]):
            guards.check_spikes(nodes[-1].name, out, gcfg)
        return out

    if not do_learn:
        final, out, recs = events.run(nodes, params, x, state, record,
                                      device=dev)
        return final, checked(out), recs
    T, B = x.shape[0], x.shape[1]
    if state is None:
        state = events.init_state(nodes, B, x.dtype, params, device=dev)
    nodes_by_name = {n.name: n for n in nodes}
    needed = set(record)
    for p in plan.plastic:
        needed.add(p.node)
        conn = next(c for c in nodes_by_name[p.node].connections
                    if c.key == p.conn)
        if conn.src not in ("input", "self"):
            needed.add(conn.src)
    final, out, recs = events.run(nodes, params, x, state,
                                  tuple(sorted(needed)), device=dev)
    out = checked(out)
    outs = dict(recs)
    outs["input"] = x
    outs[nodes[-1].name] = out
    new_state = dict(final)
    _learn_pass(plan, nodes, params, outs, state, new_state, T, B, mod,
                gcfg)
    return new_state, out, {r: outs[r] for r in record}


def run(nodes: List[events.LayerNode], params: Dict[str, Any], x: Tensor,
        state: Optional[Dict[str, Any]] = None, record: Tuple[str, ...] = (),
        plan: Optional[Plan] = None, mod: Any = None, learn: bool = True,
        guard: Union[None, str, guards.GuardConfig] = None,
        device: DeviceLike = "cuda", _traced: bool = False):
    """Drop-in replacement for `events.run` through the compiled plan.

    x: (T, batch, n_in) on `device` (default the card; pass device="cpu"
    to run on the CPU). Returns (final_state, outputs (T, batch, n_out),
    recorded dict) — equivalent to the stepper within CROSS_ENGINE_ATOL.
    Plastic Connections learn over the window (disable with
    `learn=False`); `mod` is the optional modulator/reward signal ((T,),
    (T, B), or (T, B, n_post)) feeding the rules' "mod" factors. Learned
    weights + final traces come back in `state[node]["syn:<conn>"]`
    (`plasticity.apply_learned` merges them into params). With
    REPRO_SNN_ENGINE=stepper the forward runs on `events.run`, and the
    learning pass after it. `_traced=True` (the serve engine's window
    step) routes the hoisted INTEG as the JAX package routes its jitted
    step: spikemm's `auto` stays dense, with no occupancy sync, and a
    guard's raise policy records and warns instead of raising.

    Resilience hooks: active faults (`REPRO_FAULTS` / `faults.inject`)
    perturb the input raster and weight planes once at entry and node
    outputs inside both engines, identically. `guard` enables numerical
    guardrails (`core/guards.py`): a policy string off|warn|raise|sanitize
    or a full `GuardConfig`; None defers to `REPRO_GUARD` (default off).
    Off adds no op, launch or host read; warn and raise read every flag
    of the run in one copy at its end.

    Differentiable (surrogate-gradient BPTT): the outputs and final
    states carry autograd graphs back to `params`, `x` and `state` where
    they require grad, through the kernels' backward (`lif_scan`,
    `linrec`, `spikemm`, `lifrec_scan`, `alif_scan`, `alifrec_scan`, each
    under its node's surrogate and alpha, and `spikemm_gather`, whose
    backward is the gather on the transposed tables). The learning pass
    stays out of the graph. Callers that only infer run it under
    `torch.no_grad()`.
    """
    mode = engine_mode()
    dev = resolve_device(device)
    check_device("x", x, dev)
    if plan is None:
        plan = compile_program(nodes)
    gcfg = guards.config(guard)
    do_learn = learn and bool(plan.plastic)
    sessions = _session_conns(nodes, params)
    _refuse_sessions_off_the_plan(plan, sessions, mode, do_learn)
    with guards.collect(_traced):
        # injected faults hit the run boundary once, before either engine
        # (and before init_state seeds plastic synapses), so both see the
        # same world
        x = faults.perturb_input(x)
        params = faults.perturb_params(
            params, {(name, c.weight_key) for name, c in sessions})
        x = guards.check_tensor("input", x, gcfg, 1 if sessions else None)
        if mode == "stepper" or plan.fully_fallback:
            return _run_stepper(nodes, params, x, state, record, plan, mod,
                                do_learn, dev, gcfg)
        T, B = x.shape[0], x.shape[1]
        if state is None:
            state = events.init_state(nodes, B, x.dtype, params, device=dev)
        nodes_by_name = {n.name: n for n in nodes}
        outs: Dict[str, Tensor] = {"input": x}
        new_state = dict(state)
        for seg in plan.segments:
            if seg.kind == FALLBACK:
                _run_fallback(seg, nodes_by_name, params, x, outs, state,
                              new_state, T, gcfg)
            else:
                _run_fused(nodes_by_name[seg.names[0]], seg.kind,
                           seg.lower, params, outs, state, new_state, T, B,
                           _traced, gcfg, bool(sessions))
        if do_learn:
            _learn_pass(plan, nodes, params, outs, state, new_state, T, B,
                        mod, gcfg)
        return new_state, outs[nodes[-1].name], {r: outs[r] for r in record}


def run_stream(nodes: List[events.LayerNode], params: Dict[str, Any],
               chunks: Iterable[Tensor],
               state: Optional[Dict[str, Any]] = None,
               plan: Optional[Plan] = None, mod: Optional[Iterable] = None,
               learn: bool = True,
               guard: Union[None, str, guards.GuardConfig] = None,
               device: DeviceLike = "cuda"
               ) -> Iterator[Tuple[Dict[str, Any], Tensor]]:
    """Chunked/streaming execution: yields `(state, outputs)` after each
    (T_chunk, batch, n_in) chunk, carrying neuron state, delay rings and
    synapse state across chunk boundaries, so concatenating the yielded
    outputs equals the one-shot `run` on the concatenated stream. Learning
    continues from the carried state's weight, while the forward reads
    `params` (chunked-online: merge with `apply_learned` to change that).
    The plan is compiled once up front; `mod`, when given, must be an
    iterable aligned with `chunks` (one modulator window per chunk).
    Like `run` it is differentiable: the carried state carries the graph
    across chunks (BPTT through the stream), so a caller that only infers
    runs it under `torch.no_grad()`, or its graph grows chunk by chunk."""
    if plan is None:
        plan = compile_program(nodes)
    mods = iter(mod) if mod is not None else None
    for x in chunks:
        m = next(mods) if mods is not None else None
        state, out, _ = run(nodes, params, x, state=state, plan=plan, mod=m,
                            learn=learn, guard=guard, device=device)
        yield state, out


__all__ = ["Plan", "PlasticLower", "Segment", "compile_program",
           "engine_mode", "check_mode", "run", "run_stream",
           "CROSS_ENGINE_ATOL", "state_nbytes", "pack_states",
           "unpack_state", "FUSED_FF", "FUSED_REC", "FALLBACK",
           "LOWER_LI", "LOWER_LIF", "LOWER_ALIF", "LOWER_DHLIF",
           "SYN_SEQ", "SYN_STEP"]
