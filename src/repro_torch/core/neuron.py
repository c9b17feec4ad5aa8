"""Programmable neuron dynamics — the TaiBai instruction set in PyTorch.

The port of `repro/core/neuron.py`. TaiBai's Table I instructions are the
primitives every neuron model is written in:

  diff(v, tau, c)    DIFF    first-order ODE step  v' = tau * v + c
  locacc(s, w)       LOCACC  current accumulation  I = s @ w   (event-driven)
  spike(...)         SEND    threshold + emit

The FIRE stage is *declarative*: a neuron model is a `NeuronProgram` — a
list of DIFF state updates (each `StateVar` declares its decay source and
its drive), a threshold expression, a reset rule and an output selector —
interpreted by one generic `NeuronSpec.fire`. The plan compiler
(`core/plan.py`) pattern-matches the program structure and lowers matching
programs to fused whole-time-axis kernels; anything else runs on the
stepper.

Models provided (the paper's applications, §V-B3), each a thin dataclass
factory producing its program: LIF, PLIF, ALIF, DHLIF, LI.
`param_init(generator, shape)` draws learnable parameters from a
`torch.Generator` (on the CPU; callers move them to their device).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.surrogate import spike
from repro_torch.kernels.common import resolve_device

State = Dict[str, torch.Tensor]


def diff(v: torch.Tensor, tau, c) -> torch.Tensor:
    """The DIFF instruction: one Euler step of dv/dt = -(1-tau) v + input."""
    return tau * v + c


def locacc(spikes: torch.Tensor, weights) -> torch.Tensor:
    """The LOCACC instruction: accumulate presynaptic events into currents
    (dense form; the event-gated kernel is `kernels/spikemm`). Integer
    spikes are cast to the weights' type first. An `EncodedTopology` in
    weight position executes through its compressed IE tables
    (`apply_spikes`) — same currents, no dense matrix."""
    if hasattr(weights, "apply_spikes"):
        if not spikes.dtype.is_floating_point:
            spikes = spikes.to(torch.float32)
        lead = tuple(spikes.shape[:-1])
        flat = spikes.reshape(-1, spikes.shape[-1]).contiguous()
        return weights.apply_spikes(flat).reshape(lead + (weights.shape[1],))
    if not spikes.dtype.is_floating_point:
        spikes = spikes.to(weights.dtype)
    return spikes @ weights


# ---------------------------------------------------------------------------
# the neuron-program IR
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Decay:
    """Where a state's DIFF decay comes from.

    kind:   "const"      — fixed `value` for every neuron
            "learned"    — sigmoid(params[param]), per-neuron logits;
                           `value` is the fallback when params are absent
            "per_branch" — like "learned" but the logits carry a leading
                           branch axis (shape (n_branches, n))
    """

    kind: str = "const"
    value: float = 0.9
    param: str = ""


@dataclasses.dataclass(frozen=True)
class StateVar:
    """One DIFF state update: state' = decay * state + drive.

    drive:  "current"      — the INTEG-stage input current
            "spikes"       — this step's emitted spikes (updates AFTER the
                             threshold fires, e.g. ALIF's adaptation trace)
            "sum:<state>"  — branch-sum of another (branch) state, e.g. the
                             DH-LIF soma integrating its dendrites
    branch: the state carries a leading dendritic-branch axis
            (shape (..., n_branches, n)); its drive arrives per branch.
    """

    name: str
    decay: Decay
    drive: str = "current"
    branch: bool = False


@dataclasses.dataclass(frozen=True)
class Threshold:
    """Spike condition: fire where  state[on] >= base + scale * state[adapt].

    `adapt=""` is the constant threshold; ALIF's moving threshold is
    `Threshold(base=v_th, adapt="a", scale=beta)`.
    """

    base: float = 1.0
    on: str = "v"
    adapt: str = ""
    scale: float = 0.0


@dataclasses.dataclass(frozen=True)
class NeuronProgram:
    """Declarative FIRE-stage dynamics.

    threshold=None describes a non-spiking integrator (no reset either);
    reset "zero" is the hard reset of eq. (3), "none" skips it; output is
    "spikes" or the name of a state to read out (LI reads its membrane).
    """

    states: Tuple[StateVar, ...]
    threshold: Optional[Threshold] = None
    reset: str = "zero"
    output: str = "spikes"
    n_branches: int = 1


def validate_program(prog: NeuronProgram) -> NeuronProgram:
    """Raise ValueError on a structurally invalid program; return it."""
    names = [sv.name for sv in prog.states]
    if not names:
        raise ValueError("program needs at least one state")
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate state names: {names}")
    for sv in prog.states:
        if sv.decay.kind not in ("const", "learned", "per_branch"):
            raise ValueError(f"state {sv.name!r}: bad decay kind "
                             f"{sv.decay.kind!r}")
        if sv.decay.kind != "const" and not sv.decay.param:
            raise ValueError(f"state {sv.name!r}: {sv.decay.kind} decay "
                             "needs a param name")
        if sv.decay.kind == "per_branch" and not sv.branch:
            raise ValueError(f"state {sv.name!r}: per_branch decay on a "
                             "non-branch state")
        if sv.drive.startswith("sum:"):
            src = sv.drive[4:]
            if src not in names:
                raise ValueError(f"state {sv.name!r} sums unknown state "
                                 f"{src!r}")
            if not next(s for s in prog.states if s.name == src).branch:
                raise ValueError(f"state {sv.name!r} sums non-branch state "
                                 f"{src!r}")
            if sv.branch:
                raise ValueError(f"branch state {sv.name!r} cannot be "
                                 "sum-driven")
        elif sv.drive == "spikes":
            if prog.threshold is None:
                raise ValueError(f"state {sv.name!r} is spike-driven but "
                                 "the program never spikes")
        elif sv.drive != "current":
            raise ValueError(f"state {sv.name!r}: bad drive {sv.drive!r}")
    if prog.threshold is not None:
        th = prog.threshold
        if th.on not in names:
            raise ValueError(f"threshold on unknown state {th.on!r}")
        if next(s for s in prog.states if s.name == th.on).branch:
            raise ValueError("threshold cannot fire on a branch state")
        if th.adapt:
            if th.adapt not in names:
                raise ValueError(f"threshold adapts on unknown state "
                                 f"{th.adapt!r}")
            if next(s for s in prog.states if s.name == th.adapt).branch:
                raise ValueError("threshold cannot adapt on a branch state")
    if prog.reset not in ("zero", "subtract", "none"):
        raise ValueError(f"bad reset {prog.reset!r}")
    if prog.output != "spikes":
        if prog.output not in names:
            raise ValueError(f"output selects unknown state {prog.output!r}")
        if next(s for s in prog.states if s.name == prog.output).branch:
            raise ValueError("output cannot select a branch state")
    if prog.output == "spikes" and prog.threshold is None:
        raise ValueError("spike output needs a threshold")
    if prog.n_branches < 1:
        raise ValueError(f"n_branches must be >= 1, got {prog.n_branches}")
    return prog


def decay_array(decay: Decay, params: Optional[Dict[str, torch.Tensor]],
                dtype, device=None) -> torch.Tensor:
    """Resolve a Decay to a concrete decay factor in (0, 1)."""
    if decay.kind != "const" and params and decay.param in params:
        return torch.sigmoid(params[decay.param]).to(dtype)
    return torch.tensor(decay.value, dtype=dtype, device=device)


def program_fire(prog: NeuronProgram, state: State, current: torch.Tensor,
                 params: Optional[Dict[str, Any]], surrogate: str,
                 alpha: float) -> Tuple[State, torch.Tensor]:
    """Interpret one FIRE-stage step of a NeuronProgram.

    Phase order: current-/sum-driven states update first (in declaration
    order, so a sum-driven soma sees its branches' NEW values), then the
    threshold fires and resets, then spike-driven states integrate the
    fresh spikes.
    """
    dtype, dev = current.dtype, current.device
    vals = {sv.name: state[sv.name] for sv in prog.states}
    for sv in prog.states:
        if sv.drive == "spikes":
            continue
        c = (current if sv.drive == "current"
             else vals[sv.drive[4:]].sum(dim=-2))
        vals[sv.name] = diff(vals[sv.name],
                             decay_array(sv.decay, params, dtype, dev), c)
    if prog.threshold is None:
        return vals, vals[prog.output]
    th = prog.threshold
    level = th.base + (th.scale * vals[th.adapt] if th.adapt else 0.0)
    s = spike(vals[th.on] - level, surrogate, alpha)
    if prog.reset == "zero":
        vals[th.on] = vals[th.on] * (1.0 - s)
    elif prog.reset == "subtract":
        vals[th.on] = vals[th.on] - level * s
    for sv in prog.states:
        if sv.drive == "spikes":
            vals[sv.name] = diff(vals[sv.name],
                                 decay_array(sv.decay, params, dtype, dev), s)
    return vals, (s if prog.output == "spikes" else vals[prog.output])


# ---------------------------------------------------------------------------
# Neuron specs (thin factories over programs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NeuronSpec:
    """Base class: a programmable neuron is a NeuronProgram plus the
    surrogate-gradient choice; `init_state` and `fire` are generic
    interpreters over `self.program`."""

    surrogate: str = "rectangle"
    alpha: float = 1.0

    @property
    def program(self) -> NeuronProgram:
        raise NotImplementedError

    def init_state(self, shape, dtype=torch.float32,
                   device: Any = "cuda") -> State:
        """Zero states on `device` (default the card; pass device="cpu"
        to run on the CPU)."""
        device = resolve_device(device)
        prog = self.program
        state = {}
        for sv in prog.states:
            s = (tuple(shape[:-1]) + (prog.n_branches,) + tuple(shape[-1:])
                 if sv.branch else tuple(shape))
            state[sv.name] = torch.zeros(s, dtype=dtype, device=device)
        return state

    def fire(self, state: State, current: torch.Tensor,
             params: Optional[Dict[str, Any]] = None
             ) -> Tuple[State, torch.Tensor]:
        """One FIRE-stage update given the INTEG-stage current."""
        return program_fire(self.program, state, current, params,
                            self.surrogate, self.alpha)

    def param_init(self, generator: torch.Generator,
                   shape) -> Dict[str, torch.Tensor]:
        """Learnable per-neuron parameters (empty for fixed models)."""
        return {}


@dataclasses.dataclass(frozen=True)
class ProgramNeuron(NeuronSpec):
    """A NeuronSpec defined directly by its program — the user-space entry
    point for custom dynamics. Validates at construction."""

    prog: NeuronProgram = NeuronProgram(
        states=(StateVar("v", Decay("const", 0.9)),), threshold=Threshold())

    def __post_init__(self):
        validate_program(self.prog)

    @property
    def program(self) -> NeuronProgram:
        return self.prog


@dataclasses.dataclass(frozen=True)
class LIF(NeuronSpec):
    """Leaky integrate-and-fire, paper eqs. (1)-(3). Hard reset to zero by
    default; `reset="subtract"` keeps the suprathreshold residue."""

    tau: float = 0.9
    v_th: float = 1.0
    reset: str = "zero"

    @property
    def program(self) -> NeuronProgram:
        return NeuronProgram(
            states=(StateVar("v", Decay("const", self.tau)),),
            threshold=Threshold(base=self.v_th), reset=self.reset)


@dataclasses.dataclass(frozen=True)
class PLIF(NeuronSpec):
    """Parametric LIF: tau = sigmoid(w_tau), a learnable per-neuron decay."""

    v_th: float = 1.0
    tau_init: float = 2.0     # sigmoid(2.0) ~= 0.88

    @property
    def program(self) -> NeuronProgram:
        fallback = 1.0 / (1.0 + math.exp(-self.tau_init))
        return NeuronProgram(
            states=(StateVar("v", Decay("learned", fallback, "w_tau")),),
            threshold=Threshold(base=self.v_th))

    def param_init(self, generator, shape):
        return {"w_tau": torch.full(tuple(shape[-1:]), self.tau_init)}


@dataclasses.dataclass(frozen=True)
class ALIF(NeuronSpec):
    """Adaptive-threshold LIF (Yin/Corradi/Bohte 2021), the paper's ECG model.

    Threshold: th(t) = v_th + beta * a(t); a' = rho * a + s.
    """

    tau: float = 0.9
    rho: float = 0.97        # adaptation decay
    beta: float = 1.8        # adaptation strength
    v_th: float = 1.0

    @property
    def program(self) -> NeuronProgram:
        return NeuronProgram(
            states=(StateVar("v", Decay("learned", self.tau, "w_tau")),
                    StateVar("a", Decay("learned", self.rho, "w_rho"),
                             drive="spikes")),
            threshold=Threshold(base=self.v_th, adapt="a", scale=self.beta))

    def param_init(self, generator, shape):
        # heterogeneous time constants: learnable logits around the defaults
        n = shape[-1]
        return {
            "w_tau": math.log(self.tau / (1 - self.tau))
            + 0.5 * torch.randn((n,), generator=generator),
            "w_rho": math.log(self.rho / (1 - self.rho))
            + 0.5 * torch.randn((n,), generator=generator),
        }


@dataclasses.dataclass(frozen=True)
class DHLIF(NeuronSpec):
    """Dendritic-heterogeneity LIF (Zheng et al. 2024), the paper's SHD model.

    Each neuron has `n_branches` dendritic compartments with their own decay
    tau_d; branch currents are integrated separately and summed into the
    soma. `fire` expects `current` of shape (..., n_branches, n).
    """

    n_branches: int = 4
    tau: float = 0.9
    v_th: float = 1.0
    tau_s_init: float = 2.0   # soma-decay logit; sigmoid(2.0) ~= 0.88

    @property
    def program(self) -> NeuronProgram:
        soma_fallback = 1.0 / (1.0 + math.exp(-self.tau_s_init))
        return NeuronProgram(
            states=(StateVar("d", Decay("per_branch", self.tau, "w_tau_d"),
                             branch=True),
                    StateVar("v", Decay("learned", soma_fallback, "w_tau_s"),
                             drive="sum:d")),
            threshold=Threshold(base=self.v_th),
            n_branches=self.n_branches)

    def param_init(self, generator, shape):
        n = shape[-1]
        # heterogeneous branch time constants — log-spaced around tau
        base = torch.linspace(1.0, 6.0, self.n_branches)[:, None]
        return {"w_tau_d": base.expand(self.n_branches, n).contiguous(),
                "w_tau_s": torch.full((n,), self.tau_s_init)}


@dataclasses.dataclass(frozen=True)
class LI(NeuronSpec):
    """Non-spiking leaky integrator readout (no fire, no reset)."""

    tau: float = 0.95

    @property
    def program(self) -> NeuronProgram:
        return NeuronProgram(
            states=(StateVar("v", Decay("const", self.tau)),),
            threshold=None, reset="none", output="v")


NEURON_REGISTRY: Dict[str, Callable[..., NeuronSpec]] = {
    "lif": LIF,
    "plif": PLIF,
    "alif": ALIF,
    "dhlif": DHLIF,
    "li": LI,
}


def register_neuron(name: str, factory: Callable[..., NeuronSpec], *,
                    override: bool = False) -> Callable[..., NeuronSpec]:
    """Name a factory (class or function returning a NeuronSpec) so
    configs can `make_neuron(name)` it. Duplicate names raise unless
    `override=True`."""
    if not override and name in NEURON_REGISTRY:
        raise ValueError(f"neuron {name!r} already registered "
                         f"({NEURON_REGISTRY[name]!r}); pass override=True "
                         "to replace it")
    NEURON_REGISTRY[name] = factory
    return factory


def make_neuron(name: str, **kwargs) -> NeuronSpec:
    if name not in NEURON_REGISTRY:
        raise KeyError(f"unknown neuron {name!r}; registered: "
                       f"{sorted(NEURON_REGISTRY)}")
    return NEURON_REGISTRY[name](**kwargs)


__all__ = ["Decay", "StateVar", "Threshold", "NeuronProgram",
           "validate_program", "decay_array", "program_fire", "diff",
           "locacc", "NeuronSpec", "ProgramNeuron", "LIF", "PLIF", "ALIF",
           "DHLIF", "LI", "NEURON_REGISTRY", "register_neuron",
           "make_neuron"]
