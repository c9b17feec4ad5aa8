"""On-chip learning rules (paper §II-A, §IV-B, Fig. 9d-e).

The port of `repro/core/plasticity.py`. Synapses are as programmable as
neurons: a learning rule is a declarative `SynapseProgram`, mirroring
`core/neuron.py::NeuronProgram`:

  * **traces** — `TraceVar`s, each one DIFF update
    ``trace' = decay * trace + scale * spikes(source)`` driven by the pre-
    or post-synaptic spike train (`update="after"` makes weight terms read
    the previous-step value, as triplet STDP's slow traces require);
  * **terms** — event-gated outer-product weight updates with signed
    amplitudes: ``dw += amp * prod(pre factors)^T prod(post factors)``,
    batch-summed, where a factor is ``"spikes"``, a trace name, or
    ``"mod"`` (the external modulator/reward plane — post side only);
  * **bounds** — per-step ``clip(w + dw, w_min, w_max)``.

One generic interpreter (`synapse_step` / `synapse_run`) executes any
valid program; pair STDP, triplet STDP, reward-modulated STDP and the
paper's accumulated-spike rule are thin factories over programs, and
`register_synapse(name, factory)` opens the menu to user rules. The plan
compiler (`core/plan.py`) pattern-matches a program's structure and lowers
matching programs to the `stdp_seq` kernel (trace DIFFs hoisted through
`linrec`, all T outer-product updates applied in one launch); anything
else runs through the per-step interpreter. Attach a program to a
`Connection(plastic=...)` (`core/events.py`) and learning runs inside
`plan.run`.

Semantics (chunked-online): within one `run` window the forward pass uses
the entry weights; traces and weight updates integrate across the window's
realized spike trains, and the learned weight is published in the
returned state (`state[node]["syn:<conn>"]["w"]`). `apply_learned` merges
it back into params between chunks.

Nothing here writes into a tensor it was given: `synapse_init`'s state
holds the params tensor itself as "w", and every update builds a new one,
so params keep their values until `apply_learned` swaps them.

The legacy pair-STDP API (`STDPConfig`, `stdp_step`, `stdp_run`) is kept;
`use_kernel=True` routes its weight update through the `stdp` kernel,
`use_kernel=False` is its own einsum form.

The accumulated-spike readout (`accumulated_spike_fc`, an
`autograd.Function` whose backward keeps only the time-summed spikes) and
the BN1d+FC fusion (`fuse_bn1d_fc`) are the BCI decoder's on-chip
learning (`core/snn_layers.py::bci_finetune_fc`). Both are dense products
that the JAX package leaves to `jnp` outside any Pallas kernel, so
`torch.sum` and `torch.matmul` compute them here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.neuron import Decay, decay_array, diff
from repro_torch.kernels.common import DeviceLike, resolve_device

Tensor = torch.Tensor

_PSEUDO_FACTORS = ("spikes", "mod")


# ---------------------------------------------------------------------------
# the synapse-program IR
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TraceVar:
    """One DIFF synaptic trace: trace' = decay * trace + scale * spikes.

    source: "pre" (presynaptic spike train, shape (B, n_pre)) or "post"
            (this node's emitted spikes, (B, n_post)).
    update: "before" — weight terms read the freshly updated value (pair
            STDP's nearest-spike traces); "after" — terms read the
            previous-step value (triplet STDP's slow traces, which gate a
            spike *before* integrating it). The trajectory is identical;
            only what the terms observe differs.
    """

    name: str
    source: str
    decay: Decay
    scale: float = 1.0
    update: str = "before"


@dataclasses.dataclass(frozen=True)
class UpdateTerm:
    """One signed outer-product weight update, batch-summed:

        dw += amp * einsum("bi,bj->ij", prod(pre factors), prod(post factors))

    Factors multiply elementwise within a side. "spikes" is the side's
    spike train (making the term event-gated); a trace name reads that
    trace; "mod" (post side only) is the external modulator — the reward
    scalar of R-STDP or the per-neuron teaching signal of the
    accumulated-spike rule. With no modulator supplied at run time, "mod"
    factors evaluate to zero (no reward, no update).
    """

    amp: float
    pre: Tuple[str, ...] = ("spikes",)
    post: Tuple[str, ...] = ("spikes",)


@dataclasses.dataclass(frozen=True)
class SynapseProgram:
    """Declarative synaptic dynamics + learning rule for one Connection."""

    traces: Tuple[TraceVar, ...]
    terms: Tuple[UpdateTerm, ...]
    w_min: float = -1.0
    w_max: float = 1.0


def validate_synapse_program(prog: SynapseProgram) -> SynapseProgram:
    """Raise ValueError on a structurally invalid program; return it."""
    names = [t.name for t in prog.traces]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate trace names: {names}")
    by_name = {t.name: t for t in prog.traces}
    for tr in prog.traces:
        if tr.name in _PSEUDO_FACTORS + ("w",):
            raise ValueError(f"trace name {tr.name!r} is reserved")
        if tr.source not in ("pre", "post"):
            raise ValueError(f"trace {tr.name!r}: bad source {tr.source!r}")
        if tr.update not in ("before", "after"):
            raise ValueError(f"trace {tr.name!r}: bad update {tr.update!r}")
        if tr.decay.kind not in ("const", "learned"):
            raise ValueError(f"trace {tr.name!r}: bad decay kind "
                             f"{tr.decay.kind!r}")
        if tr.decay.kind == "learned" and not tr.decay.param:
            raise ValueError(f"trace {tr.name!r}: learned decay needs a "
                             "param name")
    if not prog.terms:
        raise ValueError("program needs at least one update term")
    for i, term in enumerate(prog.terms):
        if not math.isfinite(term.amp):
            raise ValueError(f"term {i}: non-finite amp {term.amp!r}")
        for side, factors in (("pre", term.pre), ("post", term.post)):
            if not factors:
                raise ValueError(f"term {i}: empty {side} factor list")
            for f in factors:
                if f == "spikes":
                    continue
                if f == "mod":
                    if side == "pre":
                        raise ValueError(f"term {i}: 'mod' is a post-side "
                                         "factor")
                    continue
                if f not in by_name:
                    raise ValueError(f"term {i}: unknown factor {f!r}")
                if by_name[f].source != side:
                    raise ValueError(f"term {i}: {side} factor {f!r} reads "
                                     f"a {by_name[f].source} trace")
    if not prog.w_min <= prog.w_max:
        raise ValueError(f"w_min {prog.w_min} > w_max {prog.w_max}")
    return prog


# ---------------------------------------------------------------------------
# the per-step reference interpreter
# ---------------------------------------------------------------------------


def synapse_init(prog: SynapseProgram, w: Tensor,
                 batch: int) -> Dict[str, Tensor]:
    """Synapse state for one Connection: zero traces + the live weight
    (the tensor itself, on its device).

    Trace shapes derive from the weight: pre traces are (batch, w.shape[0]),
    post traces (batch, w.shape[1]).
    """
    syn = {"w": w}
    for tr in prog.traces:
        n = w.shape[0] if tr.source == "pre" else w.shape[1]
        syn[tr.name] = torch.zeros((batch, n), dtype=w.dtype,
                                   device=w.device)
    return syn


def mod_plane(mod: Any, batch: int, n_post: int, dtype,
              device: DeviceLike = "cuda") -> Tensor:
    """Broadcast a modulator signal to the (batch, n_post) term plane.

    Accepts None (-> zeros: no reward, no update), a scalar (global
    reward), (batch,) per-trial reward, or (batch, n_post) per-neuron
    teaching signal. A tensor keeps its device; a scalar or None goes to
    `device` (default the card).
    """
    if torch.is_tensor(mod):
        m = mod.to(dtype)
    else:
        dev = resolve_device(device)
        if mod is None:
            return torch.zeros((batch, n_post), dtype=dtype, device=dev)
        m = torch.as_tensor(mod, dtype=dtype, device=dev)
    if m.dim() == 1:
        m = m[:, None]
    return m.expand(batch, n_post)


def synapse_step(prog: SynapseProgram, syn: Dict[str, Tensor],
                 s_pre: Tensor, s_post: Tensor, mod: Any = None,
                 params: Optional[Dict[str, Tensor]] = None
                 ) -> Dict[str, Tensor]:
    """One event-driven step of a SynapseProgram — the lowering oracle.

    s_pre: (B, n_pre) delivered presynaptic spikes; s_post: (B, n_post)
    emitted spikes; syn: {"w": (n_pre, n_post), <trace>: (B, n)}. Phase
    order: traces integrate their DIFF update, then every term's outer
    product accumulates into the weight ("before" traces are read fresh,
    "after" traces at their pre-update value), then the bounds clip.
    """
    by_name = {t.name: t for t in prog.traces}
    old = {t.name: syn[t.name] for t in prog.traces}
    new: Dict[str, Tensor] = {}
    for tr in prog.traces:
        drive = s_pre if tr.source == "pre" else s_post
        tau = decay_array(tr.decay, params, drive.dtype, drive.device)
        new[tr.name] = diff(old[tr.name], tau, tr.scale * drive)

    mod_p = mod_plane(mod, s_post.shape[0], s_post.shape[1], s_post.dtype,
                      s_post.device)

    def side(factors, spikes):
        val = None
        for f in factors:
            if f == "spikes":
                v = spikes
            elif f == "mod":
                v = mod_p
            else:
                v = new[f] if by_name[f].update == "before" else old[f]
            val = v if val is None else val * v
        return val

    w = syn["w"]
    dw = torch.zeros_like(w)
    for term in prog.terms:
        p = side(term.pre, s_pre)
        q = side(term.post, s_post)
        dw = dw + term.amp * torch.einsum("bi,bj->ij", p, q)
    out = dict(new)
    out["w"] = torch.clamp(w + dw, prog.w_min, prog.w_max)
    return out


def synapse_run(prog: SynapseProgram, w: Tensor, pre_spikes: Tensor,
                post_spikes: Tensor, mod: Any = None,
                params: Optional[Dict[str, Tensor]] = None,
                syn: Optional[Dict[str, Tensor]] = None) -> Dict[str, Tensor]:
    """`synapse_step` over (T, B, n) spike-train pairs, one step at a time.

    The per-step reference the fused plan lowering is held against. `mod`,
    if given, is (T,), (T, B), or (T, B, n_post). Returns the final synapse
    state (learned weight + final traces).
    """
    if syn is None:
        syn = synapse_init(prog, w, pre_spikes.shape[1])
    T = pre_spikes.shape[0]
    if mod is None:
        mod_ts = torch.zeros((T, 1), dtype=pre_spikes.dtype,
                             device=pre_spikes.device)
    else:
        mod_ts = torch.as_tensor(mod, device=pre_spikes.device)
        if mod_ts.dim() == 1:
            mod_ts = mod_ts[:, None]
    for t in range(T):
        syn = synapse_step(prog, syn, pre_spikes[t], post_spikes[t],
                           mod_ts[t], params)
    return syn


# ---------------------------------------------------------------------------
# built-in rule factories (all thin programs; all plan-lowerable)
# ---------------------------------------------------------------------------


def pair_stdp(a_plus: float = 0.01, a_minus: float = 0.012,
              tau_plus: float = 0.9, tau_minus: float = 0.9,
              w_min: float = -1.0, w_max: float = 1.0) -> SynapseProgram:
    """Classic pair-based STDP: causal pairs potentiate, acausal depress.

    On a post spike, potentiate by the presynaptic trace (recent causal
    pres); on a pre spike, depress by the postsynaptic trace. Numerically
    identical to the legacy `stdp_step` loop.
    """
    return validate_synapse_program(SynapseProgram(
        traces=(TraceVar("x_pre", "pre", Decay("const", tau_plus)),
                TraceVar("x_post", "post", Decay("const", tau_minus))),
        terms=(UpdateTerm(a_plus, pre=("x_pre",), post=("spikes",)),
               UpdateTerm(-a_minus, pre=("spikes",), post=("x_post",)),),
        w_min=w_min, w_max=w_max))


def triplet_stdp(a2_plus: float = 0.006, a3_plus: float = 0.006,
                 a2_minus: float = 0.007, a3_minus: float = 0.002,
                 tau_plus: float = 0.9, tau_x: float = 0.95,
                 tau_minus: float = 0.9, tau_y: float = 0.97,
                 w_min: float = -1.0, w_max: float = 1.0) -> SynapseProgram:
    """Triplet STDP (Pfister & Gerstner 2006, all-to-all).

    Fast traces (r1 pre, o1 post) implement the pair terms; slow traces
    (r2 pre, o2 post) are read at their *previous-step* value
    (`update="after"`) and gate the triplet interactions — LTP grows with
    recent post activity, LTD with recent pre activity.
    """
    return validate_synapse_program(SynapseProgram(
        traces=(TraceVar("r1", "pre", Decay("const", tau_plus)),
                TraceVar("r2", "pre", Decay("const", tau_x), update="after"),
                TraceVar("o1", "post", Decay("const", tau_minus)),
                TraceVar("o2", "post", Decay("const", tau_y), update="after")),
        terms=(UpdateTerm(a2_plus, pre=("r1",), post=("spikes",)),
               UpdateTerm(a3_plus, pre=("r1",), post=("spikes", "o2")),
               UpdateTerm(-a2_minus, pre=("spikes",), post=("o1",)),
               UpdateTerm(-a3_minus, pre=("spikes", "r2"), post=("o1",)),),
        w_min=w_min, w_max=w_max))


def reward_stdp(a_plus: float = 0.01, a_minus: float = 0.012,
                tau_plus: float = 0.9, tau_minus: float = 0.9,
                w_min: float = -1.0, w_max: float = 1.0) -> SynapseProgram:
    """Reward-modulated STDP: the pair rule gated by the modulator.

    Every term carries the "mod" factor, so dw = r_t * dw_pair; with no
    reward signal supplied the weights stay frozen. Feed `mod` as a (T,)
    global reward or (T, B) per-trial reward to `plan.run(mod=...)`.
    """
    return validate_synapse_program(SynapseProgram(
        traces=(TraceVar("x_pre", "pre", Decay("const", tau_plus)),
                TraceVar("x_post", "post", Decay("const", tau_minus))),
        terms=(UpdateTerm(a_plus, pre=("x_pre",), post=("spikes", "mod")),
               UpdateTerm(-a_minus, pre=("spikes",), post=("x_post", "mod")),),
        w_min=w_min, w_max=w_max))


def accumulated_spike(lr: float = 0.05, w_min: float = -float("inf"),
                      w_max: float = float("inf")) -> SynapseProgram:
    """The paper's accumulated-spike rule as a synapse program (§IV-B).

    A decay-1 trace accumulates presynaptic spikes over the window; the
    single term applies dw = lr * acc ⊗ mod, so supplying the per-neuron
    teaching signal (e.g. -dL/dlogits) on the final step reproduces the
    accumulated-spike FC update dW = lr * (sum_t s_t) ⊗ delta exactly.
    """
    return validate_synapse_program(SynapseProgram(
        traces=(TraceVar("acc", "pre", Decay("const", 1.0)),),
        terms=(UpdateTerm(lr, pre=("acc",), post=("mod",)),),
        w_min=w_min, w_max=w_max))


SYNAPSE_REGISTRY: Dict[str, Callable[..., SynapseProgram]] = {
    "pair_stdp": pair_stdp,
    "triplet_stdp": triplet_stdp,
    "reward_stdp": reward_stdp,
    "accumulated_spike": accumulated_spike,
}


def register_synapse(name: str, factory: Callable[..., SynapseProgram], *,
                     override: bool = False
                     ) -> Callable[..., SynapseProgram]:
    """Open the synapse menu: name a factory returning a SynapseProgram so
    configs/CLIs can `make_synapse(name)` it. Duplicate names raise unless
    `override=True` (deliberate replacement)."""
    if not override and name in SYNAPSE_REGISTRY:
        raise ValueError(f"synapse rule {name!r} already registered "
                         f"({SYNAPSE_REGISTRY[name]!r}); pass override=True "
                         "to replace it")
    SYNAPSE_REGISTRY[name] = factory
    return factory


def make_synapse(name: str, **kwargs) -> SynapseProgram:
    if name not in SYNAPSE_REGISTRY:
        raise KeyError(f"unknown synapse rule {name!r}; registered: "
                       f"{sorted(SYNAPSE_REGISTRY)}")
    return SYNAPSE_REGISTRY[name](**kwargs)


def apply_learned(nodes, params: Dict[str, Any],
                  state: Dict[str, Any]) -> Dict[str, Any]:
    """Merge learned weights out of the run state back into params.

    For every plastic Connection, `state[node]["syn:<conn>"]["w"]` replaces
    `params[node][<weight key>]` — call between chunks to make the next
    window's forward pass see the updates (chunked-online semantics). The
    result is a new params tree; `params` itself is not changed. A state
    whose weights are stacked into (S, n_pre, n_post), as the serve engine
    stacks a learning cohort, gives `plan.run` one weight a batch row.
    """
    out = dict(params)
    for n in nodes:
        for c in n.connections:
            if c.plastic is None:
                continue
            syn = state.get(n.name, {}).get(f"syn:{c.key}")
            if syn is not None:
                out[n.name] = dict(out.get(n.name, {}))
                out[n.name][c.weight_key] = syn["w"]
    return out


# ---------------------------------------------------------------------------
# legacy pair-STDP API (kept: the hand-written loop the program replaces)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class STDPConfig:
    a_plus: float = 0.01        # potentiation amplitude (causal,  dt > 0)
    a_minus: float = 0.012      # depression amplitude  (acausal, dt < 0)
    tau_plus: float = 0.9       # pre-trace decay  per timestep
    tau_minus: float = 0.9      # post-trace decay per timestep
    w_min: float = -1.0
    w_max: float = 1.0

    @property
    def program(self) -> SynapseProgram:
        """The declarative equivalent of this config's hand-coded rule."""
        return pair_stdp(self.a_plus, self.a_minus, self.tau_plus,
                         self.tau_minus, self.w_min, self.w_max)


def stdp_init(n_pre: int, n_post: int, batch: int = 1,
              dtype: torch.dtype = torch.float32,
              device: DeviceLike = "cuda") -> Dict[str, Tensor]:
    """Zero pre and post traces on `device` (default the card; pass
    device="cpu" to run on the CPU)."""
    dev = resolve_device(device)
    return {"x_pre": torch.zeros((batch, n_pre), dtype=dtype, device=dev),
            "x_post": torch.zeros((batch, n_post), dtype=dtype, device=dev)}


def stdp_step(cfg: STDPConfig, traces: Dict[str, Tensor], w: Tensor,
              s_pre: Tensor, s_post: Tensor,
              use_kernel: bool = False) -> Tuple[Dict[str, Tensor], Tensor]:
    """One event-driven STDP update.

    s_pre: (batch, n_pre) spikes at t;  s_post: (batch, n_post) spikes at t.
    On a post spike, potentiate by the presynaptic trace (recent causal
    pres); on a pre spike, depress by the postsynaptic trace. All terms are
    outer products of events with traces — what the chip computes in the
    FIRE stage, batched here. `use_kernel` routes the weight update through
    the `stdp` kernel family (`kernels/stdp`: the hand kernel on the card,
    its plain version on the CPU); otherwise it is two einsums and a clip.
    """
    x_pre = diff(traces["x_pre"], cfg.tau_plus, s_pre)     # DIFF drives traces
    x_post = diff(traces["x_post"], cfg.tau_minus, s_post)
    if use_kernel:
        from repro_torch.kernels.stdp.ops import stdp_update
        w = stdp_update(x_pre.contiguous(), s_post.contiguous(),
                        s_pre.contiguous(), x_post.contiguous(), w,
                        a_plus=cfg.a_plus, a_minus=cfg.a_minus,
                        w_min=cfg.w_min, w_max=cfg.w_max)
    else:
        dw_pot = cfg.a_plus * torch.einsum("bi,bj->ij", x_pre, s_post)
        dw_dep = cfg.a_minus * torch.einsum("bi,bj->ij", s_pre, x_post)
        w = torch.clamp(w + dw_pot - dw_dep, cfg.w_min, cfg.w_max)
    return {"x_pre": x_pre, "x_post": x_post}, w


def stdp_run(cfg: STDPConfig, w: Tensor, pre_spikes: Tensor,
             post_spikes: Tensor, use_kernel: bool = False) -> Tensor:
    """Run STDP over a (T, batch, n) spike train pair; returns final
    weights. `use_kernel` is passed to every `stdp_step`."""
    traces = stdp_init(w.shape[0], w.shape[1], pre_spikes.shape[1],
                       pre_spikes.dtype, device=pre_spikes.device)
    for t in range(pre_spikes.shape[0]):
        traces, w = stdp_step(cfg, traces, w, pre_spikes[t], post_spikes[t],
                              use_kernel=use_kernel)
    return w


# ---------------------------------------------------------------------------
# Accumulated-spike backprop (the paper's on-chip BPTT memory optimization)
# ---------------------------------------------------------------------------


class _AccumulatedSpikeFC(torch.autograd.Function):
    """logits = (sum_t s_t) @ W + T * b, saving only the accumulated spikes
    (and W), not the (T, B, N) history."""

    @staticmethod
    def forward(ctx, spikes_t, w, b):
        T = spikes_t.shape[0]
        acc = torch.sum(spikes_t, dim=0)       # the only stored activation
        ctx.save_for_backward(acc, w)
        ctx.T = T
        return acc @ w + T * b

    @staticmethod
    def backward(ctx, ct):
        acc, w = ctx.saved_tensors
        T = ctx.T
        need_s, need_w, need_b = ctx.needs_input_grad
        # upstream sees the gradient spread uniformly over time (the
        # accumulated approximation of §IV-B: 'accumulated spikes are used
        # instead of timestep-by-timestep spikes'): a stride-0 view over T
        d_spikes = ((ct @ w.T)[None].expand((T,) + acc.shape)
                    if need_s else None)
        dw = acc.T @ ct if need_w else None    # exact: delta (x) sum_t s_t
        db = T * torch.sum(ct, dim=0) if need_b else None
        return d_spikes, dw, db


def accumulated_spike_fc(spikes_t: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Time-summed FC readout: logits = (sum_t s_t) @ W + T*b.

    Forward is mathematically identical to sum_t (s_t @ W + b); backward
    stores ONLY the accumulated spikes (not the (T, B, N) history), which is
    the paper's on-chip learning trick. Input: (T, B, N). Output: (B, M).
    Gradients: d_acc = ct W^T broadcast over T to the spikes, dW = acc^T ct,
    db = T sum_b ct, each computed only where autograd asks for it."""
    return _AccumulatedSpikeFC.apply(spikes_t, w, b)


def fuse_bn1d_fc(gamma, beta, mean, var, eps, w, b):
    """BN1d + FC fusion (paper Fig. 9d: 'fused weights'/'fused bias').

    y = ((x - mean)/sqrt(var+eps) * gamma + beta) @ W + b
      =  x @ W' + b'  with  W' = diag(gamma/std) W,  b' = (beta - mean*gamma/std) @ W + b
    """
    std = torch.sqrt(var + eps)
    scale = gamma / std
    w_fused = scale[:, None] * w
    b_fused = (beta - mean * scale) @ w + b
    return w_fused, b_fused


__all__ = ["TraceVar", "UpdateTerm", "SynapseProgram",
           "validate_synapse_program", "synapse_init", "mod_plane",
           "synapse_step", "synapse_run", "pair_stdp", "triplet_stdp",
           "reward_stdp", "accumulated_spike", "SYNAPSE_REGISTRY",
           "register_synapse", "make_synapse", "apply_learned",
           "STDPConfig", "stdp_init", "stdp_step", "stdp_run",
           "accumulated_spike_fc", "fuse_bn1d_fc"]
