"""SNN layer library + the paper's ECG and SHD models (§V-B3).

The port of `repro/core/snn_layers.py`, serving slices:

  ff_integrate, branch_integrate — the INTEG conventions the plan compiler
                 hoists (their `.hoist` tags)
  srnn_ecg     — 4 -> 64 self-recurrent ALIF -> 6 LI readout (Yin et al.
                 2021), the ECG/QTDB task; `heterogeneous=False` is the
                 homogeneous LIF ablation.
  dhsnn_shd    — 700 -> 64 DH-LIF (4 dendritic branches) -> 20 LI readout
                 (Zheng et al. 2024), the SHD speech task;
                 `dendritic=False` is the homogeneous LIF ablation.
  plastic_ff   — a 2-layer LIF stack whose input connection learns on-chip
                 (the plasticity bench, the online-STDP example).
  bci          — the cross-day BCI decoder: 16 sub-paths of (linear
                 transform, channel attention, temporal conv), Hadamard
                 fusion, concat -> LIF -> fused BN1d+FC readout with
                 accumulated-spike on-chip learning (`BCIConfig`,
                 `bci_init`, `bci_forward`, `bci_finetune_fc`).

Weights are drawn on the CPU from a torch.Generator and then moved, so one
seed gives the same weights on every device.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core import events
from repro_torch.core.neuron import ALIF, DHLIF, LI, LIF, locacc
from repro_torch.core.plasticity import (SynapseProgram,
                                         accumulated_spike_fc, pair_stdp)
from repro_torch.kernels.common import DeviceLike, resolve_device, tree_to
from repro_torch.kernels.lif.ops import lif_scan


def _dense_init(generator: torch.Generator, n_in: int, n_out: int,
                scale=None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(n_in)
    return scale * torch.randn((n_in, n_out), generator=generator)


# ---------------------------------------------------------------------------
# integrate functions (INTEG stage): spikes -> currents
# ---------------------------------------------------------------------------


def ff_integrate(params, feeds):
    """sum over inbound feeds of  s @ W_feed  (LOCACC)."""
    cur = 0.0
    for name, s in feeds.items():
        key = name.split("@")[0]
        cur = cur + locacc(s, params[f"w_{key}"])
    return cur


# The `hoist` tag tells the plan compiler (core/plan.py) this INTEG is the
# per-feed `s @ w_<src>` convention, so it can be lifted out of the time
# loop as one all-T spikemm per feed.
ff_integrate.hoist = "ff"


def branch_integrate(params, feeds):
    """DH-LIF INTEG: input split over dendritic branches.

    w_input: (n_branches, n_in, n_out); current: (batch, n_branches, n_out).
    """
    (src, s), = feeds.items()
    w = params["w_input"]
    if not s.dtype.is_floating_point:
        s = s.to(w.dtype)
    return torch.einsum("bi,kio->bko", s, w)


# The "branch" hoist convention: single feed, weights (n_branches, n_in,
# n_out) under the fixed key `w_input`. The plan compiler lifts the einsum
# out of the time loop as one spikemm against the (n_in, K*n_out) view.
branch_integrate.hoist = "branch"


# ---------------------------------------------------------------------------
# SRNN for ECG (QTDB)
# ---------------------------------------------------------------------------


def make_srnn_ecg(generator: torch.Generator, n_in: int = 4,
                  n_hidden: int = 64, n_out: int = 6,
                  heterogeneous: bool = True, device: DeviceLike = "cuda"):
    """The paper's ECG model -> (nodes, params), params on `device`.

    Input: level-crossing-coded ECG, (T=1301, batch, 4). Output:
    per-timestep band logits (the readout's membrane). The hidden layer
    reads the input and its own previous spikes (`w_self`); the sigmoid
    surrogate with alpha=4 is the reference's training choice, kept so the
    programs compare equal. `heterogeneous=False` is the homogeneous LIF
    ablation (no per-neuron decays: params["hidden"]["neuron"] is None)."""
    dev = resolve_device(device)
    hidden_neuron = (ALIF(surrogate="sigmoid", alpha=4.0, beta=0.5)
                     if heterogeneous else LIF(surrogate="sigmoid", alpha=4.0))
    nodes = [
        events.LayerNode("hidden", hidden_neuron, ff_integrate,
                         inputs=("input", "self"), out_dim=n_hidden),
        events.LayerNode("readout", LI(tau=0.95), ff_integrate,
                         inputs=("hidden",), out_dim=n_out),
    ]
    # the connection weights come first, so both variants of one seed share
    # them and differ only in the hidden neurons
    w_in = _dense_init(generator, n_in, n_hidden)
    w_self = 0.1 * torch.randn((n_hidden, n_hidden), generator=generator)
    w_out = _dense_init(generator, n_hidden, n_out)
    neuron = (hidden_neuron.param_init(generator, (n_hidden,))
              if heterogeneous else None)
    params = {
        "hidden": {"w_input": w_in, "w_self": w_self, "neuron": neuron},
        "readout": {"w_hidden": w_out},
    }
    return nodes, tree_to(params, dev)


def make_plastic_ff(generator: torch.Generator, n_in: int = 64,
                    n_hidden: int = 32, n_out: int = 4,
                    rule: SynapseProgram = None, tau: float = 0.8,
                    v_th: float = 0.6, device: DeviceLike = "cuda"):
    """A 2-layer LIF stack whose input connection learns on-chip ->
    (nodes, params), params on `device`.

    The hidden layer's input edge carries `rule` (default: pair STDP), so
    under `plan.run` the weight `w_input` updates over every window — the
    `stdp_seq` lowering when the rule's structure matches, the per-step
    interpreter otherwise. Used by the plasticity bench, the `stdp_online`
    example and the synapse-plan tests."""
    dev = resolve_device(device)
    rule = rule if rule is not None else pair_stdp()
    nodes = [
        events.LayerNode("hidden", LIF(tau=tau, v_th=v_th), ff_integrate,
                         inputs=(events.Connection("input", plastic=rule),),
                         out_dim=n_hidden),
        events.LayerNode("readout", LI(tau=0.95), ff_integrate,
                         inputs=(events.Connection("hidden"),),
                         out_dim=n_out),
    ]
    params = {"hidden": {"w_input": _dense_init(generator, n_in, n_hidden)},
              "readout": {"w_hidden": _dense_init(generator, n_hidden,
                                                  n_out)}}
    return nodes, tree_to(params, dev)


# ---------------------------------------------------------------------------
# DHSNN for SHD speech
# ---------------------------------------------------------------------------


def make_dhsnn_shd(generator: torch.Generator, n_in: int = 700,
                   n_hidden: int = 64, n_out: int = 20, n_branches: int = 4,
                   dendritic: bool = True, device: DeviceLike = "cuda"):
    """The paper's speech model -> (nodes, params), params on `device`.

    Weights are drawn on the CPU from `generator` (a CPU torch.Generator)
    and then moved, so one seed gives the same weights on every device.
    `dendritic=False` is the homogeneous ablation."""
    dev = resolve_device(device)
    if dendritic:
        neuron = DHLIF(n_branches=n_branches)
        hidden = events.LayerNode("hidden", neuron, branch_integrate,
                                  inputs=("input",), out_dim=n_hidden)
        w_in = (1.0 / math.sqrt(n_in)) * torch.randn(
            (n_branches, n_in, n_hidden), generator=generator)
        hparams = {"w_input": w_in,
                   "neuron": neuron.param_init(generator, (n_hidden,))}
    else:
        hidden = events.LayerNode("hidden", LIF(), ff_integrate,
                                  inputs=("input",), out_dim=n_hidden)
        hparams = {"w_input": _dense_init(generator, n_in, n_hidden)}
    nodes = [hidden,
             events.LayerNode("readout", LI(tau=0.97), ff_integrate,
                              inputs=("hidden",), out_dim=n_out)]
    params = {"hidden": hparams,
              "readout": {"w_hidden": _dense_init(generator, n_hidden,
                                                  n_out)}}
    return nodes, tree_to(params, dev)


# ---------------------------------------------------------------------------
# BCI cross-day decoder (16 sub-paths + on-chip learning)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BCIConfig:
    n_channels: int = 128       # M1 array channels
    n_steps: int = 50           # 20 ms windows
    n_paths: int = 16
    d_path: int = 32            # per-path feature width
    kernel_t: int = 5           # temporal conv width
    n_out: int = 4              # hand-movement classes


def bci_init(generator: torch.Generator, cfg: BCIConfig,
             device: DeviceLike = "cuda"):
    """The decoder's parameters {lin, attn, tconv, fc_w, fc_b}, drawn on
    the CPU from `generator` and moved to `device`."""
    dev = resolve_device(device)
    C, P, D = cfg.n_channels, cfg.n_paths, cfg.d_path
    s = 1.0 / math.sqrt(C)
    params = {
        "lin": s * torch.randn((P, C, D), generator=generator),
        "attn": s * torch.randn((P, C, C), generator=generator),
        "tconv": (1.0 / math.sqrt(cfg.kernel_t)) * torch.randn(
            (P, cfg.kernel_t, D), generator=generator),
        # fused BN1d+FC readout (Fig. 9d): trained as the fused tensors
        "fc_w": (1.0 / math.sqrt(P * D)) * torch.randn(
            (P * D, cfg.n_out), generator=generator),
        "fc_b": torch.zeros((cfg.n_out,)),
    }
    return tree_to(params, dev)


def bci_features(params, x: torch.Tensor, cfg: BCIConfig) -> torch.Tensor:
    """The LIF layer's input currents (T, batch, P*D) of `bci_forward`.

    Sub-path: linear transform (x) channel attention (x) temporal conv,
    fused by Hadamard product + addition (paper §V-B3), concatenated over
    the paths. The attention projection sums e and c each on its own, as
    the JAX package's einsum does (ROADMAP.md § 3)."""
    B, C, T = x.shape
    # linear transform module: (B, P, T, D)
    lin = torch.einsum("bct,pcd->bptd", x, params["lin"])
    # channel attention: softmax over channels, then project
    att = torch.softmax(torch.einsum("bct,pce->bpet", x, params["attn"]),
                        dim=2)
    att = torch.einsum("bpet,pcd->bptd", att * x[:, None], params["lin"])
    # temporal convolution along t (same-padded, depthwise over D)
    pad = cfg.kernel_t // 2
    lp = F.pad(lin, (0, 0, pad, cfg.kernel_t - 1 - pad))
    idx = (torch.arange(T, device=x.device)[:, None]
           + torch.arange(cfg.kernel_t, device=x.device)[None, :])
    tconv = torch.einsum("bptkd,pkd->bptd", lp[:, :, idx], params["tconv"])
    # Hadamard fusion + addition
    fused = lin * att + tconv                                   # (B, P, T, D)
    return fused.permute(2, 0, 1, 3).reshape(
        T, B, cfg.n_paths * cfg.d_path).contiguous()


def bci_forward(params, x: torch.Tensor, cfg: BCIConfig, lif=LIF(tau=0.8)):
    """x: (batch, n_channels, n_steps) filtered/binned neural signal, on
    the params' device.

    The sub-paths' features (`bci_features`) -> LIF over time ->
    accumulated-spike FC readout (on-chip-learnable). Returns logits
    (batch, n_out) and the spike record (T, batch, P*D). The LIF runs the
    whole (T, B, P*D) current block in one `lif_scan`: `csrc/lif.cu`
    forward and `csrc/lif_bwd.cu` backward on the card."""
    feat = bci_features(params, x, cfg)
    T, B, n_feat = feat.shape
    v0 = torch.zeros((B, n_feat), dtype=feat.dtype, device=feat.device)
    tau = torch.full((n_feat,), lif.tau, dtype=torch.float32,
                     device=feat.device)
    spikes, _ = lif_scan(feat, tau, v0, lif.v_th, lif.surrogate,
                         lif.alpha)                             # (T, B, P*D)
    logits = accumulated_spike_fc(spikes, params["fc_w"], params["fc_b"])
    return logits, spikes


def bci_finetune_fc(params, x_few: torch.Tensor, y_few: torch.Tensor,
                    cfg: BCIConfig, lr: float = 0.05, steps: int = 20):
    """Cross-day on-chip learning (§V-B3): update ONLY the fused FC with
    accumulated-spike backprop on the few samples `x_few`, `y_few` (long).

    Plain SGD, `steps` steps, each re-running the forward (the features
    need no gradient, so no LIF backward runs). Returns (params with the
    tuned `fc_w`/`fc_b`, the (steps,) losses)."""
    frozen = {k: v.detach() for k, v in params.items()
              if k not in ("fc_w", "fc_b")}
    fc = {"fc_w": params["fc_w"].detach(), "fc_b": params["fc_b"].detach()}
    losses = []
    for _ in range(steps):
        leaves = {k: v.requires_grad_() for k, v in fc.items()}
        logits, _ = bci_forward(dict(frozen, **leaves), x_few, cfg)
        logp = torch.log_softmax(logits, dim=-1)
        loss = -torch.mean(logp.gather(1, y_few[:, None]))
        g = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            fc = {k: p - lr * gg for (k, p), gg in zip(leaves.items(), g)}
        losses.append(loss.detach())
    return dict(params, **fc), torch.stack(losses)


__all__ = ["ff_integrate", "branch_integrate", "make_srnn_ecg",
           "make_plastic_ff", "make_dhsnn_shd", "BCIConfig", "bci_init",
           "bci_features", "bci_forward", "bci_finetune_fc"]
