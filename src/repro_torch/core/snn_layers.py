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

Weights are drawn on the CPU from a torch.Generator and then moved, so one
seed gives the same weights on every device. The BCI decoder and the
plastic feed-forward model come with later slices (ROADMAP.md, Open
items 1).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import events
from repro_torch.core.neuron import ALIF, DHLIF, LI, LIF, locacc
from repro_torch.kernels.common import DeviceLike, resolve_device, tree_to


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


__all__ = ["ff_integrate", "branch_integrate", "make_srnn_ecg",
           "make_dhsnn_shd"]
