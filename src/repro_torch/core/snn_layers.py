"""SNN layer library + the paper's SHD speech model (§V-B3).

The port of `repro/core/snn_layers.py`, serving slice:

  ff_integrate, branch_integrate — the INTEG conventions the plan compiler
                 hoists (their `.hoist` tags)
  dhsnn_shd    — 700 -> 64 DH-LIF (4 dendritic branches) -> 20 LI readout
                 (Zheng et al. 2024), the SHD speech task;
                 `dendritic=False` is the homogeneous LIF ablation.

The ECG SRNN, the BCI decoder and the plastic feed-forward model come with
later slices (ROADMAP.md, Open items 1).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import events
from repro_torch.core.neuron import DHLIF, LI, LIF, locacc
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


__all__ = ["ff_integrate", "branch_integrate", "make_dhsnn_shd"]
