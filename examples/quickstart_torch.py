"""Quickstart through the PyTorch port (`repro_torch`): the twin of
`examples/quickstart.py`.

1. program a heterogeneous spiking network with the neuron DSL,
2. encode its topology with the 2-level tables (storage accounting),
3. compile + run it through the fused execution-plan engine (on the card
   by default: `alif` and `linrec` run as hand kernels),
4. map it onto the chip grid with the compiler,
5. estimate energy with the behavioural simulator (TaiBai's modelled
   power against the paper's RTX 3090 comparator, not a measurement of
   the device this runs on).

Weights are drawn from a torch.Generator, so the numbers differ from the
JAX example's, which draws with jax.random.

Run: PYTHONPATH=src python examples/quickstart_torch.py [--device cuda|cpu]
"""

import argparse

import torch

from repro_torch.core import events, plan, topology
from repro_torch.core.mapping import Op, compile_network
from repro_torch.core.neuron import ALIF, LI
from repro_torch.core.simulator import LayerStats, simulate
from repro_torch.core.snn_layers import ff_integrate
from repro_torch.kernels.common import resolve_device, tree_to


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    device = resolve_device(ap.parse_args().device)
    g = torch.Generator().manual_seed(0)

    # 1. a 2-layer network: 64 ALIF neurons (adaptive threshold) -> 10
    # readouts
    n_in, n_hidden, n_out = 32, 64, 10
    nodes = [
        events.LayerNode("hidden", ALIF(surrogate="sigmoid", alpha=4.0),
                         ff_integrate, inputs=("input", "self"),
                         out_dim=n_hidden),
        events.LayerNode("readout", LI(), ff_integrate, inputs=("hidden",),
                         out_dim=n_out),
    ]
    params = {
        "hidden": {"w_input": 0.5 * torch.randn((n_in, n_hidden),
                                                generator=g),
                   "w_self": 0.05 * torch.randn((n_hidden, n_hidden),
                                                generator=g),
                   "neuron": ALIF().param_init(g, (n_hidden,))},
        "readout": {"w_hidden": 0.3 * torch.randn((n_hidden, n_out),
                                                  generator=g)},
    }

    # 2. topology tables: the fan-in side of `hidden` as a type-2 FC entry
    enc = topology.encode_fc(params["hidden"]["w_input"].numpy(), n_cores=4)
    print(f"topology: {enc.storage_bits()/8:.0f} B encoded vs "
          f"{enc.baseline_bits()/8:.0f} B unrolled "
          f"({enc.baseline_bits()/enc.storage_bits():.0f}x smaller)")

    # 3. compile the Program to a fused execution plan and run it: the ALIF
    # hidden layer pattern-matches the adaptive-threshold scan (`alifrec`),
    # the LI readout the `linrec` scan
    compiled = plan.compile_program(nodes)
    print(f"plan: {compiled.describe()}")
    x = (torch.rand((100, 8, n_in), generator=g) < 0.05).float().to(device)
    _, outs, recs = plan.run(nodes, tree_to(params, device), x,
                             record=("hidden",), plan=compiled,
                             device=device)
    rate = float(recs["hidden"].mean())
    print(f"ran 100 INTEG/FIRE timesteps on {device.type}: hidden spike rate "
          f"{rate:.1%}, readout shape {tuple(outs.shape)}")

    # 4. compile onto the chip grid
    ops = [Op("hidden", "fc", n_hidden, n_in + n_hidden, ("input",)),
           Op("readout", "fc", n_out, n_hidden, ("hidden",))]
    mapping = compile_network(ops, anneal_iters=200)
    print(f"mapped to {mapping.meta['n_cores']} cores, "
          f"placement cost {mapping.cost:.0f} packet-hops")

    # 5. energy estimate vs a dense GPU (the simulator's RTX 3090 model)
    stats = [LayerStats("hidden", n_hidden, n_hidden + n_out, rate,
                        2.0 * n_hidden * (n_in + n_hidden))]
    rep = simulate(stats, timesteps=100)
    print(f"simulated TaiBai: {rep.power_w:.2f} W, {rep.efficiency_x:.0f}x "
          f"better FPS/W than the modelled dense-GPU baseline")


if __name__ == "__main__":
    main()
