"""BCI cross-day decoding with on-chip learning (paper §V-B3, Fig. 15),
through the PyTorch port (`repro_torch`): the twin of
`examples/bci_onchip.py`, with its config, steps, learning rates, days
and seeds.

A multi-sub-path network (linear transform (x) channel attention +
temporal conv per path), Hadamard fusion, concat -> LIF -> fused BN1d+FC
readout; train on day 0 with clipped SGD, then recover cross-day accuracy
by fine-tuning ONLY the FC with 32 samples using the accumulated-spike
backprop (the paper's on-chip learning trick). On the card the LIF layer
runs the hand kernels `lif` forward and `lif_bwd` backward; the fine-tune
runs no LIF backward. It ends with TaiBai's power and efficiency as the
behavioural simulator models them (`core/simulator.py`, the paper's RTX
3090 comparator) from the run's spike record, with
`benchmarks/bench_applications.py::bci_task`'s layer statistics: modelled
figures of the chip the paper describes, not of the card this runs on.

Run: PYTHONPATH=src python examples/bci_onchip_torch.py [--steps 100]
     [--device cuda|cpu]
"""

import argparse
import dataclasses

import torch

from repro_torch.core.simulator import simulate, spike_stats_from_records
from repro_torch.core.snn_layers import (BCIConfig, bci_finetune_fc,
                                         bci_forward, bci_init)
from repro_torch.data.spikes import gen_bci_trials
from repro_torch.kernels.common import resolve_device


def trials(n, day, seed, cfg, device):
    x, y = gen_bci_trials(n, day=day, seed=seed, n_channels=cfg.n_channels,
                          n_bins=cfg.n_steps)
    return torch.from_numpy(x).to(device), torch.from_numpy(y).long().to(
        device)


def loss_fn(params, x, y, cfg):
    logits, _ = bci_forward(params, x, cfg)
    return -torch.log_softmax(logits, -1)[
        torch.arange(len(y), device=y.device), y].mean()


def clipped_sgd(params, lr):
    """p -= lr * min(1, 1 / |g|) * g over every leaf, |g| the global norm."""
    ps = list(params.values())
    gn = torch.sqrt(sum((p.grad ** 2).sum() for p in ps))
    sc = torch.clamp_max(1.0 / (gn + 1e-9), 1.0)
    with torch.no_grad():
        for p in ps:
            p -= lr * sc * p.grad
            p.grad = None


def accuracy(params, x, y, cfg):
    with torch.no_grad():
        logits, spikes = bci_forward(params, x, cfg)
    return float((logits.argmax(-1) == y).float().mean()), spikes


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)

    cfg = BCIConfig(n_channels=64, n_steps=30, n_paths=8, d_path=16)
    params = bci_init(torch.Generator().manual_seed(2), cfg, device=device)
    for p in params.values():
        p.requires_grad_()

    # day-0 training
    x0, y0 = trials(128, 0, 0, cfg, device)
    print("training on day 0 ...")
    for i in range(args.steps):
        loss = loss_fn(params, x0, y0, cfg)
        loss.backward()
        clipped_sgd(params, 0.05)
        if i % 25 == 0:
            print(f"  step {i:3d} loss {loss.item():.4f}")

    print(f"day-0 accuracy: {accuracy(params, x0, y0, cfg)[0]:.3f}\n")
    print(f"{'day':>4s} {'before':>8s} {'after 32-sample on-chip FT':>28s}")
    records = []
    for day in (1, 2, 3):
        xt, yt = trials(64, day, day, cfg, device)
        before, _ = accuracy(params, xt, yt, cfg)
        xf, yf = trials(32, day, 100 + day, cfg, device)
        tuned, _ = bci_finetune_fc(params, xf, yf, cfg, lr=0.05, steps=25)
        after, spikes = accuracy(tuned, xt, yt, cfg)
        records.append(spikes)
        print(f"{day:4d} {before:8.3f} {after:28.3f}")
    print("\n(the FC-only fine-tune stores only accumulated spikes — the "
          "paper's\n on-chip memory optimization, exact for this readout; "
          "see core/plasticity.py)")

    # the fine-tuned decoder's spike record on the three days' test trials,
    # in bench_applications.bci_task's layer statistics (fan-out: the
    # channels; dense FLOPs a step: 2 x features x channels x bins)
    n_feat = cfg.n_paths * cfg.d_path
    stats = spike_stats_from_records(
        {"paths": torch.cat(records, dim=1)}, {"paths": cfg.n_channels},
        {"paths": 2.0 * n_feat * cfg.n_channels * cfg.n_steps})
    stats = [dataclasses.replace(s, spike_rate=max(s.spike_rate, 1e-3))
             for s in stats]
    rep = simulate(stats, timesteps=100)
    print(f"\nhidden spike rate {stats[0].spike_rate:.1%}; simulated TaiBai "
          f"(behavioural model, not this {device.type} device): "
          f"{rep.power_w:.3f} W, {rep.power_ratio_x:.0f}x less power and "
          f"{rep.efficiency_x:.1f}x the FPS/W of the modelled RTX 3090")


if __name__ == "__main__":
    main()
