"""SHD speech recognition with the dendritic DHSNN, trained through the
PyTorch port (`repro_torch`): the twin of `examples/shd_dhsnn.py`.

The DH-LIF hidden neurons have 4 dendritic branches with heterogeneous
per-branch time constants (Zheng et al. 2024). Training is
surrogate-gradient BPTT through `plan.run`, with the global gradient norm
clipped to 1, as in the JAX example. On the card the forward runs the hand
kernels `spikemm`, `linrec` and `lif`, and the backward their backward
kernels (`lif_bwd`, `linrec_bwd`, and spikemm's weight gradient through the
spike product itself).

Run: PYTHONPATH=src python examples/shd_dhsnn_torch.py [--steps 150]
     [--device cuda|cpu]
"""

import argparse

import torch

from repro_torch.core import plan
from repro_torch.core.snn_layers import make_dhsnn_shd
from repro_torch.data.spikes import gen_shd_spikes
from repro_torch.kernels.common import resolve_device


def leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    return [] if tree is None else [tree]


def shd_loss(nodes, params, x, y):
    """Cross-entropy of the time-averaged readout membrane."""
    _, outs, _ = plan.run(nodes, params, x, device=x.device)
    logits = outs.mean(0)
    return -torch.log_softmax(logits, -1)[torch.arange(len(y)), y].mean()


def clipped_sgd(params, lr):
    """p -= lr * min(1, 1 / |g|) * g over every leaf, |g| the global norm."""
    ps = [p for p in leaves(params) if p.grad is not None]
    gn = torch.sqrt(sum((p.grad ** 2).sum() for p in ps))
    sc = torch.clamp_max(1.0 / (gn + 1e-9), 1.0)
    with torch.no_grad():
        for p in ps:
            p -= lr * sc * p.grad
            p.grad = None


def train(dendritic: bool, steps: int, device: torch.device):
    xs, ys = gen_shd_spikes(48, T=60)
    x = torch.from_numpy(xs.transpose(1, 0, 2).copy()).to(device)
    y = torch.from_numpy(ys).long().to(device)
    nodes, params = make_dhsnn_shd(torch.Generator().manual_seed(1),
                                   n_hidden=64, dendritic=dendritic,
                                   device=device)
    for p in leaves(params):
        p.requires_grad_()
    print(f"  plan: {plan.compile_program(nodes).describe()}")
    for i in range(steps):
        loss = shd_loss(nodes, params, x, y)
        loss.backward()
        clipped_sgd(params, 0.2)
        if i % 25 == 0:
            print(f"  step {i:4d} loss {loss.item():.4f}")

    xt, yt = gen_shd_spikes(48, T=60, seed=11)
    with torch.no_grad():
        _, outs, recs = plan.run(
            nodes, params, torch.from_numpy(xt.transpose(1, 0, 2).copy())
            .to(device), record=("hidden",), device=device)
    acc = float((outs.mean(0).argmax(-1).cpu()
                 == torch.from_numpy(yt)).float().mean())
    rate = float(recs["hidden"].mean())
    return acc, rate


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)

    print("dendritic (DH-LIF, 4 branches):")
    acc_d, rate_d = train(True, args.steps, device)
    print("homogeneous ablation (plain LIF):")
    acc_h, _ = train(False, args.steps, device)
    print(f"\naccuracy: DH-LIF {acc_d:.3f} vs LIF {acc_h:.3f}; "
          f"hidden spike rate {rate_d:.1%} "
          f"(paper: 2.5% hidden rate on real SHD)")


if __name__ == "__main__":
    main()
