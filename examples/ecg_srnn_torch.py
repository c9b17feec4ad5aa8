"""ECG band recognition with the heterogeneous SRNN, trained through the
PyTorch port (`repro_torch`): the twin of `examples/ecg_srnn.py`.

Trains the self-recurrent ALIF SRNN on level-crossing-coded synthetic
QTDB-style waveforms, per-timestep band classification (P/PQ/QR/RS/ST/TP),
and its homogeneous (recurrent LIF) ablation, by surrogate-gradient BPTT
through `plan.run` (the sigmoid surrogate at alpha 4, the model's own),
with the global gradient norm clipped to 1, as in the JAX example. On the
card the forward runs the hand kernels `spikemm`, `alifrec` (`lifrec`)
and `linrec`, and the backward their backward kernels (`alifrec_bwd`,
`lifrec_bwd`, `linrec_bwd`, and the weight gradients, the recurrent one
included, through the spike product itself).

Run: PYTHONPATH=src python examples/ecg_srnn_torch.py [--steps 150]
     [--device cuda|cpu]
"""

import argparse

import torch

from repro_torch.core import plan
from repro_torch.core.snn_layers import make_srnn_ecg
from repro_torch.data.spikes import gen_ecg_qtdb
from repro_torch.kernels.common import resolve_device


def leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    return [] if tree is None else [tree]


def as_batch(xs, ys, device):
    """(T, B, 4) spikes and (T, B) labels on `device`."""
    return (torch.from_numpy(xs.transpose(1, 0, 2).copy()).to(device),
            torch.from_numpy(ys.T.copy()).long().to(device))


def ecg_loss(nodes, params, x, y):
    """Per-timestep cross-entropy of the readout membrane."""
    _, outs, _ = plan.run(nodes, params, x, device=x.device)
    return -torch.log_softmax(outs, -1).gather(-1, y[..., None]).mean()


def clipped_sgd(params, lr):
    """p -= lr * min(1, 1 / |g|) * g over every leaf, |g| the global norm."""
    ps = [p for p in leaves(params) if p.grad is not None]
    gn = torch.sqrt(sum((p.grad ** 2).sum() for p in ps))
    sc = torch.clamp_max(1.0 / (gn + 1e-9), 1.0)
    with torch.no_grad():
        for p in ps:
            p -= lr * sc * p.grad
            p.grad = None


def train(heterogeneous: bool, steps: int, device: torch.device,
          T: int = 200):
    x, y = as_batch(*gen_ecg_qtdb(16, T=T), device)
    nodes, params = make_srnn_ecg(torch.Generator().manual_seed(0),
                                  heterogeneous=heterogeneous, n_hidden=48,
                                  device=device)
    for p in leaves(params):
        p.requires_grad_()
    print(f"  plan: {plan.compile_program(nodes).describe()}")
    for i in range(steps):
        loss = ecg_loss(nodes, params, x, y)
        loss.backward()
        clipped_sgd(params, 0.1)
        if i % 25 == 0:
            print(f"  step {i:4d} loss {loss.item():.4f}")

    xt, yt = as_batch(*gen_ecg_qtdb(8, seed=7, T=T), device)
    with torch.no_grad():
        _, outs, _ = plan.run(nodes, params, xt, device=device)
    return float((outs.argmax(-1) == yt).float().mean())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)

    print("heterogeneous (ALIF hidden):")
    het = train(True, args.steps, device)
    print("homogeneous ablation (LIF hidden):")
    hom = train(False, args.steps, device)
    print(f"\nper-timestep band accuracy: ALIF {het:.3f} vs LIF {hom:.3f} "
          f"(paper Fig. 15a compares the same pair on real QTDB)")


if __name__ == "__main__":
    main()
