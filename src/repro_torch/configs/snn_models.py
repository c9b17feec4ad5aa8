"""The paper's SNN benchmark networks (Table II) + Fig. 14 topology models.

Three evaluation SNNs, exactly as Table II specifies:

  PLIF-Net    Input-256c3p1x3-mp2-256c3p1x3-mp2-fc4096-fc10   in 32x32x3
  5Blocks-Net Input-mp2-16c3-[16c3p1x2]-mp2-...x5-fc11        in 128x128x2
  ResNet19    Input-64c3-[128c3p1x2]x3-[256c3p1x2]x3-
              [512c3p1x2]x2-fc256-fc10                        in 32x32x3

The port's own copy of `repro/configs/snn_models.py`, built on the port's
`core/mapping.py` and `core/topology.py`.

Each builder returns (ops, meta): `ops` feed the mapping compiler
(core/mapping.py) and the behavioural simulator; `topology_layers()`
materializes the 2-level fan-in/fan-out tables for the Fig. 14 storage
accounting (conv layers use type-3 decoupled addressing, pools type-0,
FCs type-2, residual skips the delayed-fire scheme).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.core import topology as topo
from repro_torch.core.mapping import Op


@dataclasses.dataclass
class ConvSpec:
    kind: str                  # conv | pool | fc | skip
    c_in: int = 0
    c_out: int = 0
    k: int = 3
    stride: int = 1
    pad: int = 1
    h: int = 0                 # input spatial (set during build)
    w: int = 0
    n_in: int = 0              # fc
    n_out: int = 0
    skip_from: int = -1        # index of the layer this skip bypasses to


def _net(input_hw: Tuple[int, int, int], layers: List[ConvSpec]):
    """Fill in spatial dims; returns specs with shapes resolved."""
    h, w, c = input_hw
    out = []
    for L in layers:
        L = dataclasses.replace(L)
        if L.kind == "conv":
            L.h, L.w, L.c_in = h, w, c
            h = (h + 2 * L.pad - L.k) // L.stride + 1
            w = (w + 2 * L.pad - L.k) // L.stride + 1
            c = L.c_out
        elif L.kind == "pool":
            L.h, L.w, L.c_in = h, w, c
            h, w = h // L.k, w // L.k
        elif L.kind == "fc":
            if L.n_in == 0:
                L.n_in = h * w * c
            h, w, c = 1, 1, L.n_out
        out.append(L)
    return out


def plif_net() -> Tuple[List[ConvSpec], str]:
    layers = ([ConvSpec("conv", c_out=256)] * 3 + [ConvSpec("pool", k=2)]
              + [ConvSpec("conv", c_out=256)] * 3 + [ConvSpec("pool", k=2)]
              + [ConvSpec("fc", n_out=4096), ConvSpec("fc", n_out=10)])
    return _net((32, 32, 3), layers), "PLIF-Net"


def blocks5_net() -> Tuple[List[ConvSpec], str]:
    layers: List[ConvSpec] = [ConvSpec("pool", k=2), ConvSpec("conv", c_out=16, pad=0)]
    for _ in range(5):
        layers += [ConvSpec("conv", c_out=16)] * 2 + [ConvSpec("pool", k=2)]
    layers += [ConvSpec("fc", n_out=11)]
    return _net((128, 128, 2), layers), "5Blocks-Net"


def resnet19() -> Tuple[List[ConvSpec], str]:
    layers: List[ConvSpec] = [ConvSpec("conv", c_out=64)]
    blocks = [(128, 3), (256, 3), (512, 2)]
    li = 0
    for c_out, reps in blocks:
        for r in range(reps):
            start = len(layers)
            stride = 2 if r == 0 else 1
            layers.append(ConvSpec("conv", c_out=c_out, stride=stride))
            layers.append(ConvSpec("conv", c_out=c_out))
            layers.append(ConvSpec("skip", skip_from=start - 1))
    layers += [ConvSpec("fc", n_out=256), ConvSpec("fc", n_out=10)]
    return _net((32, 32, 3), layers), "ResNet19"


def vgg16_cifar() -> Tuple[List[ConvSpec], str]:
    cfg = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
           512, 512, 512, "M", 512, 512, 512, "M"]
    layers: List[ConvSpec] = []
    for v in cfg:
        if v == "M":
            layers.append(ConvSpec("pool", k=2))
        else:
            layers.append(ConvSpec("conv", c_out=v))
    layers += [ConvSpec("fc", n_out=512), ConvSpec("fc", n_out=10)]
    return _net((32, 32, 3), layers), "VGG16"


def resnet18_cifar() -> Tuple[List[ConvSpec], str]:
    layers: List[ConvSpec] = [ConvSpec("conv", c_out=64)]
    for c_out, reps in [(64, 2), (128, 2), (256, 2), (512, 2)]:
        for r in range(reps):
            start = len(layers)
            stride = 2 if (r == 0 and c_out > 64) else 1
            layers.append(ConvSpec("conv", c_out=c_out, stride=stride))
            layers.append(ConvSpec("conv", c_out=c_out))
            layers.append(ConvSpec("skip", skip_from=start - 1))
    layers += [ConvSpec("fc", n_out=10)]
    return _net((32, 32, 3), layers), "ResNet18"


MODELS = {"plif_net": plif_net, "5blocks_net": blocks5_net,
          "resnet19": resnet19, "vgg16": vgg16_cifar,
          "resnet18": resnet18_cifar}


# ---------------------------------------------------------------------------
# bridges to the mapping compiler and the topology tables
# ---------------------------------------------------------------------------


def to_ops(specs: List[ConvSpec]) -> List[Op]:
    ops: List[Op] = []
    prev = "input"
    for i, L in enumerate(specs):
        name = f"L{i}_{L.kind}"
        if L.kind == "conv":
            ho = (L.h + 2 * L.pad - L.k) // L.stride + 1
            wo = (L.w + 2 * L.pad - L.k) // L.stride + 1
            ops.append(Op(name, "conv", L.c_out * ho * wo,
                          L.c_in * L.k * L.k, (prev,)))
        elif L.kind == "pool":
            ops.append(Op(name, "pool", L.c_in * (L.h // L.k) * (L.w // L.k),
                          L.k * L.k, (prev,)))
        elif L.kind == "fc":
            ops.append(Op(name, "fc", L.n_out, L.n_in, (prev,)))
        elif L.kind == "skip":
            ops.append(Op(name, "add", 0, 0, (prev, f"L{L.skip_from}_conv")))
        prev = ops[-1].name if ops else prev
    return ops


def topology_layers(specs: List[ConvSpec], seed: int = 0,
                    max_fc_core: int = 8) -> List[topo.EncodedTopology]:
    """Materialize the encoded tables for every connection (Fig. 14)."""
    rng = np.random.default_rng(seed)
    out: List[topo.EncodedTopology] = []
    for i, L in enumerate(specs):
        if L.kind == "conv":
            filt = rng.standard_normal((L.c_out, L.c_in, L.k, L.k)
                                       ).astype(np.float32)
            out.append(topo.encode_conv(filt, L.h, L.w, L.stride, L.pad))
        elif L.kind == "pool":
            out.append(topo.encode_pool(L.h, L.w, L.c_in, L.k))
        elif L.kind == "fc":
            w = rng.standard_normal((L.n_in, L.n_out)).astype(np.float32)
            out.append(topo.encode_fc(w, n_cores=max_fc_core))
        elif L.kind == "skip" and out:
            # delayed-fire reuse of the bypassed layer's fan-out table
            src = out[L.skip_from] if 0 <= L.skip_from < len(out) else out[-1]
            out.append(topo.encode_skip(src, delay=2))
    return out


__all__ = ["ConvSpec", "plif_net", "blocks5_net", "resnet19", "vgg16_cifar",
           "resnet18_cifar", "MODELS", "to_ops", "topology_layers"]
