"""CLI: lint the kernel registry, the shipped models, and their mappings.

Usage:
  python -m repro_torch.analysis --all [--fail-on warning] [--json]
  python -m repro_torch.analysis --kernels
  python -m repro_torch.analysis --models [-T 128] [-B 8]
  python -m repro_torch.analysis --mapping
  python -m repro_torch.analysis --serve
  python -m repro_torch.analysis --topologies

Exit status 1 when findings at/above --fail-on exist (default: error;
"never" always exits 0). `--all --fail-on warning` is the gate: the
shipped registry and application models must check clean. The models are
built on the CPU (`device="cpu"`, weights from a seeded generator), so the
CLI runs without a card; the kernel checks plan each CTA at the current
card's SM count and shared memory, or an sm_90 card's where there is none.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Callable, Dict, List, Tuple

from repro_torch.analysis.diagnostics import Diagnostic, at_least, render


def _model_factories() -> Dict[str, Callable[..., Tuple[list, dict]]]:
    from repro_torch.core import snn_layers as L
    return {
        "srnn_ecg": lambda g: L.make_srnn_ecg(g, device="cpu"),
        "srnn_ecg_homogeneous":
            lambda g: L.make_srnn_ecg(g, heterogeneous=False, device="cpu"),
        "dhsnn_shd": lambda g: L.make_dhsnn_shd(g, device="cpu"),
        "plastic_ff": lambda g: L.make_plastic_ff(g, device="cpu"),
    }


def _seed():
    import torch
    return torch.Generator().manual_seed(0)


def _check_models(T: int, B: int) -> List[Diagnostic]:
    from repro_torch import analysis
    out: List[Diagnostic] = []
    for name, factory in _model_factories().items():
        nodes, params = factory(_seed())
        for d in analysis.check_nodes(nodes, params=params, T=T, B=B):
            out.append(Diagnostic(d.code, d.severity, f"{name}:{d.site}",
                                  d.message, d.hint))
    return out


def _check_serving() -> List[Diagnostic]:
    """TB5xx over the shipped models under a representative deployment:
    an 8-slot cohort with a cache budget sized for the full cohort (the
    configuration the README quickstart ships), so the gate proves the
    defaults do not thrash."""
    from repro_torch import analysis
    from repro_torch.serve import EngineConfig

    out: List[Diagnostic] = []
    for name, factory in _model_factories().items():
        nodes, params = factory(_seed())
        fp = analysis.session_footprint(nodes, params)
        cfg = EngineConfig(window=32, capacity=8, queue_limit=64,
                           cache_bytes=8 * fp)
        for d in analysis.check_serve(nodes, params, cfg):
            out.append(Diagnostic(d.code, d.severity, f"{name}:{d.site}",
                                  d.message, d.hint))
    return out


def _check_mappings() -> List[Diagnostic]:
    from repro_torch import analysis
    from repro_torch.configs import snn_models
    from repro_torch.core import mapping as mp

    out: List[Diagnostic] = []
    for name, factory in sorted(snn_models.MODELS.items()):
        specs, _ = factory()
        ops = snn_models.to_ops(specs)
        ir = mp.fuse_ops([dataclasses.replace(o) for o in ops])
        for label, cores in (
                ("partition", mp.partition(ir)),
                ("merged", mp.merge_cores(mp.partition(ir), ir))):
            for d in analysis.check_cores(cores, ir):
                out.append(Diagnostic(d.code, d.severity,
                                      f"{name}:{label}:{d.site}",
                                      d.message, d.hint))
    # one end-to-end placement (cheap anneal) through the full validator
    specs, _ = snn_models.MODELS["plif_net"]()
    ops = snn_models.to_ops(specs)
    mapped = mp.compile_network(ops, anneal_iters=50)
    ir = mp.fuse_ops([dataclasses.replace(o) for o in ops])
    for d in analysis.check_mapping(mapped, ir):
        out.append(Diagnostic(d.code, d.severity, f"plif_net:placed:{d.site}",
                              d.message, d.hint))
    return out


def _check_topologies() -> List[Diagnostic]:
    """TB6xx over a representative set of shipped encodings: every IE type
    (0/1/2/3), pooling, and a delayed skip — the same shapes the compressed
    execution path runs through the gather channel."""
    import numpy as np

    from repro_torch import analysis
    from repro_torch.core import topology as tp

    rng = np.random.default_rng(0)
    dense = rng.normal(size=(40, 30)).astype(np.float32)
    sparse = dense * (rng.random((40, 30)) < 0.1)
    filt = rng.normal(size=(4, 3, 3, 3)).astype(np.float32)
    cases = {
        "fc": tp.encode(dense, kind="fc", n_cores=4),
        "sparse_t0": tp.encode(sparse, kind="sparse", ie_type=0),
        "sparse_t1": tp.encode(sparse, kind="sparse", ie_type=1),
        "conv": tp.encode(filt, kind="conv", h=8, w=8),
        "pool": tp.encode(None, kind="pool", h=8, w=8, c=3, k=2),
        "skip": tp.encode(tp.encode(sparse, kind="sparse"), kind="skip",
                          delay=3),
    }
    out: List[Diagnostic] = []
    for name, enc in cases.items():
        for d in analysis.check_topology(enc):
            out.append(Diagnostic(d.code, d.severity, f"{name}:{d.site}",
                                  d.message, d.hint))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static checks over programs, plans, kernel specs, "
                    "mappings, serve deployments, and compressed "
                    "topologies (TB1xx-TB6xx).")
    ap.add_argument("--all", action="store_true",
                    help="kernels + models + mappings + serve + "
                         "topologies (the CI gate)")
    ap.add_argument("--kernels", action="store_true",
                    help="TB3xx over every registered kernel family")
    ap.add_argument("--models", action="store_true",
                    help="TB1xx/TB2xx over the shipped application models")
    ap.add_argument("--mapping", action="store_true",
                    help="TB4xx over configs/snn_models.py mappings")
    ap.add_argument("--serve", action="store_true",
                    help="TB5xx over the shipped models under the "
                         "default serve deployment")
    ap.add_argument("--topologies", action="store_true",
                    help="TB6xx over representative compressed "
                         "encodings (all four IE types + pool + skip)")
    ap.add_argument("--fail-on", choices=["error", "warning", "never"],
                    default="error",
                    help="exit 1 when findings at/above this severity "
                         "exist (default: error)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable findings on stdout")
    ap.add_argument("-T", type=int, default=128,
                    help="time steps assumed for the shared-memory "
                         "prediction (TB230)")
    ap.add_argument("-B", type=int, default=8,
                    help="batch assumed for the shared-memory prediction "
                         "(TB230)")
    args = ap.parse_args(argv)

    if not (args.all or args.kernels or args.models or args.mapping
            or args.serve or args.topologies):
        args.all = True

    from repro_torch import analysis

    diags: List[Diagnostic] = []
    if args.all or args.kernels:
        diags.extend(analysis.check_kernels())
    if args.all or args.models:
        diags.extend(_check_models(args.T, args.B))
    if args.all or args.mapping:
        diags.extend(_check_mappings())
    if args.all or args.serve:
        diags.extend(_check_serving())
    if args.all or args.topologies:
        diags.extend(_check_topologies())

    if args.json:
        print(json.dumps([d.__dict__ for d in at_least(diags, "info")],
                         indent=1))
    else:
        print(render(diags))
        counts = {s: sum(1 for d in diags if d.severity == s)
                  for s in ("error", "warning", "info")}
        print(f"-- {counts['error']} error(s), {counts['warning']} "
              f"warning(s), {counts['info']} info")

    if args.fail_on == "never":
        return 0
    return 1 if at_least(diags, args.fail_on) else 0


if __name__ == "__main__":
    sys.exit(main())
