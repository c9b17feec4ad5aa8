"""TB2xx: fusion explainability + predicted shared-memory checks over a Plan.

The port of `repro/analysis/plans.py`. `core/plan.py` already decides
*and records* why every stepper segment fell back (`Segment.codes` /
`PlasticLower.code`); this module lifts those decisions into `Diagnostic`
records (severity info — a fallback is legal, just slow) and adds the one
check only the analyzer can do statically: predict each fused segment's
kernels — its FIRE scans and its hoisted INTEG spike products — at the
CTA tiles their wrappers will launch (`KernelSpec.resolve_blocks`, the
wrappers' own plan functions) and compare each CTA's shared memory
(`KernelSpec.smem_bytes`) against what a block may opt into on the card
(TB230), before anything launches.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence

from repro_torch.core import plan as plan_mod
from repro_torch.core.events import LayerNode
from repro_torch.kernels import registry
from repro_torch.kernels.common import plan_sms, smem_budget

from repro_torch.analysis.diagnostics import Diagnostic, make


def compile_quiet(nodes: Sequence[LayerNode]) -> "plan_mod.Plan":
    """compile_program with the REPRO_CHECK hook latched off (the analyzer
    calls the planner; the planner must not call the analyzer back)."""
    prev = plan_mod._IN_CHECK
    plan_mod._IN_CHECK = True
    try:
        return plan_mod.compile_program(list(nodes))
    finally:
        plan_mod._IN_CHECK = prev


def _fallback_diags(plan: "plan_mod.Plan") -> List[Diagnostic]:
    out: List[Diagnostic] = []
    for seg in plan.segments:
        if seg.kind != plan_mod.FALLBACK:
            continue
        entries = [e.strip() for e in seg.reason.split(";")] if seg.reason \
            else []
        if len(seg.codes) == len(seg.names) == len(entries):
            for name, code, entry in zip(seg.names, seg.codes, entries):
                msg = entry.split(":", 1)[1].strip() if ":" in entry else entry
                if msg.startswith(code):
                    msg = msg[len(code):].strip()
                out.append(make(
                    code, name, msg,
                    hint="runs through the per-step stepper segment"))
        else:
            # whole-program fallback: one code covers every node
            code = seg.codes[0] if seg.codes else "TB201"
            out.append(make(
                code, seg.names[0] if seg.names else "program",
                seg.reason or "program compiles to a single stepper segment",
                hint="runs through the per-step stepper segment"))
    for p in plan.plastic:
        if p.code:
            out.append(make(
                p.code, f"{p.node}.{p.conn}", p.reason,
                hint="the rule runs through plasticity.synapse_step"))
    return out


# fused lowering family -> kernel spec name(s), keyed by recurrence
_FAMILY_KERNELS = {
    (plan_mod.LOWER_LI, False): ("linrec",),
    (plan_mod.LOWER_LIF, False): ("lif",),
    (plan_mod.LOWER_LIF, True): ("lifrec",),
    (plan_mod.LOWER_ALIF, False): ("alif",),
    (plan_mod.LOWER_ALIF, True): ("alifrec",),
    (plan_mod.LOWER_DHLIF, False): ("linrec", "lif"),
}


def _fire_dims(kernel: str, family: str, T: int, B: int, n: int,
               n_branches: int) -> Dict[str, int]:
    """The dims of a segment's FIRE kernel call. The dhlif prologue scans
    the branches' (T, B, K N) current, its decay (K N,) read in place."""
    if kernel in ("lifrec", "alifrec"):
        return {"T": T, "B": B, "N": n}
    lanes = n * (n_branches if family == plan_mod.LOWER_DHLIF
                 and kernel == "linrec" else 1)
    return {"T": T, "B": B, "N": lanes, "L": B * lanes, "P": 1}


def _predict_smem(kernel: str, dims: Mapping[str, int]
                  ) -> Optional[Dict[str, Any]]:
    try:
        spec = registry.get(kernel)
    except KeyError:
        return None
    if spec.plan is None or spec.tile_model is None:
        return None
    blocks = spec.resolve_blocks(dims, n_sm=plan_sms())
    return {"kernel": kernel, "blocks": blocks,
            "bytes": int(spec.smem_bytes(dims, blocks))}


def _smem_diags(nodes: Sequence[LayerNode], plan: "plan_mod.Plan",
                T: int, B: int,
                params: Optional[Dict[str, Any]] = None) -> List[Diagnostic]:
    limit = smem_budget()
    by_name = {n.name: n for n in nodes}
    widths = {n.name: n.out_dim for n in nodes}
    out: List[Diagnostic] = []

    def check(site: str, pred: Optional[Dict[str, Any]]) -> None:
        if pred is not None and pred["bytes"] > limit:
            out.append(make(
                "TB230", site,
                f"{pred['kernel']} predicts {pred['bytes']} B of shared "
                f"memory a CTA at tile {pred['blocks']} > budget {limit} B",
                hint="narrow the layer or split the batch; the launch "
                     "would fail"))

    for seg in plan.segments:
        if seg.kind == plan_mod.FALLBACK:
            continue
        node = by_name[seg.names[0]]
        prog = node.neuron.program
        kb = prog.n_branches
        for kernel in _FAMILY_KERNELS.get(
                (seg.lower, seg.kind == plan_mod.FUSED_REC), ()):
            check(node.name, _predict_smem(
                kernel, _fire_dims(kernel, seg.lower, T, B, node.out_dim,
                                   kb)))
        # the hoisted INTEG spikemm per feed, when the source width is known
        for c in node.connections:
            if c.src == "self":
                continue
            src_dim = widths.get(c.src)
            if src_dim is None and params is not None:
                w = params.get(node.name, {}).get(c.weight_key)
                shape = getattr(w, "shape", None)
                if shape is not None and len(shape) >= 2:
                    src_dim = int(shape[-2])
            if src_dim is None:
                continue
            n_out = node.out_dim * (kb if seg.lower == plan_mod.LOWER_DHLIF
                                    else 1)
            check(f"{node.name}.{c.key}", _predict_smem(
                "spikemm", {"M": T * B, "K": src_dim, "N": n_out}))
    return out


def check_plan(nodes: Sequence[LayerNode],
               plan: Optional["plan_mod.Plan"] = None,
               T: Optional[int] = None, B: Optional[int] = None,
               params: Optional[Dict[str, Any]] = None) -> List[Diagnostic]:
    """TB201-210 fusion explainability (+ TB230 when T and B are given)."""
    if plan is None:
        plan = compile_quiet(nodes)
    out = _fallback_diags(plan)
    if T is not None and B is not None and nodes:
        out.extend(_smem_diags(nodes, plan, int(T), int(B), params))
    return out


__all__ = ["check_plan", "compile_quiet"]
