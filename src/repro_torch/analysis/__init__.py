"""Static analysis for the whole stack: programs, plans, kernels, mappings.

The port of `repro/analysis/` (the compile-time verifier), over the port's
own IR, plan, kernel registry and mapping compiler; it imports neither
`jax` nor the JAX package. Compile-time verification in the TaiBai
co-design spirit — the toolchain proves properties of what will execute
before anything launches:

  check_nodes(nodes, params=, T=, B=)   TB1xx + TB2xx over a Program DAG
  check_program(prog) / check_synapse(sp)   one IR object
  check_plan(nodes, plan=, T=, B=)      fusion explainability + a CTA's
                                        predicted shared memory
  check_kernel(name) / check_kernels()  TB3xx over the registry's CTA tiles
                                        (each family's and its backward's)
  check_cores(cores, ops) / check_mapping(mapping, ops)   TB4xx
  check_serve(nodes, params, cfg)       TB5xx over a serve deployment
  check_topology(topo)                  TB6xx over a compressed encoding
  check(target, **kw)                   polymorphic dispatch over the above

All of them return `List[Diagnostic]` (stable code, severity, site,
message, fix hint); `at_least`/`raise_if`/`render` post-process. The CLI
(`python -m repro_torch.analysis --all --fail-on warning`) lints the
shipped registry + application models on the CPU; `REPRO_CHECK=warn|raise`
wires the same checks into `core.plan.compile_program`, once a compiled
plan (never once a served window).
"""

from __future__ import annotations

from typing import Any, List

from repro_torch.analysis.diagnostics import (CODES, SEVERITIES,
                                              Diagnostic, DiagnosticError,
                                              at_least, make, raise_if,
                                              render, severity_rank, worst)
from repro_torch.analysis.kernels import (check_block_table, check_flags,
                                          check_kernel, check_kernels,
                                          check_spec, coverage_problems,
                                          route_shapes)
from repro_torch.analysis.mapping import check_cores, check_mapping
from repro_torch.analysis.plans import check_plan, compile_quiet
from repro_torch.analysis.program import (DEFAULT_EXTERNAL,
                                          check_nodes_graph, check_program,
                                          check_synapse)
from repro_torch.analysis.serve import check_serve, session_footprint
from repro_torch.analysis.topology import check_topology


def check_nodes(nodes: Any, params: Any = None, T: Any = None, B: Any = None,
                plan: Any = None,
                external: Any = DEFAULT_EXTERNAL) -> List[Diagnostic]:
    """TB1xx graph/IR checks + TB2xx plan checks over a node list.

    Plan checks are skipped when the graph has error-severity findings
    (the planner assumes a structurally valid DAG).
    """
    out = check_nodes_graph(nodes, params=params, external=external)
    if not any(d.severity == "error" for d in out):
        try:
            out.extend(check_plan(nodes, plan=plan, T=T, B=B, params=params))
        except Exception as e:  # a planner crash is itself a finding
            out.append(make("TB100", "plan",
                            f"plan compilation failed: {e!r}"))
    return out


def check(target: Any, **kw: Any) -> List[Diagnostic]:
    """Polymorphic entry point: dispatch on what `target` is.

    list/tuple of LayerNode -> check_nodes; NeuronProgram ->
    check_program; SynapseProgram -> check_synapse; kernel name (str) ->
    check_kernel; mapping.Mapping -> check_mapping(target, ops=...);
    EncodedTopology -> check_topology.
    """
    from repro_torch.core import mapping as mp
    from repro_torch.core.neuron import NeuronProgram
    from repro_torch.core.plasticity import SynapseProgram
    from repro_torch.core.topology import EncodedTopology

    if isinstance(target, str):
        return check_kernel(target, **kw)
    if isinstance(target, EncodedTopology):
        return check_topology(target, **kw)
    if isinstance(target, NeuronProgram):
        return check_program(target, **kw)
    if isinstance(target, SynapseProgram):
        return check_synapse(target, **kw)
    if isinstance(target, mp.Mapping):
        return check_mapping(target, **kw)
    if isinstance(target, (list, tuple)):
        return check_nodes(list(target), **kw)
    raise TypeError(f"don't know how to check {type(target).__name__}")


__all__ = [
    "CODES", "SEVERITIES", "Diagnostic", "DiagnosticError",
    "at_least", "make", "raise_if", "render", "severity_rank", "worst",
    "check", "check_block_table", "check_cores", "check_flags",
    "check_kernel", "check_spec",
    "check_kernels", "check_mapping", "check_nodes", "check_nodes_graph",
    "check_plan", "check_program", "check_serve", "check_synapse",
    "check_topology",
    "compile_quiet", "coverage_problems", "route_shapes",
    "session_footprint",
    "DEFAULT_EXTERNAL",
]
