"""Structured diagnostics for the static-analysis subsystem.

The port of `repro/analysis/diagnostics.py`: every code keeps its default
severity; only the titles of TB230 and TB304-TB306 change, since the
budget they speak of is a CTA's shared memory on the card, not a TPU's
VMEM. Every checker in `repro_torch.analysis` reports findings as `Diagnostic`
records: a stable TB-code, a severity, the source site (node, kernel,
core, ...), a human message, and a fix hint. Codes are grouped by layer —
the same layering the compiler stack has:

  TB1xx  program checks   (events.Program DAG + Neuron/SynapseProgram IR)
  TB2xx  plan checks      (fusion explainability, shared-memory
                           prediction, chunked-online learning hazards)
  TB3xx  kernel-spec checks (CTA grid coverage, tile contracts,
                           shared-memory model sanity, sparse-channel
                           block tables)
  TB4xx  mapping checks   (core capacity, unmapped ops, placement, links)
  TB5xx  serve checks     (state-cache budget vs session footprint,
                           cohort shape vs plan, admission bounds)
  TB6xx  topology checks  (compressed-connectivity table integrity)

The default severity of each code lives in `CODES`; `make()` applies it
so checkers and tests agree on one source of truth. `raise_if` turns a
finding list into a `DiagnosticError` — the `REPRO_CHECK=raise` hook in
`core/plan.py` and the CLI's `--fail-on` both go through it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

SEVERITIES: Tuple[str, ...] = ("info", "warning", "error")

# code -> (default severity, title)
CODES: Dict[str, Tuple[str, str]] = {
    # -- TB1xx: program checks ------------------------------------------------
    "TB100": ("error", "invalid program structure"),
    "TB101": ("error", "connection reads unknown source"),
    "TB102": ("error", "learned-parameter key collision"),
    "TB103": ("warning", "zero-delay cross-node cycle"),
    "TB104": ("warning", "unreachable or dead node"),
    "TB105": ("warning", "unread state variable"),
    "TB106": ("warning", "unread synaptic trace"),
    "TB107": ("error", "plastic edge missing its weight tensor"),
    "TB108": ("warning", "decay outside (0, 1]"),
    "TB109": ("warning", "degenerate threshold"),
    "TB110": ("error", "weight shape mismatch"),
    "TB111": ("error", "non-positive layer width"),
    # -- TB2xx: plan checks ---------------------------------------------------
    "TB201": ("info", "whole-program fallback"),
    "TB202": ("info", "integrate not hoistable"),
    "TB203": ("info", "delayed self-connection"),
    "TB204": ("info", "multiple self feeds"),
    "TB205": ("info", "neuron declares no program"),
    "TB206": ("info", "no fused FIRE pattern match"),
    "TB207": ("info", "hoist convention mismatch"),
    "TB208": ("info", "recurrent variant unsupported"),
    "TB210": ("info", "synapse program runs per-step"),
    "TB230": ("warning", "predicted segment shared memory over budget"),
    "TB231": ("error", "plastic connections collide on a weight key"),
    "TB232": ("warning", "plastic weight key aliased by another edge"),
    # -- TB3xx: kernel-spec checks --------------------------------------------
    "TB301": ("error", "index map leaves output gaps"),
    "TB302": ("error", "index map overlaps output blocks"),
    "TB303": ("warning", "block axis violates its contract"),
    "TB304": ("error", "shared-memory model underestimates CTA tiles"),
    "TB305": ("warning", "shared-memory model far above CTA tiles"),
    "TB306": ("warning", "default tile exceeds the shared-memory budget"),
    "TB307": ("error", "sparse block-table defect"),
    "TB308": ("warning", "unknown block-axis key"),
    "TB309": ("info", "kernel declares no tile model"),
    # -- TB4xx: mapping checks ------------------------------------------------
    "TB401": ("error", "core over neuron capacity"),
    "TB402": ("error", "op missing from the core map"),
    "TB403": ("error", "core placed off-grid"),
    "TB404": ("error", "fan-in unsatisfiable"),
    "TB405": ("warning", "fanout exceeds link budget"),
    # -- TB5xx: serve checks ----------------------------------------------------
    "TB501": ("error", "state-cache budget below one session footprint"),
    "TB502": ("warning", "state-cache budget thrashes at capacity"),
    "TB503": ("warning", "serving a plan with fallback segments"),
    "TB504": ("warning", "admission queue smaller than cohort capacity"),
    "TB505": ("error", "window/capacity configuration invalid"),
    # -- TB6xx: topology checks -------------------------------------------------
    "TB601": ("error", "IE entry targets a neuron outside out_dim"),
    "TB602": ("warning", "duplicate (pre, post) IE entries accumulate"),
    "TB603": ("warning", "IE coverage misses output neurons"),
    "TB604": ("error", "storage-bits accounting disagrees with tables"),
    "TB605": ("error", "delay exceeds the delay-field capacity"),
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: code + severity + where + what + how to fix."""

    code: str
    severity: str
    site: str
    message: str
    hint: str = ""

    def __str__(self) -> str:
        s = f"{self.code} {self.severity}: {self.site}: {self.message}"
        if self.hint:
            s += f"  (hint: {self.hint})"
        return s


class DiagnosticError(ValueError):
    """Raised when findings at/above the requested severity exist."""

    def __init__(self, diagnostics: Sequence[Diagnostic]):
        self.diagnostics: Tuple[Diagnostic, ...] = tuple(diagnostics)
        lines = "\n".join(f"  {d}" for d in self.diagnostics)
        super().__init__(
            f"{len(self.diagnostics)} static-analysis finding(s):\n{lines}")


def make(code: str, site: str, message: str, hint: str = "",
         severity: Optional[str] = None) -> Diagnostic:
    """Build a Diagnostic with the code's default severity applied."""
    if code not in CODES:
        raise KeyError(f"unknown diagnostic code {code!r}")
    sev = severity if severity is not None else CODES[code][0]
    if sev not in SEVERITIES:
        raise ValueError(f"bad severity {sev!r}; expected one of {SEVERITIES}")
    return Diagnostic(code=code, severity=sev, site=site, message=message,
                      hint=hint)


def severity_rank(severity: str) -> int:
    return SEVERITIES.index(severity)


def at_least(diags: Iterable[Diagnostic],
             severity: str = "warning") -> List[Diagnostic]:
    """Findings at or above `severity`, most severe first."""
    floor = severity_rank(severity)
    out = [d for d in diags if severity_rank(d.severity) >= floor]
    out.sort(key=lambda d: (-severity_rank(d.severity), d.code, d.site))
    return out


def worst(diags: Iterable[Diagnostic]) -> Optional[str]:
    """The highest severity present, or None when there are no findings."""
    ranks = [severity_rank(d.severity) for d in diags]
    return SEVERITIES[max(ranks)] if ranks else None


def render(diags: Sequence[Diagnostic]) -> str:
    """Human-readable report, most severe first."""
    if not diags:
        return "no findings"
    ordered = at_least(diags, "info")
    return "\n".join(str(d) for d in ordered)


def raise_if(diags: Sequence[Diagnostic], severity: str = "error") -> None:
    """Raise `DiagnosticError` when findings at/above `severity` exist."""
    bad = at_least(diags, severity)
    if bad:
        raise DiagnosticError(bad)


__all__ = ["CODES", "SEVERITIES", "Diagnostic", "DiagnosticError", "make",
           "severity_rank", "at_least", "worst", "render", "raise_if"]
