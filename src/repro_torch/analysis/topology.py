"""TB6xx: compile-time checks over compressed-topology encodings.

The port of `repro/analysis/topology.py`, over the port's
`core/topology.py` (its tables are numpy, as the reference's are).

An `EncodedTopology` is static configuration that the gather channel
executes directly — if its IE tables are malformed, the failure surfaces
as silent numerical corruption inside a gather kernel, not a Python
exception. These checks prove table integrity before anything is lowered:

  TB601  ghost entries: IE targets outside [0, n_post) or sources outside
         [0, n_pre) — the gather lowering would scatter out of bounds
  TB602  duplicate (pre, post) entries: the COO accumulation sums them,
         which is almost never what an encoder intended
  TB603  coverage: structured kinds (fc / conv / pool) should reach every
         output neuron; a hole means a mis-sized encode
  TB604  storage honesty: `meta["n_connections"]` (the denominator of the
         Fig. 14 compression claims) must equal what the tables hold
  TB605  delay capacity: a skip connection's delay must fit the
         `BITS["delay"]` field the fan-out IE actually stores
"""

from __future__ import annotations

from typing import Any, List, Optional

import numpy as np

from repro_torch.analysis.diagnostics import Diagnostic, make

# kinds whose encoders promise full output coverage (TB603); sparse/skip
# connectivity is allowed to leave outputs unreached
_COVERED_KINDS = ("fc", "conv", "pool")

_DECODE_ERROR = object()


def _coo_of(topo: Any) -> Optional[tuple]:
    try:
        return topo.coo()
    except NotImplementedError:
        return None
    except Exception as e:  # a crashing decode is itself a ghost-table sign
        return (_DECODE_ERROR, e)


def check_topology(topo: Any) -> List[Diagnostic]:
    """TB6xx over one `EncodedTopology` (any kind, including skip)."""
    from repro_torch.core.topology import BITS

    out: List[Diagnostic] = []
    site = f"topology:{topo.kind}"
    n_pre, n_post = int(topo.n_pre), int(topo.n_post)

    # -- TB605: delay field capacity -----------------------------------------
    delay = topo.meta.get("delay")
    delayed = any(getattr(e, "delayed", False) for e in topo.fan_out)
    if delayed or topo.kind == "skip":
        cap = (1 << BITS["delay"]) - 1
        if delay is None:
            out.append(make(
                "TB605", site,
                "delayed fan-out entries but meta records no 'delay'",
                hint="encode skips via encode(source, kind='skip', "
                     "delay=d)"))
        elif not 0 <= int(delay) <= cap:
            out.append(make(
                "TB605", site,
                f"delay {delay} does not fit the {BITS['delay']}-bit "
                f"delay field (max {cap})",
                hint="split the skip across relay stages or widen "
                     "BITS['delay']"))

    # -- fc: type-2 incremental addressing is checked symbolically -----------
    if topo.kind == "fc" or (topo.kind == "skip"
                             and _coo_of(topo) is None):
        covered = np.zeros(n_post, bool)
        for de in topo.fan_in:
            for ie in de.ies:
                if ie.ie_type != 2:
                    continue
                last = ie.start + ie.margin * (ie.count - 1)
                if ie.start < 0 or last >= n_post:
                    out.append(make(
                        "TB601", site,
                        f"type-2 IE spans [{ie.start}, {last}] but "
                        f"out_dim is {n_post}"))
                    continue
                idx = ie.start + ie.margin * np.arange(ie.count)
                if covered[idx].any():
                    out.append(make(
                        "TB602", site,
                        "type-2 IE ranges overlap: the same output "
                        "neuron accumulates twice per spike"))
                covered[idx] = True
        if not covered.all():
            out.append(make(
                "TB603", site,
                f"type-2 IEs cover {int(covered.sum())}/{n_post} "
                f"output neurons",
                hint="check n_cores partitioning in encode(..., "
                     "kind='fc')"))
        n_conn = topo.meta.get("n_connections")
        if n_conn is None or int(n_conn) != n_pre * n_post:
            out.append(make(
                "TB604", site,
                f"meta n_connections={n_conn} but an fc layer of shape "
                f"({n_pre}, {n_post}) holds {n_pre * n_post}"))
        return out

    # -- everything else: check the executable COO view ----------------------
    coo = _coo_of(topo)
    if coo is None:
        return out
    if coo[0] is _DECODE_ERROR:
        out.append(make("TB601", site,
                        f"IE decode crashed: {coo[1]!r}",
                        hint="the tables do not round-trip; re-encode"))
        return out
    pre, post, w = (np.asarray(coo[0]), np.asarray(coo[1]),
                    np.asarray(coo[2]))
    if pre.size:
        if pre.min() < 0 or pre.max() >= n_pre:
            out.append(make(
                "TB601", site,
                f"IE source ids span [{pre.min()}, {pre.max()}] outside "
                f"[0, {n_pre})"))
        if post.min() < 0 or post.max() >= n_post:
            out.append(make(
                "TB601", site,
                f"IE target ids span [{post.min()}, {post.max()}] "
                f"outside [0, {n_post})"))
        pairs = pre.astype(np.int64) * n_post + post.astype(np.int64)
        n_dup = pairs.size - np.unique(pairs).size
        if n_dup:
            out.append(make(
                "TB602", site,
                f"{n_dup} duplicate (pre, post) entries — their weights "
                f"accumulate on every spike"))
    base_kind = topo.meta.get("base_kind", topo.kind)
    if base_kind in _COVERED_KINDS and post.size:
        reached = np.unique(post[(post >= 0) & (post < n_post)])
        if reached.size < n_post:
            out.append(make(
                "TB603", site,
                f"IEs reach {reached.size}/{n_post} output neurons",
                hint="for pool/conv check the input geometry divides "
                     "into the declared output shape"))
    n_conn = topo.meta.get("n_connections")
    if base_kind == "conv":
        # conv counts every (output, tap) pair incl. zero-padding taps,
        # so the honest value comes from the recorded geometry
        m = topo.meta
        expect = (m["c_in"] * m["c_out"] * m["h_out"] * m["w_out"]
                  * m["k"] * m["k"]) if all(
                      k in m for k in
                      ("c_in", "c_out", "h_out", "w_out", "k")) else None
    else:
        expect = int(pre.size)
    if n_conn is None:
        out.append(make(
            "TB604", site,
            "meta records no n_connections; baseline_bits() and the "
            "Fig. 14 storage comparison cannot be computed"))
    elif expect is not None and int(n_conn) != expect:
        out.append(make(
            "TB604", site,
            f"meta n_connections={int(n_conn)} but the IE tables hold "
            f"{expect} connections — storage_bits() vs "
            f"baseline_bits() comparisons would lie"))
    return out


__all__ = ["check_topology"]
