"""Compiler stack: network partition + core placement (paper §IV-C, Fig. 12).

The port's own numpy copy of `repro/core/mapping.py` (it imports no
JAX, but the port imports nothing of the JAX package): the same
arithmetic and the same seeds, so the same operators give the same
`Mapping` in both packages.

Pipeline (matching the paper's four steps):
  1. operator IR + fusion     — `fuse_ops` (conv+BN -> conv, BN1d+FC -> FC)
  2. network partition        — `partition`: neurons -> cores in channel
                                order under per-core neuron/fan-in budgets
  3. placement + resource opt — `place_zigzag` initial placement, then
                                `optimize_placement` (greedy swaps or
                                simulated annealing) driven by the packet
                                cost model; `merge_cores` folds under-utilized
                                cores of compatible operators together
  4. codegen                  — on TaiBai, binaries; here, a `Mapping` the
                                behavioural simulator (`core/simulator.py`)
                                consumes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np

# TaiBai hardware budgets (Table III, §IV-B)
CORE_NEURONS = 256            # neurons per NC (264K / 1056 NCs)
CORE_FANIN = 2048             # max fan-ins per neuron
GRID = (11, 12)               # CC array (132 CCs x 8 NCs)
NCS_PER_CC = 8
# Per-source-neuron fanout budget for the NoC link model: one CC's worth
# of downstream synapse slots. The JAX package's mapping check (TB405)
# flags sources whose average downstream synapse count per neuron exceeds
# it — the multicast the mesh would have to carry every timestep.
LINK_FANOUT = CORE_FANIN * NCS_PER_CC


@dataclasses.dataclass
class Op:
    """One operator-IR node after parsing a model front-end."""

    name: str
    kind: str                 # conv | fc | pool | bn | act | add
    n_neurons: int
    fan_in: int               # per-neuron fan-in
    inputs: Tuple[str, ...] = ()
    fused: Tuple[str, ...] = ()


def fuse_ops(ops: List[Op]) -> List[Op]:
    """Operator fusion: BN (and pool/activation bookkeeping) folds into the
    preceding conv/fc — paper Fig. 12b. Returns the optimized IR."""
    out: List[Op] = []
    by_name = {o.name: o for o in ops}
    consumed = set()
    for o in ops:
        if o.kind in ("bn", "act") and o.inputs:
            src = by_name.get(o.inputs[0])
            if src is not None and src.kind in ("conv", "fc"):
                src.fused = src.fused + (o.name,)
                consumed.add(o.name)
                # re-route consumers of the BN to the conv
                for q in ops:
                    q.inputs = tuple(src.name if i == o.name else i
                                     for i in q.inputs)
                continue
    for o in ops:
        if o.name not in consumed:
            out.append(o)
    return out


@dataclasses.dataclass
class CoreAssignment:
    op: str
    neuron_lo: int
    neuron_hi: int
    merged_with: List[str] = dataclasses.field(default_factory=list)


def partition(ops: List[Op], core_neurons: int = CORE_NEURONS,
              core_fanin: int = CORE_FANIN) -> List[CoreAssignment]:
    """Assign neurons to cores in channel order (Fig. 12c).

    Fan-in expansion: a neuron with fan-in F > core_fanin is decomposed into
    ceil(F / core_fanin) PSUM parts + 1 spiking part (paper Fig. 11); TaiBai
    keeps them in ONE core (intra-NC data path), so the per-core neuron
    budget is charged (parts) x (neurons) — we model exactly that.
    """
    cores: List[CoreAssignment] = []
    for op in ops:
        if op.kind in ("add",):
            continue                      # fused into destination cores (Fig. 8)
        parts = max(1, math.ceil(op.fan_in / core_fanin))
        effective = core_neurons // parts  # PSUM parts share the core
        n_cores = math.ceil(op.n_neurons / max(effective, 1))
        for c in range(n_cores):
            lo = c * effective
            hi = min(op.n_neurons, lo + effective)
            cores.append(CoreAssignment(op.name, lo, hi))
    return cores


def merge_cores(cores: List[CoreAssignment], ops: List[Op],
                core_neurons: int = CORE_NEURONS) -> List[CoreAssignment]:
    """Resource optimizer (Fig. 12d): merge under-utilized cores running the
    same operator *kind* at different layers (the paper's multi-network
    fusion gave 3.4x core reduction on the BCI app)."""
    kind_of = {o.name: o.kind for o in ops}
    merged: List[CoreAssignment] = []
    open_slots: Dict[str, CoreAssignment] = {}
    open_load: Dict[str, int] = {}
    for c in sorted(cores, key=lambda c: c.neuron_hi - c.neuron_lo):
        k = kind_of.get(c.op, "fc")
        size = c.neuron_hi - c.neuron_lo
        slot = open_slots.get(k)
        if slot is not None and open_load[k] + size <= core_neurons:
            slot.merged_with.append(c.op)
            open_load[k] += size
        else:
            nc = CoreAssignment(c.op, c.neuron_lo, c.neuron_hi)
            merged.append(nc)
            open_slots[k] = nc
            open_load[k] = size
    return merged


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


def place_zigzag(n_cores: int, grid: Tuple[int, int] = GRID) -> np.ndarray:
    """Initial placement on the CC grid along a zigzag (boustrophedon) curve
    — consecutive cores stay adjacent, so feed-forward traffic is short.

    Networks larger than one chip spill onto additional chips laid out in a
    row (the paper's proxy-unit chip expansion, §IV-B): chip c occupies
    x in [c*W, (c+1)*W), so inter-chip traffic shows up as long hops —
    exactly the cost structure the placement optimizer should punish."""
    H, W = grid
    coords = []
    for y in range(H):
        xs = range(W) if y % 2 == 0 else range(W - 1, -1, -1)
        for x in xs:
            coords.append((y, x))
    cap = len(coords) * NCS_PER_CC
    out = []
    for i in range(n_cores):
        chip, local = divmod(i, cap)
        y, x = coords[local // NCS_PER_CC]
        out.append((y, x + chip * W))
    return np.asarray(out)


def traffic_cost(traffic: np.ndarray, pos: np.ndarray) -> float:
    """Sum over core pairs of packets x Manhattan hops (XY routing)."""
    d = np.abs(pos[:, None, :] - pos[None, :, :]).sum(-1)
    return float((traffic * d).sum())


def optimize_placement(traffic: np.ndarray, grid: Tuple[int, int] = GRID,
                       iters: int = 2000, seed: int = 0,
                       method: str = "anneal") -> Tuple[np.ndarray, float]:
    """Greedy / simulated-annealing placement refinement (Fig. 12d).

    traffic[i, j] = packets from core i to core j (from the behavioural
    simulator). Swap deltas are computed incrementally (O(n) per proposal,
    not O(n^2)). Returns (positions, cost)."""
    n = traffic.shape[0]
    pos = place_zigzag(n, grid)
    rng = np.random.default_rng(seed)
    sym = (traffic + traffic.T).astype(np.float64)   # undirected hop cost
    np.fill_diagonal(sym, 0.0)
    cost = 0.5 * float((sym * np.abs(
        pos[:, None, :] - pos[None, :, :]).sum(-1)).sum()) if n <= 2048 \
        else traffic_cost(traffic, pos)
    t0 = max(cost / max(n, 1), 1e-9)

    def delta_swap(i, j):
        """Cost change if cores i and j swap positions."""
        di = np.abs(pos - pos[i]).sum(1)             # (n,) hops to pos_i
        dj = np.abs(pos - pos[j]).sum(1)
        ti, tj = sym[i].copy(), sym[j].copy()
        ti[j] = tj[i] = 0.0                          # i<->j unchanged by swap
        ti[i] = tj[j] = 0.0
        before = ti @ di + tj @ dj
        after = ti @ dj + tj @ di
        return after - before

    for it in range(iters):
        i, j = rng.integers(0, n, 2)
        if i == j:
            continue
        d = delta_swap(i, j)
        accept = d < 0
        if method == "anneal" and not accept:
            temp = t0 * (1.0 - it / iters) + 1e-12
            accept = rng.random() < math.exp(min(-d / temp, 0.0))
        if accept:
            pos[[i, j]] = pos[[j, i]]
            cost += d
    return pos, cost


@dataclasses.dataclass
class Mapping:
    """Final artifact: cores, positions, and objective telemetry."""

    cores: List[CoreAssignment]
    positions: np.ndarray
    cost: float
    meta: Dict = dataclasses.field(default_factory=dict)


MAX_PLACE_NODES = 512


def compile_network(ops: List[Op], traffic_fn=None, objective: str = "cores",
                    grid: Tuple[int, int] = GRID, seed: int = 0,
                    anneal_iters: int = 1000) -> Mapping:
    """End-to-end: fuse -> partition -> (merge) -> place -> optimize.

    objective: 'cores' minimizes core count (merge aggressively, as the
    paper's application deployments do); 'throughput' skips merging and
    spreads populations (more parallel-send width, more cores) — the Fig.
    13e trade-off.

    Networks with more cores than MAX_PLACE_NODES are COARSENED for the
    placement search: consecutive cores (already adjacent after zigzag)
    group into placement clusters; the optimizer moves clusters, every core
    inherits its cluster's position. Standard VLSI-placer clustering — keeps
    the SA search O(clusters^2) independent of network size.
    """
    ir = fuse_ops([dataclasses.replace(o) for o in ops])
    if objective == "throughput":
        # spread: halve the effective per-core population to widen parallelism
        cores = partition(ir, core_neurons=CORE_NEURONS // 4)
    else:
        cores = merge_cores(partition(ir), ir)
    n = len(cores)
    g = max(1, -(-n // MAX_PLACE_NODES))             # cores per cluster
    groups = [cores[i:i + g] for i in range(0, n, g)]
    if traffic_fn is not None:
        traffic = traffic_fn(groups)
    else:
        traffic = _default_traffic(groups, ir)
    # clusters of g cores occupy g NC slots -> effective grid unchanged;
    # place clusters on a grid scaled so capacity still fits
    pos_g, cost = optimize_placement(traffic, grid, iters=anneal_iters,
                                     seed=seed)
    pos = np.repeat(pos_g, [len(gr) for gr in groups], axis=0)
    return Mapping(cores, pos, cost,
                   meta={"objective": objective, "n_cores": n,
                         "n_clusters": len(groups)})


def _group_index(groups: List[List[CoreAssignment]]) -> Dict[str, List[int]]:
    idx_of: Dict[str, List[int]] = {}
    for gi, group in enumerate(groups):
        for c in group:
            idx_of.setdefault(c.op, []).append(gi)
    return idx_of


def _default_traffic(groups: List[List[CoreAssignment]],
                     ops: List[Op]) -> np.ndarray:
    """Feed-forward traffic estimate at cluster granularity: packets ∝
    source population size flowing to clusters of consumer ops."""
    idx_of = _group_index(groups)
    sizes = np.array([sum(c.neuron_hi - c.neuron_lo for c in g)
                      for g in groups], np.float64)
    consumers: Dict[str, List[str]] = {}
    for o in ops:
        for src in o.inputs:
            consumers.setdefault(src, []).append(o.name)
    n = len(groups)
    t = np.zeros((n, n))
    for o in ops:
        src_idx = sorted(set(idx_of.get(o.name, ())))
        if not src_idx:
            continue
        for dst_op in consumers.get(o.name, ()):
            dst_idx = sorted(set(idx_of.get(dst_op, ())))
            if not dst_idx:
                continue
            t[np.ix_(src_idx, dst_idx)] += (sizes[src_idx, None]
                                            / len(dst_idx))
    return t


__all__ = ["CORE_NEURONS", "CORE_FANIN", "GRID", "NCS_PER_CC", "LINK_FANOUT",
           "MAX_PLACE_NODES", "Op", "fuse_ops", "CoreAssignment",
           "partition", "merge_cores", "place_zigzag", "traffic_cost",
           "optimize_placement", "Mapping", "compile_network"]
