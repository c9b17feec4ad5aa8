"""TB3xx: static checks over the registered KernelSpecs' CTA tiles.

The port of `repro/analysis/kernels.py`. For every registered kernel
family, and its backward kernel (`KernelSpec.bwd_tiles`), at the tile its
wrappers launch for `make_inputs`' call AND at every candidate route (`KernelSpec.candidates`: the dims or tile axes
that reach each route dispatch can take):

  * CTA grid coverage: the output tiling of the spec's `TileModel` writes
    every output element exactly once — no gaps (TB301), no overlaps
    (TB302);
  * tile contracts: preferred/align consistency and exact-axis division
    (TB303) — a recurrence's time axis, chained inside one CTA, must be
    taken whole;
  * shared-memory model honesty: the model (`KernelSpec.smem_bytes`, the
    most any of the route's launches asks of a CTA, static plus dynamic)
    must bound the CTA's shared buffers the `TileModel` declares (TB304
    when it underestimates, TB305 when it is more than 8x above them);
  * the tile must fit the card's shared memory a block at the spec's dims
    (TB306; `common.smem_budget`: the card's opt-in figure, or 227 KB of
    an sm_90 CTA on the CPU);
  * candidate keys must name real tile axes or dims (TB308; the port has
    no tuning cache);
  * the block-sparse spikemm channel's compacted table must be a faithful
    permutation of the occupancy bitmap, sentinels included (TB307).

Everything here reads spec metadata and shapes; nothing launches. The
card's launches are held against the same models by `chip_smoke.py`'s
verifier phase.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import registry
from repro_torch.kernels.common import plan_sms, smem_budget

from repro_torch.analysis.diagnostics import Diagnostic, make


# ---------------------------------------------------------------------------
# coverage painting
# ---------------------------------------------------------------------------


def _default_cells(tm: "registry.TileModel", dims: Mapping[str, int],
                   blocks: Mapping[str, int]
                   ) -> Iterable[Tuple[Tuple[int, int], ...]]:
    """The dense row-major tiling implied by `TileModel.out`."""
    return registry.tile_cells(*(
        (int(dims[dim]), int(dims[dim]) if axis is None
         else int(blocks[axis])) for dim, axis in tm.out))


def coverage_problems(tm: "registry.TileModel", dims: Mapping[str, int],
                      blocks: Mapping[str, int]) -> List[str]:
    """Paint every CTA's cell onto the output; report gaps and overlaps."""
    sizes = tuple(int(dims[dim]) for dim, _ in tm.out)
    paint = np.zeros(sizes, dtype=np.int16)
    cells = (tm.coverage(dims, blocks) if tm.coverage is not None
             else _default_cells(tm, dims, blocks))
    for cell in cells:
        paint[tuple(slice(lo, hi) for lo, hi in cell)] += 1
    problems: List[str] = []
    gaps = int((paint == 0).sum())
    overlaps = int((paint > 1).sum())
    if gaps:
        first = np.argwhere(paint == 0)[0]
        problems.append(
            f"gap: {gaps} output element(s) never written "
            f"(first at {tuple(int(i) for i in first)})")
    if overlaps:
        first = np.argwhere(paint > 1)[0]
        problems.append(
            f"overlap: {overlaps} output element(s) written more than once "
            f"(first at {tuple(int(i) for i in first)})")
    return problems


# ---------------------------------------------------------------------------
# sparse block-table verification
# ---------------------------------------------------------------------------


def check_block_table(flags: Any, ii: Any, kk: Any, active: Any) -> List[str]:
    """Verify a `compact_blocks` table against its occupancy bitmap.

    Contract: active entries enumerate each occupied block exactly once,
    row-major; every row block appears (silent rows via an inactive
    sentinel) so that every output row block is visited; inactive padding
    may only trail, pointing at the last row. Returns a list of violations
    (empty = faithful). Takes numpy arrays or tensors (read on the host).
    """
    flags, ii, kk, active = (
        np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
        for x in (flags, ii, kk, active))
    Mb, Kb = flags.shape
    problems: List[str] = []
    if not (ii.shape == kk.shape == active.shape) or ii.ndim != 1:
        return [f"table arrays disagree on shape: ii{ii.shape} kk{kk.shape} "
                f"active{active.shape}"]
    if np.any((ii < 0) | (ii >= Mb)):
        problems.append(f"row index out of range [0, {Mb})")
    act = active != 0
    if np.any(act & ((kk < 0) | (kk >= Kb))):
        problems.append(f"active column index out of range [0, {Kb})")
    if np.any(np.diff(ii) < 0):
        problems.append("row indices not non-decreasing (breaks the "
                        "same-row output accumulation)")
    occ = flags != 0
    seen = np.zeros((Mb, Kb), dtype=np.int64)
    for i, k, a in zip(ii, kk, act):
        if a and 0 <= i < Mb and 0 <= k < Kb:
            seen[i, k] += 1
    dup = np.argwhere(seen > 1)
    if dup.size:
        problems.append(f"occupied block visited twice (first at "
                        f"{tuple(int(x) for x in dup[0])})")
    missed = np.argwhere(occ & (seen == 0))
    if missed.size:
        problems.append(f"occupied block never visited (first at "
                        f"{tuple(int(x) for x in missed[0])})")
    ghost = np.argwhere((~occ) & (seen > 0))
    if ghost.size:
        problems.append(f"active entry at a silent block (first at "
                        f"{tuple(int(x) for x in ghost[0])})")
    rows = set(int(i) for i in ii[(ii >= 0) & (ii < Mb)])
    missing_rows = sorted(set(range(Mb)) - rows)
    if missing_rows:
        problems.append(f"row block(s) {missing_rows} absent from the table "
                        "(their output tiles are never initialized)")
    return problems


def check_flags(site: str, flags: Any) -> List[Diagnostic]:
    """TB307 over one occupancy bitmap: `compact_blocks`' table of it."""
    from repro_torch.kernels.spikemm.sparse import compact_blocks

    flags = torch.as_tensor(flags)
    ii, kk, active = compact_blocks(flags)
    return [make("TB307", site, problem,
                 hint="compact_blocks must enumerate occupied blocks "
                      "row-major with per-row sentinels")
            for problem in check_block_table(flags, ii, kk, active)]


def _check_sparse_channel(site: str) -> List[Diagnostic]:
    """TB307 over representative occupancy patterns at the sparse
    channel's block shape (`_build.SPARSE_BLOCK`)."""
    from repro_torch.kernels._build import SPARSE_BLOCK
    from repro_torch.kernels.spikemm.sparse import block_occupancy

    bm, bk = SPARSE_BLOCK
    M, K = 4 * bm, 2 * bk
    rng = np.random.default_rng(0)
    rasters = {
        "all-silent": np.zeros((M, K), np.float32),
        "all-dense": np.ones((M, K), np.float32),
        "random-p0.1": (rng.random((M, K)) < 0.1).astype(np.float32),
        "silent-middle-row": np.ones((M, K), np.float32),
    }
    rasters["silent-middle-row"][bm:2 * bm, :] = 0.0
    out: List[Diagnostic] = []
    for label, raster in rasters.items():
        flags = block_occupancy(torch.from_numpy(raster), bm, bk)
        out.extend(check_flags(f"{site}.sparse[{label}]", flags))
    return out


# ---------------------------------------------------------------------------
# per-spec checks
# ---------------------------------------------------------------------------


def _tile_bytes(tiles: Mapping[str, Tuple[int, ...]]) -> int:
    return 4 * sum(int(math.prod(shape)) for shape in tiles.values())


def route_shapes(spec: "registry.KernelSpec", dims: Mapping[str, int],
                 n_sm: Optional[int] = None
                 ) -> List[Tuple[str, Dict[str, int], Dict[str, int]]]:
    """(label, dims, blocks) of the spec's default tile at `dims` and of
    each candidate route: a candidate's keys that name dims replace them,
    the rest pin tile axes."""
    out = [("default", dict(dims), spec.resolve_blocks(dims, n_sm=n_sm))]
    for i, cand in enumerate(spec.candidates):
        d = {**dims, **{k: int(v) for k, v in cand.items() if k in dims}}
        pins = {k: v for k, v in cand.items() if k not in dims}
        out.append((f"candidates[{i}]", d,
                    spec.resolve_blocks(d, overrides=pins, n_sm=n_sm)))
    return out


def check_kernel(name: str) -> List[Diagnostic]:
    """TB301-309 for one registered kernel family: its forward kernels and
    its backward kernel's (`KernelSpec.bwd_tiles`, sited by its launch
    counter's name)."""
    spec = registry.get(name)
    out = check_spec(spec)
    if spec.bwd_tiles is not None:
        out.extend(check_spec(spec.bwd_tiles))
    return out


def check_spec(spec: "registry.KernelSpec") -> List[Diagnostic]:
    """TB301-309 for one spec's tiles (a family's, or its backward's)."""
    name = spec.name
    out: List[Diagnostic] = []
    axis_names = {ax.name for ax in spec.block_axes}

    # static contracts on the axes themselves
    for ax in spec.block_axes:
        if ax.preferred % ax.align:
            out.append(make(
                "TB303", f"{name}.{ax.name}",
                f"preferred={ax.preferred} is not a multiple of "
                f"align={ax.align}"))

    if spec.make_inputs is None or spec.dims_of is None:
        return out
    args = spec.make_inputs(torch.Generator().manual_seed(0))
    dims = spec.dims_of(*args, **spec.static)

    # candidate keys must name real tile axes or dims
    for i, cand in enumerate(spec.candidates):
        unknown = sorted(set(cand) - axis_names - set(dims))
        if unknown:
            out.append(make(
                "TB308", f"{name}.candidates[{i}]",
                f"keys {unknown} match no tile axis {sorted(axis_names)} "
                f"and no dim {sorted(dims)}"))
    if any(d.code == "TB308" for d in out):
        return out

    tm = spec.tile_model
    if tm is None:
        out.append(make(
            "TB309", name, "spec declares no TileModel: coverage and "
            "shared-memory checks are skipped",
            hint="add tile_model= to the KernelSpec registration"))

    limit = smem_budget()
    for label, d, blocks in route_shapes(spec, dims, n_sm=plan_sms()):
        site = f"{name}.{label}"
        for ax in spec.block_axes:
            if ax.name not in blocks:
                continue                 # an axis of another route
            b = blocks[ax.name]
            if ax.exact and d[ax.dim] % b:
                out.append(make(
                    "TB303", site,
                    f"exact axis {ax.name}: block {b} does not divide "
                    f"{ax.dim}={d[ax.dim]} (the chained state would be "
                    "cut between CTAs)"))
            elif not ax.exact and b % ax.align:
                out.append(make(
                    "TB303", site,
                    f"axis {ax.name}: block {b} is not a multiple of "
                    f"align={ax.align}"))
        if tm is None:
            continue
        for problem in coverage_problems(tm, d, blocks):
            code = "TB302" if problem.startswith("overlap") else "TB301"
            out.append(make(code, site, problem))
        need = _tile_bytes(tm.tiles(d, blocks))
        if tm.launches is not None:
            model = int(spec.smem_bytes(d, blocks))
            if model < need:
                out.append(make(
                    "TB304", site,
                    f"shared-memory model claims {model} B but the declared "
                    f"CTA buffers need {need} B: the plan would launch a "
                    "tile past what the kernel asks for"))
            elif need and model > 8 * need:
                out.append(make(
                    "TB305", site,
                    f"shared-memory model claims {model} B vs {need} B of "
                    "declared CTA buffers (>8x)"))
            if model > limit:
                out.append(make(
                    "TB306", site,
                    f"tile {blocks} models {model} B of shared memory a CTA "
                    f"> the budget {limit} B at dims {d}: the launch would "
                    "fail"))

    if "sparse" in spec.channels:
        out.extend(_check_sparse_channel(name))
    return out


def check_kernels(names: Optional[Sequence[str]] = None) -> List[Diagnostic]:
    """TB3xx across the registry (default: every registered family)."""
    registry.ensure_registered()
    out: List[Diagnostic] = []
    for name in (names if names is not None else registry.names()):
        out.extend(check_kernel(name))
    return out


__all__ = ["check_kernel", "check_kernels", "check_spec",
           "check_block_table", "check_flags", "coverage_problems",
           "route_shapes"]
