"""Block-gather spikemm: execute IE tables, not dense matrices.

The port of `repro/kernels/spikemm/gather.py`. `core/topology.py` stores
connectivity the way the chip does (typed fan-in IE tables); this module
is their execution form. The (pre, post, weight) triples an
`EncodedTopology` derives from its IE tables are packed once into a
block-level COO (`GatherTables`, numpy, built exactly as the JAX package
builds it):

    jj[t], kk[t]   post-/pre- block coordinates of occupied (bk, bn) blocks,
                   sorted post-block-major (the accumulation order),
    wblk[t]        the (bk, bn) dense patch of weights inside that block,
    act[t]         0 marks sentinels (one per empty post block, so every
                   output tile is visited and initialised exactly once)

and `spikemm_gather` contracts an (M, n_pre) spike raster against those
tables. Work scales with the number of occupied blocks E, never with
n_pre * n_post: the dense matrix is never built.

Registered as the `spikemm_gather` family: CUDA tensors launch
`csrc/spikemm_gather.cu`, an event-driven walk of the tables; CPU tensors
run `spikemm_gather_ref`, which sums every output in the kernel's order
(entries ascending, k ascending, a separately rounded multiply and add
per term), so the card matches it bit for bit.

The kernel reads a patch row only where it holds a nonzero weight
(`GatherTables.row_bitmap`, memoised on the device) and a spike of the
warp's rows meets it (found in the kernel by `__ballot_sync`), so what
bounds it is the bytes those rows, the raster and the output take, not
the E * bk * bn of every patch; where every row meets a spike (many rows
a call), the issue of the terms' separate multiplies and adds and the
latency of each warp's loads. A warp owns R rows and 32 C columns of one
post block, a thread C adjacent columns and R x C accumulators;
`gather_plan` takes C from bn and R, the column warps and the row groups
a CTA holds from M, bn and the SM count. Every term it skips is s * w
with s or w = +-0, which for finite inputs changes no bit of the chain
(see the kernel's header).

The gather is differentiable in the raster (`_SpikeMMGather`, as the JAX
package's custom VJP): d_spikes = g @ W^T is the gather's function on
`GatherTables.transpose()` (the ROADMAP's B6); the tables get no
cotangent: topology weights are configuration, not parameters. g is
dense, so an event walk has nothing to skip (it would list every nonzero
patch row and read each again for every few rows of g). On the card B6
is a kernel of its own, `csrc/spikemm_gather_bwd.cu`: a CTA owns BM rows
of g and a 32-column slab of one transposed post block
(`gather_bwd_plan`), walks the (32 x 32) sub-tiles of its post block's
patches that hold a nonzero weight (`GatherTables.tile_mask`, listed once
per slab by `bwd_steps` and memoised on the device), stages g's tile and
the patch's through a cp.async ring in shared memory, and adds the terms
in registers in the plain version's order: bit for bit
`spikemm_gather_bwd_ref` (`spikemm_gather_ref` on the transposed
tables). Each backward launch counts on `spikemm_gather_bwd_cuda` (the
registry's `spikemm_gather_bwd`) alone; `spikemm_gather_cuda` counts the
forward's kernel.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from types import SimpleNamespace
from typing import Dict

import numpy as np
import torch

from repro_torch.kernels import _build, registry
from repro_torch.kernels.common import sm_count

DEFAULT_BK = 128
DEFAULT_BN = 128


@dataclasses.dataclass(eq=False)
class GatherTables:
    """Packed block-level COO for one encoded topology (host-side numpy).

    Identity-hashed (eq=False), as in the JAX package: the tables are
    configuration, built once per topology and block shape."""

    jj: np.ndarray        # (E,) int32 post-block ids, non-decreasing
    kk: np.ndarray        # (E,) int32 pre-block ids
    act: np.ndarray       # (E,) int32, 0 = sentinel (empty post block)
    wblk: np.ndarray      # (E, bk, bn) float32 packed weight blocks
    n_pre: int
    n_post: int
    bk: int
    bn: int

    def __post_init__(self):
        self._device: Dict[torch.device, SimpleNamespace] = {}
        self._transposed = None

    @property
    def n_entries(self) -> int:
        return int(self.act.sum())

    @property
    def n_post_blocks(self) -> int:
        return max(1, -(-self.n_post // self.bn))

    def jptr(self) -> np.ndarray:
        """(n_post_blocks + 1,) int32: entries [jptr[j], jptr[j+1]) belong
        to post block j."""
        return np.searchsorted(self.jj, np.arange(self.n_post_blocks + 1)
                               ).astype(np.int32)

    def row_bitmap(self) -> np.ndarray:
        """(E, ceil(bk / 32)) int32: bit k % 32 of word k // 32 of entry t
        is set iff row k of `wblk[t]` holds a nonzero weight, the entry is
        active and its pre neuron kk[t] * bk + k lies below n_pre. The
        rows the kernel may read; derived from the tables, not part of
        them."""
        E, bk = len(self.jj), self.bk
        words = -(-bk // 32)
        rows = np.zeros((E, words * 32), bool)
        rows[:, :bk] = ((self.wblk != 0).any(axis=2)
                        & (self.act != 0)[:, None]
                        & (self.kk.astype(np.int64)[:, None] * bk
                           + np.arange(bk) < self.n_pre))
        packed = np.packbits(rows.reshape(E, words, 32), axis=2,
                             bitorder="little")
        return np.ascontiguousarray(packed).view("<u4").reshape(
            E, words).view(np.int32)

    def tile_mask(self) -> np.ndarray:
        """(E, ceil(bk / 32), ceil(bn / 32)) bool: whether the (32 x 32)
        sub-tile (rows 32 w.., columns 32 c..) of entry t's patch holds a
        nonzero weight of the dense matrix: the entry is active and the
        weight's pre neuron kk[t] * bk + k lies below n_pre and its post
        neuron jj[t] * bn + n below n_post. The sub-tiles B6's kernel
        reads; derived from the tables, not part of them."""
        E, bk, bn = len(self.jj), self.bk, self.bn
        kw, cw = -(-bk // 32), -(-bn // 32)
        nz = np.zeros((E, kw * 32, cw * 32), bool)
        nz[:, :bk, :bn] = (
            (self.wblk != 0)
            & (self.act != 0)[:, None, None]
            & (self.kk.astype(np.int64)[:, None, None] * bk
               + np.arange(bk)[None, :, None] < self.n_pre)
            & (self.jj.astype(np.int64)[:, None, None] * bn
               + np.arange(bn)[None, None, :] < self.n_post))
        return nz.reshape(E, kw, 32, cw, 32).any(axis=(2, 4))

    def bwd_steps(self):
        """B6's step lists, from `tile_mask`: (sptr, steps), int32. For
        post block j and 32-column slab c (b = j * slabs + c, slabs =
        ceil(bn / 32)), steps[sptr[b]:sptr[b + 1]] lists t * ceil(bk / 32)
        + w for the sub-tiles (t, w, c) that hold a nonzero weight: the
        block's entries in list order, each one's words ascending."""
        mask = self.tile_mask()
        kw, cw = mask.shape[1], mask.shape[2]
        t, w, c = np.nonzero(mask)
        block = self.jj[t].astype(np.int64) * cw + c
        order = np.lexsort((w, t, block))
        steps = (t.astype(np.int64) * kw + w)[order]
        sptr = np.searchsorted(block[order],
                               np.arange(self.n_post_blocks * cw + 1))
        return sptr.astype(np.int32), steps.astype(np.int32)

    def device(self, device: torch.device, *, bwd: bool = False
               ) -> SimpleNamespace:
        """Memoised copies of the tables, `jptr` and, for the kernel,
        `row_bitmap()` (as `rowbits`) on `device`; with `bwd`, also
        `bwd_steps()` (as `sptr`, `steps`), built on first use."""
        device = torch.device(device)
        if device not in self._device:
            self._device[device] = SimpleNamespace(**{
                k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in (("jj", self.jj), ("kk", self.kk),
                             ("act", self.act), ("wblk", self.wblk),
                             ("jptr", self.jptr()),
                             ("rowbits", self.row_bitmap()))})
        dt = self._device[device]
        if bwd and not hasattr(dt, "steps"):
            sptr, steps = self.bwd_steps()
            dt.sptr = torch.from_numpy(sptr).to(device)
            dt.steps = torch.from_numpy(steps).to(device)
        return dt

    def transpose(self) -> "GatherTables":
        """Tables for x @ W^T: the active entries with their block roles
        swapped and each patch transposed, finished as a forward table is
        (sorted post-block-major, a sentinel a post block with no entry).
        Memoised, with the back-link, so `t.transpose().transpose() is t`
        and each side's device copies are built once."""
        if self._transposed is None:
            real = self.act != 0
            self._transposed = _finalize_tables(
                self.kk[real], self.jj[real],
                self.wblk[real].transpose(0, 2, 1),
                n_pre=self.n_post, n_post=self.n_pre,
                bk=self.bn, bn=self.bk)
            self._transposed._transposed = self
        return self._transposed


def _finalize_tables(jj, kk, wblk, *, n_pre, n_post, bk, bn) -> GatherTables:
    """Sort entries post-block-major and add one inactive sentinel per empty
    post block so the kernel visits (and zero-initializes) every output
    tile."""
    jj = np.asarray(jj, np.int32)
    kk = np.asarray(kk, np.int32)
    wblk = np.asarray(wblk, np.float32).reshape(-1, bk, bn)
    act = np.ones(len(jj), np.int32)
    n_post_blocks = max(1, -(-n_post // bn))
    missing = np.setdiff1d(np.arange(n_post_blocks, dtype=np.int32),
                           np.unique(jj))
    if len(missing):
        jj = np.concatenate([jj, missing])
        kk = np.concatenate([kk, np.zeros(len(missing), np.int32)])
        act = np.concatenate([act, np.zeros(len(missing), np.int32)])
        wblk = np.concatenate(
            [wblk, np.zeros((len(missing), bk, bn), np.float32)])
    order = np.lexsort((kk, jj))
    return GatherTables(jj=np.ascontiguousarray(jj[order]),
                        kk=np.ascontiguousarray(kk[order]),
                        act=np.ascontiguousarray(act[order]),
                        wblk=np.ascontiguousarray(wblk[order]),
                        n_pre=int(n_pre), n_post=int(n_post),
                        bk=int(bk), bn=int(bn))


def build_gather_tables(pre, post, w, n_pre: int, n_post: int, *,
                        bk: int = DEFAULT_BK, bn: int = DEFAULT_BN
                        ) -> GatherTables:
    """Pack (pre, post, weight) COO triples into block tables.

    Duplicated (pre, post) pairs accumulate into the same block slot,
    matching the event-driven `propagate()` semantics. Out-of-range indices
    raise — ghost IE entries must never silently scatter.
    """
    pre = np.asarray(pre, np.int64).ravel()
    post = np.asarray(post, np.int64).ravel()
    w = np.asarray(w, np.float32).ravel()
    if not (len(pre) == len(post) == len(w)):
        raise ValueError("pre/post/weight lengths differ")
    if len(pre):
        if pre.min() < 0 or pre.max() >= n_pre:
            raise ValueError(f"ghost pre index outside [0, {n_pre})")
        if post.min() < 0 or post.max() >= n_post:
            raise ValueError(f"ghost post index outside [0, {n_post})")
    n_pre_blocks = max(1, -(-n_pre // bk))
    bid = (post // bn) * n_pre_blocks + (pre // bk)
    uniq = np.unique(bid)
    wblk = np.zeros((len(uniq), bk, bn), np.float32)
    if len(pre):
        rank = np.searchsorted(uniq, bid)
        np.add.at(wblk, (rank, pre % bk, post % bn), w)
    jj = (uniq // n_pre_blocks).astype(np.int32)
    kk = (uniq % n_pre_blocks).astype(np.int32)
    return _finalize_tables(jj, kk, wblk, n_pre=n_pre, n_post=n_post,
                            bk=bk, bn=bn)


# ---------------------------------------------------------------------------
# plain version and CUDA wrapper
# ---------------------------------------------------------------------------


def spikemm_gather_ref(spikes: torch.Tensor, tables: GatherTables
                       ) -> torch.Tensor:
    """Plain version: (M, n_pre) spikes -> (M, n_post) currents.

    Every output element is one sequential fp32 sum, in the kernel's
    order: the entries of its post block in list order (ascending kk),
    then each entry's bk rows in ascending k, adding `s * w` rounded as a
    product and then as a sum. The loop runs over (entry slot, k) and is
    vectorised over rows and post blocks; a post block with fewer entries
    adds exact zeros in its missing slots, which change nothing."""
    M = spikes.shape[0]
    bk, bn = tables.bk, tables.bn
    kb = max(1, -(-tables.n_pre // bk))
    jb = tables.n_post_blocks
    dt = tables.device(spikes.device)
    s = torch.zeros((M, kb * bk), dtype=torch.float32, device=spikes.device)
    s[:, :spikes.shape[1]] = spikes
    sb = s.reshape(M, kb, bk)
    jptr = tables.jptr().astype(np.int64)
    counts = jptr[1:] - jptr[:-1]
    acc = torch.zeros((M, jb, bn), dtype=torch.float32, device=spikes.device)
    for e in range(int(counts.max())):
        t = np.minimum(jptr[:-1] + e, jptr[1:] - 1)          # (jb,)
        live = (counts > e) & (tables.act[t] != 0)
        t_dev = torch.from_numpy(t).to(spikes.device)
        live_dev = torch.from_numpy(live).to(spikes.device)
        w_e = torch.where(live_dev[:, None, None], dt.wblk[t_dev],
                          torch.zeros((), device=spikes.device))
        s_e = sb[:, dt.kk[t_dev].long(), :]                  # (M, jb, bk)
        for k in range(bk):
            acc = acc + s_e[:, :, k, None] * w_e[None, :, k, :]
    return acc.reshape(M, jb * bn)[:, :tables.n_post]


# the kernel's rows a warp and columns a lane (its instantiations: at most
# GATHER_MAX_ACC accumulators a thread), warps a CTA at most, and the warps
# an SM the plan gives a call where it can (four a scheduler: a warp's next
# listed rows wait on its loads)
GATHER_ROWS = (1, 2, 4, 8)
GATHER_COLS = (1, 4)
GATHER_MAX_ACC = 16
GATHER_WARPS_PER_SM = 16
GATHER_MAX_WARPS = 8


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """How `csrc/spikemm_gather.cu` covers an (M, n_post) output.

    A warp owns `rows` rows and 32 x `cols` columns of one post block (a
    column warp), a lane `cols` adjacent columns; a post block takes
    `col_warps` = ceil(bn / (32 cols)) of them. A CTA holds `groups` row
    groups x `units` consecutive column warps, so `rows * groups` rows and
    `units / col_warps` post blocks (a part of one where that is under 1);
    the grid is (ceil(n_post_blocks * col_warps / units),
    ceil(ceil(M / rows) / groups))."""
    rows: int
    cols: int
    col_warps: int
    units: int
    groups: int
    grid: tuple

    @property
    def warps(self) -> int:
        return self.units * self.groups

    @property
    def rows_per_cta(self) -> int:
        return self.rows * self.groups

    @property
    def post_blocks_per_cta(self) -> float:
        return self.units / self.col_warps


@functools.lru_cache(maxsize=256)
def gather_plan(M: int, bn: int, n_post_blocks: int, n_sm: int, *,
                rows: int = None, cols: int = None) -> GatherPlan:
    """The gather kernel's plan for M rows of post blocks bn wide.

    Columns a lane: 4 where 4 divides bn and bn >= 128 (a warp no wider
    than the post block), else 1. Rows a warp: of
    GATHER_ROWS up to the least that holds M, with at most GATHER_MAX_ACC
    accumulators a thread, the most that still gives the card
    GATHER_WARPS_PER_SM warps an SM, else 1. Every row of a warp shares
    its weight loads (the rows a warp reads are the union of its rows'
    events), but a warp's listed rows wait on its loads, so where the
    rows are many (the banded chunk, 64) more warps of fewer rows win. A
    CTA takes up to GATHER_MAX_WARPS warps: the row groups of a post block
    first (they read the same weight rows, through the SM's L1), then
    more post blocks; then, while the grid holds fewer CTAs than the card
    has SMs, fewer post blocks and then fewer row groups a CTA. `rows` and
    `cols` take another instantiation instead (`chip_smoke.py` times
    each)."""
    if cols is None:
        cols = 4 if bn % 4 == 0 and bn >= 128 else 1
    if M < 1 or n_post_blocks < 1 or cols not in GATHER_COLS or bn % cols:
        raise ValueError(f"gather_plan: M={M}, bn={bn}, "
                         f"n_post_blocks={n_post_blocks}, cols={cols}")
    q = -(-bn // (32 * cols))
    if rows is None:
        fits = [r for r in GATHER_ROWS
                if r * cols <= GATHER_MAX_ACC and r // 2 < M]
        rows = next((r for r in fits[::-1] if n_post_blocks * q * -(-M // r)
                     >= GATHER_WARPS_PER_SM * n_sm), fits[0])
    if rows not in GATHER_ROWS or rows * cols > GATHER_MAX_ACC:
        raise ValueError(f"gather_plan: rows={rows}, cols={cols}")
    n_groups = -(-M // rows)
    if q >= GATHER_MAX_WARPS:
        units, groups = GATHER_MAX_WARPS, 1
    else:
        groups = min(n_groups, GATHER_MAX_WARPS // q)
        units = q * max(1, GATHER_MAX_WARPS // (q * groups))

    def grid(units, groups):
        return (-(-n_post_blocks * q // units), -(-n_groups // groups))

    while math.prod(grid(units, groups)) < n_sm:
        if units > q and q < GATHER_MAX_WARPS:
            units = q * max(1, units // q // 2)
        elif groups > 1:
            groups = max(1, groups // 2)
        else:
            break
    g = grid(units, groups)
    if g[1] > 65535:
        raise ValueError(f"spikemm_gather: M={M} rows exceed one launch")
    return GatherPlan(rows, cols, q, units, groups, g)


def _check_input(name: str, x: torch.Tensor, n: int) -> None:
    """A gather kernel's input: a contiguous float32 (M, n) CUDA tensor."""
    if not x.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"{x.device}")
    if x.dim() != 2 or x.shape[1] != n:
        raise ValueError(f"{name}: input {tuple(x.shape)} must be (M, {n})")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: input must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")


def spikemm_gather_cuda(spikes: torch.Tensor, tables: GatherTables
                        ) -> torch.Tensor:
    """Launch `csrc/spikemm_gather.cu` on a CUDA raster."""
    _check_input("spikemm_gather", spikes, tables.n_pre)
    M = spikes.shape[0]
    out = torch.empty((M, tables.n_post), dtype=torch.float32,
                      device=spikes.device)
    if out.numel() == 0:
        return out
    launch_plan(spikes, tables, out, gather_plan(
        M, tables.bn, tables.n_post_blocks, sm_count(spikes.device)))
    spikemm_gather_cuda.launches += 1
    return out


def launch_plan(spikes: torch.Tensor, tables: GatherTables,
                out: torch.Tensor, plan: GatherPlan) -> None:
    """One launch of `csrc/spikemm_gather.cu` under `plan` into `out`, on
    tensors `spikemm_gather_cuda` has checked (it counts the launch)."""
    lib = _build.library()
    dt = tables.device(spikes.device)
    with torch.cuda.device(spikes.device):
        code = lib.spikemm_gather_f32(
            spikes.data_ptr(), dt.wblk.data_ptr(), dt.rowbits.data_ptr(),
            dt.jptr.data_ptr(), dt.kk.data_ptr(), out.data_ptr(),
            spikes.shape[0], tables.n_pre, tables.n_post, tables.bk,
            tables.bn, tables.n_post_blocks, plan.rows, plan.cols,
            plan.units, plan.groups, torch.cuda.current_stream().cuda_stream)
    _build.check("spikemm_gather", code)


spikemm_gather_cuda.launches = 0


def spikemm_gather_bwd_ref(g: torch.Tensor, tables: GatherTables
                           ) -> torch.Tensor:
    """B6's plain version: d_spikes = g @ W^T, `spikemm_gather_ref` on the
    transposed tables."""
    return spikemm_gather_ref(g, tables.transpose())


# B6's kernel: rows of g a thread (16 threads along the rows of a CTA) and
# columns a CTA (one slab of a post block; `csrc/spikemm_gather_bwd.cu`'s
# SLAB, which the step lists of `GatherTables.bwd_steps` also assume)
GATHER_BWD_RPT = (4, 2, 1)
GATHER_BWD_THREAD_ROWS = 16
GATHER_BWD_THREADS = 128    # threads a CTA of B6 (8 x 16)
GATHER_BWD_STAGES = 2       # steps of B6's cp.async ring
GATHER_BWD_SLAB = 32


@dataclasses.dataclass(frozen=True)
class GatherBwdPlan:
    """How `csrc/spikemm_gather_bwd.cu` covers an (M, n_post) output: a CTA
    owns `rows_per_cta` = 16 x `rows` rows and one 32-column slab of a post
    block; the grid is (post blocks x slabs, ceil(M / rows_per_cta))."""
    rows: int
    grid: tuple

    @property
    def rows_per_cta(self) -> int:
        return GATHER_BWD_THREAD_ROWS * self.rows


@functools.lru_cache(maxsize=256)
def gather_bwd_plan(M: int, bn: int, n_post_blocks: int, n_sm: int
                    ) -> GatherBwdPlan:
    """B6's plan for M rows of g against post blocks bn wide: the most rows
    a thread (4, 2, 1) whose CTA holds fewer than twice M's rows (16 x
    rows < 2 M, or 1 row a thread) and whose grid still holds two CTAs an
    SM, else the fewest such. More rows a thread make each weight a thread
    loads from shared memory serve more terms; more CTAs keep the card
    busy at few rows. (8 rows a thread measured slower at every B6 call of
    `chip_smoke.py`: 168 registers leave 3 CTAs an SM.)"""
    if M < 1 or bn < 1 or n_post_blocks < 1:
        raise ValueError(f"gather_bwd_plan: M={M}, bn={bn}, "
                         f"n_post_blocks={n_post_blocks}")
    slabs = n_post_blocks * -(-bn // GATHER_BWD_SLAB)

    def grid(r):
        return (slabs, -(-M // (GATHER_BWD_THREAD_ROWS * r)))
    fits = [r for r in GATHER_BWD_RPT
            if r == 1 or GATHER_BWD_THREAD_ROWS * r < 2 * M]
    rows = next((r for r in fits if math.prod(grid(r)) >= 2 * n_sm),
                fits[-1])
    g = grid(rows)
    if g[1] > 65535:
        raise ValueError(f"spikemm_gather_bwd: M={M} rows exceed one launch")
    return GatherBwdPlan(rows, g)


def launch_bwd_plan(g: torch.Tensor, tables: GatherTables,
                    out: torch.Tensor, plan: GatherBwdPlan) -> None:
    """One launch of `csrc/spikemm_gather_bwd.cu` under `plan` into `out`,
    `tables` the transposed tables (g is (M, tables.n_pre)), on tensors
    `spikemm_gather_bwd_cuda` has checked (it counts the launch)."""
    lib = _build.library()
    dt = tables.device(g.device, bwd=True)
    with torch.cuda.device(g.device):
        code = lib.spikemm_gather_bwd_f32(
            g.data_ptr(), dt.wblk.data_ptr(), dt.sptr.data_ptr(),
            dt.steps.data_ptr(), dt.kk.data_ptr(), out.data_ptr(),
            g.shape[0], tables.n_pre, tables.n_post, tables.bk, tables.bn,
            tables.n_post_blocks, plan.rows,
            torch.cuda.current_stream().cuda_stream)
    _build.check("spikemm_gather_bwd", code)


def spikemm_gather_bwd_cuda(g: torch.Tensor, tables: GatherTables
                            ) -> torch.Tensor:
    """B6 on the card: one launch of `csrc/spikemm_gather_bwd.cu` on the
    transposed tables, counted here (the forward gather's count is its
    own kernel's)."""
    t = tables.transpose()
    _check_input("spikemm_gather_bwd", g, t.n_pre)
    M = g.shape[0]
    out = torch.empty((M, t.n_post), dtype=torch.float32, device=g.device)
    if out.numel() == 0:
        return out
    launch_bwd_plan(g, t, out, gather_bwd_plan(
        M, t.bn, t.n_post_blocks, sm_count(g.device)))
    spikemm_gather_bwd_cuda.launches += 1
    return out


class _SpikeMMGather(torch.autograd.Function):
    """`fwd` forward and `bwd` backward of the gather: the registry's
    dispatch on the tables and on their transpose (both None), or a given
    pair (the parity harness's VJP leg). The backward returns g's dtype
    and no cotangent for the tables."""

    @staticmethod
    def forward(ctx, spikes, tables, fwd, bwd):
        ctx.tables, ctx.bwd = tables, bwd
        if fwd is None:
            return registry.dispatch("spikemm_gather", (spikes, tables))
        return fwd(spikes, tables)

    @staticmethod
    def backward(ctx, g):
        g32 = g.contiguous().float()
        gs = (registry.dispatch_bwd("spikemm_gather", (g32, ctx.tables))
              if ctx.bwd is None else ctx.bwd(g32, ctx.tables))
        return gs.to(g.dtype), None, None, None


def spikemm_gather(spikes: torch.Tensor, tables: GatherTables
                   ) -> torch.Tensor:
    """IE-table contraction: (M, n_pre) spikes -> (M, n_post) currents.
    Differentiable in `spikes` (B6: the gather on `tables.transpose()`)."""
    return _SpikeMMGather.apply(spikes, tables, None, None)


def _vjp(fwd, bwd, spikes, tables):
    return _SpikeMMGather.apply(spikes, tables, fwd, bwd)


def _make_inputs(generator: torch.Generator):
    m, n_pre, n_post = 96, 260, 200               # non-multiples: padding
    mask = (torch.rand((n_pre, n_post), generator=generator) < 0.05).numpy()
    pre, post = np.nonzero(mask)
    w = torch.randn((len(pre),), generator=generator).numpy()
    tables = build_gather_tables(pre, post, w, n_pre, n_post)
    spikes = (torch.rand((m, n_pre), generator=generator) < 0.3).float()
    return spikes, tables


def _dims(spikes, tables):
    return {"M": spikes.shape[0], "K": tables.n_pre, "N": tables.n_post,
            "BK": tables.bk, "BN": tables.bn, "JB": tables.n_post_blocks}


def _plan(dims, n_sm, overrides):
    """`gather_plan`'s warps, with `cols` pinned where a candidate asks
    for the other instantiation."""
    p = gather_plan(dims["M"], dims["BN"], dims["JB"], n_sm,
                    cols=overrides.get("cols"))
    return {"rows": p.rows, "cols": p.cols, "units": p.units,
            "groups": p.groups}


def _launches(dims, blocks):
    q = -(-dims["BN"] // (32 * blocks["cols"]))
    units, groups, rows = blocks["units"], blocks["groups"], blocks["rows"]
    threads = 32 * units * groups
    grid = (-(-dims["JB"] * q // units), -(-(-(-dims["M"] // rows)) // groups),
            1)
    return (registry.Launch("spikemm_gather_kernel", grid, threads,
                            4 * threads * rows),)


def _coverage(dims, blocks):
    """A CTA's `groups` x `rows` rows and `units` column warps, each warp
    32 `cols` columns of one post block (cut at the block's and the
    output's edge)."""
    M, N, bn = dims["M"], dims["N"], dims["BN"]
    span = 32 * blocks["cols"]
    q = -(-bn // span)
    rows = blocks["rows"] * blocks["groups"]
    gx, gy, _ = _launches(dims, blocks)[0].grid
    for x in range(gx):
        for u in range(x * blocks["units"],
                       min((x + 1) * blocks["units"], dims["JB"] * q)):
            j, c = divmod(u, q)
            lo = j * bn + c * span
            hi = min(j * bn + min((c + 1) * span, bn), N)
            if lo >= hi:
                continue
            for y in range(gy):
                yield (y * rows, min((y + 1) * rows, M)), (lo, hi)


def _bwd_plan(dims, n_sm, overrides):
    """B6 runs on the transposed tables: bk and bn swap, and the post
    blocks are the forward's pre blocks."""
    p = gather_bwd_plan(dims["M"], dims["BK"], -(-dims["K"] // dims["BK"]),
                        n_sm)
    return {"rows": p.rows}


def _bwd_tiles(dims, blocks):
    bm = GATHER_BWD_THREAD_ROWS * blocks["rows"]
    return {"g_ring": (GATHER_BWD_STAGES, bm, 32 + 4),
            "w_ring": (GATHER_BWD_STAGES, 32, GATHER_BWD_SLAB)}


def _bwd_launches(dims, blocks):
    slabs = -(-dims["BK"] // GATHER_BWD_SLAB)
    words = sum(math.prod(v) for v in _bwd_tiles(dims, blocks).values())
    return (registry.Launch(
        "gather_bwd_kernel",
        (-(-dims["K"] // dims["BK"]) * slabs,
         -(-dims["M"] // (GATHER_BWD_THREAD_ROWS * blocks["rows"])), 1),
        GATHER_BWD_THREADS, 4 * words),)


def _bwd_coverage(dims, blocks):
    """g_spikes (M, n_pre): a CTA's 16 x rows rows and a 32-column slab of
    one transposed post block (a forward pre block, BK wide)."""
    M, K, bk = dims["M"], dims["K"], dims["BK"]
    rows = GATHER_BWD_THREAD_ROWS * blocks["rows"]
    slabs = -(-bk // GATHER_BWD_SLAB)
    for j in range(-(-K // bk)):
        for c in range(slabs):
            lo = j * bk + c * GATHER_BWD_SLAB
            hi = min(j * bk + min((c + 1) * GATHER_BWD_SLAB, bk), K)
            for y in range(-(-M // rows)):
                yield (y * rows, min((y + 1) * rows, M)), (lo, hi)


registry.register(registry.KernelSpec(
    name="spikemm_gather", plain=spikemm_gather_ref,
    cuda=spikemm_gather_cuda, make_inputs=_make_inputs, tol=1e-4,
    diff_argnums=(0,), vjp=_vjp,
    bwd=registry.Channel(plain=spikemm_gather_bwd_ref,
                         cuda=spikemm_gather_bwd_cuda),
    bwd_name="spikemm_gather_bwd",
    block_axes=(registry.BlockAxis("rows", "M", 8, 1),
                registry.BlockAxis("groups", "M", GATHER_MAX_WARPS, 1),
                registry.BlockAxis("cols", "BN", 4, 1),
                registry.BlockAxis("units", "JB", GATHER_MAX_WARPS, 1)),
    dims_of=_dims, plan=_plan,
    # C = 1 and C = 4 (a 128-wide post block), and the banded chunk's rows
    candidates=({"cols": 1}, {"N": 512, "BN": 128, "JB": 4, "cols": 4},
                {"M": 64, "K": 8192, "N": 8192, "BK": 128, "BN": 128,
                 "JB": 64}),
    tile_model=registry.TileModel(
        out=(("M", "rows"), ("N", "units")),
        tiles=lambda dims, blocks: {"x": (32 * blocks["units"]
                                          * blocks["groups"],
                                          blocks["rows"])},
        launches=_launches, coverage=_coverage),
    bwd_tiles=registry.KernelSpec(
        name="spikemm_gather_bwd", plain=spikemm_gather_bwd_ref,
        cuda=spikemm_gather_bwd_cuda, make_inputs=_make_inputs,
        dims_of=_dims, plan=_bwd_plan,
        block_axes=(registry.BlockAxis("rows", "M", 4, 1),),
        # train_banded's step (64 rows of the 8192-neuron band) and one row
        candidates=({"M": 64, "K": 8192, "N": 8192, "BK": 128, "BN": 128,
                     "JB": 64}, {"M": 1}),
        tile_model=registry.TileModel(out=(("M", "rows"), ("K", None)),
                                      tiles=_bwd_tiles,
                                      launches=_bwd_launches,
                                      coverage=_bwd_coverage))))

__all__ = ["GatherTables", "GatherPlan", "GatherBwdPlan",
           "build_gather_tables", "gather_plan", "gather_bwd_plan",
           "spikemm_gather", "spikemm_gather_cuda", "spikemm_gather_ref",
           "spikemm_gather_bwd_cuda", "spikemm_gather_bwd_ref", "DEFAULT_BK",
           "DEFAULT_BN", "GATHER_ROWS", "GATHER_COLS", "GATHER_MAX_ACC",
           "GATHER_MAX_WARPS", "GATHER_WARPS_PER_SM", "GATHER_BWD_RPT",
           "GATHER_BWD_SLAB", "GATHER_BWD_THREAD_ROWS", "launch_plan",
           "launch_bwd_plan"]
