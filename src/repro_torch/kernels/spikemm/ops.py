"""Public spikemm entry: registry dispatch over two channels.

`spikemm(spikes, w)` computes spikes (M, K) @ w (K, N). Two channels
compute it, as in the JAX package:

  * **dense** (the family's own pair): on CUDA tensors `csrc/spikemm.cu`,
    one launch and nothing before it. The kernel finds each row's events
    itself (FINDIDX) and adds their weight rows (LOCACC), or runs a
    register-blocked loop over chunks dense enough for it, chosen on the
    card from the count it just made; both give the same fmaf chain, bit
    for bit (`spikemm_chain_ref` is that chain in plain PyTorch). The
    wrapper only picks the CTA's tile from the shapes and the SM count
    (`col_tile`, `rows_per_cta`). On CPU tensors the plain matmul
    `spikemm_ref`.
  * **sparse** (`sparse.py`): `csrc/spikemm_sparse.cu`, two launches and
    no host sync: its occupancy kernel flags the occupied `SPARSE_BLOCK`
    blocks, then its product walks those only; its plain version is the
    occupied-slab matmul.

`_select_channel` routes between them per call. The
`REPRO_SPIKEMM_SPARSE=never|auto|always` environment variable pins the
choice, with the JAX package's values and message; `auto` (the default)
measures the block occupancy at the sparse kernel's block shape (on the
card, one launch of the occupancy kernel and one host read of its 4-byte
count: the sync the JAX package's eager router takes too), goes sparse
at or below `_SPARSE_THRESHOLD_DEFAULT`, and hands the sparse channel the
flags it measured, so one call reduces the raster to flags once.
The JAX package routes a traced raster dense under `auto`, since its
occupancy is unknowable; its serve engine's step is jitted, so serving
always runs dense. The port has no tracers, so a caller that stands for
such a step (the port's serve engine) passes `_traced=True` and gets the
same routing, with no occupancy sync.

The JAX package's per-shape threshold tuning (`sparse_threshold` looking
up `spikemm.sparse_th` in its tuning cache) is not ported: those
crossovers were timed on the CPU.

`spikemm` is differentiable through `_SpikeMM`, which wraps the whole
dispatch, both channels, as the JAX package's custom VJP wraps its
router (its sparse channel has no VJP of its own):

  * g_w = spikes^T @ g goes to `spikemm_g_w`. Under `auto` and `never` it
    is the family's backward pair (`registry.dispatch_bwd`): on the card
    `csrc/spikemm_wgrad.cu` (`wgrad.py`, counted as `spikemm_wgrad`), its
    own kernel for this product, reading the raster and g as they are
    (no transposed copy), its reduction split into chunks of
    `wgrad_chunk(R, K, N)` rows; with no occupancy launch and no host
    read. On the CPU the plain product `spikemm_wgrad_ref`. Under
    `always` it is the spike product on the transposed raster through
    the sparse channel, which that setting pins
    (`csrc/spikemm_sparse.cu` on the card). The recurrent g_W
    (`lifrec.ops.rec_g_w`) takes the same route, its one-step-shifted
    raster given as s0 and the spikes plane (`head`), not concatenated.
  * g_spikes = g @ w^T is a plain dense product (`torch.matmul`, as the
    JAX package's `jnp.dot` outside any Pallas kernel), computed only
    where the raster needs a gradient: an input layer's never does.

`spikemm_sessions(spikes, w)` is the same product with a session axis,
registered as its own family (`spikemm_sessions`): a learning serve window
(`EngineConfig(learn=True)`) gives each of S sessions its own weight,
w (S, K, N), and its row of each step of a (T, S, K) raster; session s's
(T, N) rows are its rows @ w[s]. It is what the JAX package's per-session
`vmap` of the spike kernel computes. On the card it is one launch of
`csrc/spikemm_sessions.cu`, a kernel of its own shaped for the session:
a CTA owns one session's T rows (rounded up to its tile) and a column
slab (`session_tile`), and streams that slab of w[s] once through the
dense route's cp.async ring, reading the raster's rows in place. Each
session's result is bit for bit the unbatched kernel's on its rows alone
(the same fmaf chain); its plain version loops the unbatched plain
version over the sessions. It takes the dense channel only (the serve
window routes dense, as the flat window does) and has no backward: it
runs in serving, under `no_grad`.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build, registry
from repro_torch.kernels.common import check_matmul, sm_count
from repro_torch.kernels.spikemm.ref import (shifted_raster,
                                             spikemm_chain_ref, spikemm_ref,
                                             spikemm_wgrad_chain_ref,
                                             spikemm_wgrad_ref)
from repro_torch.kernels.spikemm.sparse import (SPARSE_TILES,
                                                block_occupancy, occupancy,
                                                spikemm_sparse_cuda,
                                                spikemm_sparse_ref)
from repro_torch.kernels.spikemm.wgrad import (WGRAD_THREADS,
                                               spikemm_wgrad_cuda,
                                               wgrad_chunk, wgrad_groups,
                                               wgrad_tile)

_ENV_SPARSE = "REPRO_SPIKEMM_SPARSE"
_SPARSE_THRESHOLD_DEFAULT = 0.25


def col_tile(N: int) -> int:
    """The column tile of a CTA of `csrc/spikemm.cu` for N columns: the
    least of 8, 16, 32, 64 that covers N, 64 above, so that a narrow
    readout does not leave most lanes idle."""
    return 8 if N <= 8 else 16 if N <= 16 else 32 if N <= 32 else 64


def rows_per_cta(M: int, N: int, n_sm: int) -> int:
    """Rows a CTA of `csrc/spikemm.cu` owns: the largest of 128, 64, 32
    and 16 (32 at the 8-wide column tile) whose grid still holds about a
    wave of CTAs (three quarters of the SM count), else the smallest.
    Larger tiles make the dense loop's loads go further; more CTAs keep the
    card busy where the events are few. (The session family sizes its
    tile from a session's rows instead: `session_tile`.)"""
    cw = col_tile(N)
    sizes = (128, 64, 32) if cw == 8 else (128, 64, 32, 16)
    for bm in sizes:
        if math.ceil(M / bm) * math.ceil(N / cw) * 4 >= 3 * n_sm:
            return bm
    return sizes[-1]


SESSION_COLS = (64, 32, 16, 8)    # `csrc/spikemm_sessions.cu`'s column slabs


def session_tile(T: int, N: int, n_sm: int, sessions: int
                 ) -> Tuple[int, int]:
    """(bm, cw): the tile of a CTA of `csrc/spikemm_sessions.cu` (128
    threads) for `sessions` sessions of T rows each against N columns. bm
    is the least of 8, 16, 32, 64 (16 to 128 at the 8-wide slab) that
    holds a session's T rows, the largest above: no CTA owns rows its
    session does not have, past the tile's rounding. cw is the column
    slab, the least of 8, 16, 32, 64 that covers N, 64 above, halved (down
    to 8) while the grid, sessions x row tiles x column slabs, holds fewer
    CTAs than the card has SMs: each CTA reads its slab of the session's
    weight once, so narrower slabs cost only the raster's rows read again
    (from L2)."""
    if T < 1 or N < 1 or sessions < 1:
        raise ValueError(f"session_tile: T={T}, N={N}, sessions={sessions}")

    def rows(cw):
        least = 16 if cw == 8 else 8
        return min(8 * least, max(least, 1 << (T - 1).bit_length()))
    cw = min(col_tile(N), SESSION_COLS[0])
    while (cw > SESSION_COLS[-1] and sessions * math.ceil(T / rows(cw))
           * math.ceil(N / cw) < n_sm):
        cw //= 2
    return rows(cw), cw


def _fraction(flags: torch.Tensor, total: torch.Tensor) -> float:
    """The occupied share of the blocks `flags` covers, `total` of them:
    one host read of `total` (NaN, the mean of nothing, for no blocks)."""
    n = flags.numel()
    return total.item() / n if n else float("nan")


def occupancy_fraction(spikes: torch.Tensor) -> float:
    """Fraction of spike blocks with events at the sparse kernel's own
    block shape (`occupancy`): the share of its work the kernel does not
    skip. Ragged edges count as zero-padded blocks, as the kernel sees
    them."""
    return _fraction(*occupancy(spikes))


def sparse_threshold() -> float:
    """Occupancy fraction at or below which `auto` routes sparse (the JAX
    package's default; it has no per-shape tuning on the port)."""
    return _SPARSE_THRESHOLD_DEFAULT


def _mode() -> str:
    """`REPRO_SPIKEMM_SPARSE`: never, auto (the default) or always."""
    mode = os.environ.get(_ENV_SPARSE, "auto")
    if mode not in ("never", "auto", "always"):
        raise ValueError(f"{_ENV_SPARSE}={mode!r}: "
                         "expected 'never', 'auto', or 'always'")
    return mode


def _select_channel(spikes: torch.Tensor, w: torch.Tensor, *,
                    traced: bool = False
                    ) -> Tuple[Optional[str], Dict[str, torch.Tensor]]:
    """Dispatch-time router: ("sparse", its kwargs) at or below the
    occupancy threshold, (None, {}) (dense) above it. Under `auto` the
    occupancy is measured once (on the card: its kernel, then one read of
    the count) and the kwargs carry the flags measured to decide."""
    mode = _mode()
    if mode == "never":
        return None, {}
    if mode == "always":
        return "sparse", {}
    if traced:
        return None, {}              # the JAX package's traced raster
    flags, total = occupancy(spikes)
    if _fraction(flags, total) <= sparse_threshold():
        return "sparse", {"flags": flags}
    return None, {}


def spikemm_cuda(spikes: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch `csrc/spikemm.cu` on CUDA tensors: one kernel, nothing
    before it (K = 0 gives zeros from the kernel too)."""
    check_matmul("spikemm", spikes, w)
    M, K = spikes.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=spikes.device)
    if out.numel() == 0:
        return out
    bm = rows_per_cta(M, N, sm_count(spikes.device))
    with torch.cuda.device(spikes.device):
        code = _build.library().spikemm_f32(
            spikes.data_ptr(), w.data_ptr(), out.data_ptr(), M, K, N, bm,
            col_tile(N), torch.cuda.current_stream().cuda_stream)
    _build.check("spikemm", code)
    spikemm_cuda.launches += 1
    return out


def spikemm_g_w(spikes: torch.Tensor, g: torch.Tensor,
                head: Optional[torch.Tensor] = None, *,
                traced: bool = False) -> torch.Tensor:
    """spikemm's weight gradient raster^T @ g, routed (see the module
    docstring): the raster's R = g.shape[0] rows are `head`'s, then
    `spikes`' (`shifted_raster`). Under `always` the sparse channel on the
    transposed raster; else the backward pair, `spikemm_wgrad_cuda` on the
    card, with no occupancy measure and no host read."""
    if _mode() == "always":
        raster = shifted_raster(spikes, g.shape[0], head)
        return registry.dispatch("spikemm", (raster.t().contiguous(), g),
                                 traced=traced)
    return registry.dispatch_bwd("spikemm", (spikes, g), head=head)


class _SpikeMM(torch.autograd.Function):
    """`fwd` forward and `bwd` for g_w: the routed dispatch and
    `spikemm_g_w` (both None), or a channel's implementation and the
    backward pair the parity harness holds against another."""

    @staticmethod
    def forward(ctx, spikes, w, traced, fwd, bwd):
        ctx.save_for_backward(spikes, w)
        ctx.traced, ctx.fwd, ctx.bwd = traced, fwd, bwd
        if fwd is None:
            return registry.dispatch("spikemm", (spikes, w), traced=traced)
        return fwd(spikes, w)

    @staticmethod
    def backward(ctx, g):
        spikes, w = ctx.saved_tensors
        need_s, need_w = ctx.needs_input_grad[:2]
        g_s = (torch.matmul(g, w.t().to(g.dtype)).to(spikes.dtype)
               if need_s else None)
        g_w = None
        if need_w:
            g = g.contiguous()
            g_w = (spikemm_g_w(spikes, g, traced=ctx.traced)
                   if ctx.bwd is None else ctx.bwd(spikes, g)).to(w.dtype)
        return g_s, g_w, None, None, None


def spikemm(spikes: torch.Tensor, w: torch.Tensor, *,
            _traced: bool = False) -> torch.Tensor:
    """Event-gated spikes @ w. spikes: (M, K) 0/1; w: (K, N).

    `_traced=True` routes `auto` dense, as the JAX package routes a traced
    raster (see the module docstring). Differentiable in both."""
    return _SpikeMM.apply(spikes, w, _traced, None, None)


def _vjp(fwd, bwd, spikes, w):
    return _SpikeMM.apply(spikes, w, False, fwd, bwd)


def spikemm_sessions_ref(spikes: torch.Tensor, w: torch.Tensor
                         ) -> torch.Tensor:
    """The session axis' plain version: spikes (T, S, K), w (S, K, N) ->
    (T, S, N), `spikemm_ref` on each session's rows and weight in turn."""
    return torch.stack([spikemm_ref(spikes[:, i].contiguous(), w[i])
                        for i in range(w.shape[0])], dim=1)


def spikemm_sessions_chain_ref(spikes: torch.Tensor, w: torch.Tensor
                               ) -> torch.Tensor:
    """The session axis as the card sums it: `spikemm_chain_ref` (the
    kernel's fmaf chain, bit for bit) on each session in turn."""
    return torch.stack([spikemm_chain_ref(spikes[:, i], w[i])
                        for i in range(w.shape[0])], dim=1)


def spikemm_sessions_cuda(spikes: torch.Tensor, w: torch.Tensor
                          ) -> torch.Tensor:
    """Launch `csrc/spikemm_sessions.cu` on a (T, S, K) raster against S
    weights (S, K, N): one launch, the sessions on the grid's z, the tile
    `session_tile`'s."""
    check_matmul("spikemm_sessions", spikes, w, sessions=True)
    T, S, K = spikes.shape
    N = w.shape[2]
    out = torch.empty((T, S, N), dtype=torch.float32, device=spikes.device)
    if out.numel() == 0:
        return out
    bm, cw = session_tile(T, N, sm_count(spikes.device), S)
    with torch.cuda.device(spikes.device):
        code = _build.library().spikemm_sessions_f32(
            spikes.data_ptr(), w.data_ptr(), out.data_ptr(), T, K, N, S, bm,
            cw, torch.cuda.current_stream().cuda_stream)
    _build.check("spikemm_sessions", code)
    spikemm_sessions_cuda.launches += 1
    return out


def spikemm_sessions(spikes: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Session-batched spikes @ w: spikes (T, S, K) 0/1, w (S, K, N) ->
    (T, S, N), session s's rows against w[s]. Not differentiable: it
    raises where autograd would need a gradient (serve under no_grad)."""
    if torch.is_grad_enabled() and (spikes.requires_grad
                                    or w.requires_grad):
        raise NotImplementedError(
            "spikemm_sessions has no backward (a learning serve window runs "
            "under torch.no_grad())")
    return registry.dispatch("spikemm_sessions", (spikes, w))


def _make_inputs(generator: torch.Generator):
    M, K, N = 100, 300, 200                   # ragged against every block
    spikes = (torch.rand((M, K), generator=generator) < 0.13).float()
    w = torch.randn((K, N), generator=generator)
    return spikes, w


def _make_session_inputs(generator: torch.Generator):
    T, S, K, N = 37, 5, 130, 70               # ragged against every block
    spikes = (torch.rand((T, S, K), generator=generator) < 0.15).float()
    w = torch.randn((S, K, N), generator=generator)
    return spikes, w


# The CTA tiles (`registry.TileModel`). `csrc/spikemm_ring.cuh`'s ring: 3
# stages of a (bm, 32) spike tile, rows padded to 36 floats, and a (32, cw)
# weight tile; `csrc/spikemm.cu` adds its event lists (LIST_ENTRIES (k,
# spike) pairs) and their counts, `csrc/spikemm_sparse.cu` its list of
# 1024 k blocks and a count a warp.
RING_STAGES, RING_DEPTH, RING_ROW = 3, 32, 36
LIST_ENTRIES = 4096
SPARSE_LIST = 1024
_THREADS, _SESSION_THREADS = 256, 128


def _ring(bm: int, cw: int) -> Dict[str, Tuple[int, ...]]:
    return {"a_ring": (RING_STAGES, bm, RING_ROW),
            "b_ring": (RING_STAGES, RING_DEPTH, cw)}


def _dims(spikes, w):
    return {"M": spikes.shape[0], "K": spikes.shape[1], "N": w.shape[1]}


def _plan(dims, n_sm, overrides):
    """The dense channel's tile (`rows_per_cta`, `col_tile`), or with
    `st` pinned to one of `SPARSE_TILES` the sparse channel's (the router
    picks `sparse_tile`'s)."""
    if "st" in overrides:
        if overrides["st"] not in SPARSE_TILES:
            raise ValueError(f"spikemm: sparse tile {overrides['st']} not "
                             f"one of {SPARSE_TILES}")
        return {"st": int(overrides["st"])}
    M, N = dims["M"], dims["N"]
    return {"bm": rows_per_cta(M, N, n_sm), "cw": col_tile(N)}


# the kernels' static shared memory (4-byte words): `spikemm_kernel`'s two
# counters (16 bytes as ptxas lays them out), the sparse product's count a
# warp
_STATIC = {"totals": (4,), "warp_n": (8,)}


def _tiles(dims, blocks):
    if "st" in blocks:
        st = blocks["st"]
        return {**_ring(st, st), "list": (SPARSE_LIST,),
                "warp_n": _STATIC["warp_n"]}
    return {**_ring(blocks["bm"], blocks["cw"]), "events": (LIST_ENTRIES, 2),
            "counts": (blocks["bm"],), "totals": _STATIC["totals"]}


def _launches(dims, blocks):
    M, K, N = dims["M"], dims["K"], dims["N"]
    tiles = _tiles(dims, blocks)
    dynamic = 4 * sum(math.prod(v) for k, v in tiles.items()
                      if k not in _STATIC)
    static = 4 * sum(math.prod(v) for k, v in tiles.items() if k in _STATIC)
    if "st" not in blocks:
        bm, cw = blocks["bm"], blocks["cw"]
        return (registry.Launch("spikemm_kernel",
                                (-(-N // cw), -(-M // bm), 1), _THREADS,
                                dynamic, static),)
    st = blocks["st"]
    bm, bk = _build.SPARSE_BLOCK
    occ = -(-M // bm) * -(-K // bk)
    return ((registry.Launch("spikemm_occupancy_kernel", (occ, 1, 1),
                             _THREADS, 0),) if occ else ()) + (
        registry.Launch("spikemm_sparse_kernel", (-(-N // st), -(-M // st), 1),
                        _THREADS, dynamic, static),)


def _coverage(dims, blocks):
    tm, tn = ((blocks["st"],) * 2 if "st" in blocks
              else (blocks["bm"], blocks["cw"]))
    return registry.tile_cells((dims["M"], tm), (dims["N"], tn))


def _session_dims(spikes, w):
    T, S, K = spikes.shape
    return {"T": T, "S": S, "K": K, "N": w.shape[2]}


def _session_plan(dims, n_sm, overrides):
    bm, cw = session_tile(dims["T"], dims["N"], n_sm, dims["S"])
    return {"sb": 1, "bm": bm, "cw": cw}


def _session_launches(dims, blocks):
    bm, cw = blocks["bm"], blocks["cw"]
    words = sum(math.prod(v) for v in _ring(bm, cw).values())
    return (registry.Launch(
        "spikemm_sessions_kernel",
        (-(-dims["N"] // cw), -(-dims["T"] // bm), dims["S"]),
        _SESSION_THREADS, 4 * words),)


registry.register(registry.KernelSpec(
    name="spikemm_sessions", plain=spikemm_sessions_ref,
    cuda=spikemm_sessions_cuda, make_inputs=_make_session_inputs, tol=1e-4,
    block_axes=(registry.BlockAxis("sb", "S", 1, 1),
                registry.BlockAxis("bm", "T", 128, 8),
                registry.BlockAxis("cw", "N", 64, 8)),
    dims_of=_session_dims, plan=_session_plan,
    # the 8-wide slab's 16 rows, a 64-column slab, a narrowed slab
    candidates=({"T": 1, "S": 1, "N": 8}, {"T": 32, "S": 64, "N": 64},
                {"T": 32, "S": 7, "N": 20}),
    tile_model=registry.TileModel(
        out=(("S", "sb"), ("T", "bm"), ("N", "cw")),
        tiles=lambda dims, blocks: _ring(blocks["bm"], blocks["cw"]),
        launches=_session_launches)))

# `csrc/spikemm_wgrad.cu`'s ring: WGRAD_STAGES steps of each group's
# (rows, bm) raster and (rows, cw) g slabs, padded by 4 floats a row; a step
# is 32 rows with at most two groups a CTA, else 16
WGRAD_STAGES = 4


def _wgrad_dims(spikes, w):
    """The weight gradient's dims for the forward on (spikes, w): the
    raster's R rows, its K columns, g's N."""
    return {"R": spikes.shape[0], "K": spikes.shape[1], "N": w.shape[1]}


def _wgrad_plan(dims, n_sm, overrides):
    bm, cw, cluster = wgrad_tile(dims["K"], dims["N"])
    return {"bm": bm, "cw": cw, "cluster": cluster,
            "chunk": wgrad_chunk(dims["R"], dims["K"], dims["N"])}


def _wgrad_tiles(dims, blocks):
    bm, cw = blocks["bm"], blocks["cw"]
    g = wgrad_groups(bm, cw)
    step = 32 if g <= 2 else 16
    return {"ring": (WGRAD_STAGES, g, step, bm + 4 + cw + 4)}


def _wgrad_launches(dims, blocks):
    bm, cw = blocks["bm"], blocks["cw"]
    words = math.prod(_wgrad_tiles(dims, blocks)["ring"])
    return (registry.Launch(
        "wgrad_kernel", (-(-dims["N"] // cw), -(-dims["K"] // bm),
                         blocks["cluster"]), WGRAD_THREADS, 4 * words),)


registry.register(registry.KernelSpec(
    name="spikemm", plain=spikemm_ref, cuda=spikemm_cuda,
    make_inputs=_make_inputs, tol=1e-4, diff_argnums=(0, 1), vjp=_vjp,
    bwd=registry.Channel(plain=spikemm_wgrad_ref, cuda=spikemm_wgrad_cuda),
    bwd_name="spikemm_wgrad",
    channels={"sparse": registry.Channel(plain=spikemm_sparse_ref,
                                         cuda=spikemm_sparse_cuda)},
    select_channel=_select_channel,
    block_axes=(registry.BlockAxis("bm", "M", 128, 16),
                registry.BlockAxis("cw", "N", 64, 8),
                registry.BlockAxis("st", "M", 64, 16)),
    dims_of=_dims, plan=_plan,
    # the dense channel at the 8-wide column tile and at the largest row
    # tile; the sparse channel at each of its tiles
    candidates=({"M": 2048, "K": 700, "N": 8}, {"M": 8192, "N": 512},
                {"st": 64}, {"st": 16}),
    tile_model=registry.TileModel(
        out=(("M", "bm"), ("N", "cw")), tiles=_tiles, launches=_launches,
        coverage=_coverage),
    bwd_tiles=registry.KernelSpec(
        name="spikemm_wgrad", plain=spikemm_wgrad_ref,
        cuda=spikemm_wgrad_cuda, make_inputs=_make_inputs,
        dims_of=_wgrad_dims, plan=_wgrad_plan,
        block_axes=(registry.BlockAxis("bm", "K", 64, 8),
                    registry.BlockAxis("cw", "N", 128, 8)),
        # the SHD window's hidden g_w (the event tile) and its readout's, a
        # small dense tile, and the ECG input's
        candidates=({"R": 2048, "K": 700, "N": 256},
                    {"R": 2048, "K": 64, "N": 20},
                    {"R": 6400, "K": 4, "N": 64}),
        tile_model=registry.TileModel(out=(("K", "bm"), ("N", "cw")),
                                      tiles=_wgrad_tiles,
                                      launches=_wgrad_launches))))

__all__ = ["spikemm", "spikemm_cuda", "spikemm_ref", "spikemm_chain_ref",
           "spikemm_g_w", "spikemm_wgrad_cuda", "spikemm_wgrad_ref",
           "spikemm_wgrad_chain_ref", "wgrad_chunk",
           "block_occupancy", "col_tile", "rows_per_cta", "session_tile",
           "occupancy_fraction", "sparse_threshold", "spikemm_sparse_cuda",
           "spikemm_sparse_ref", "spikemm_sessions", "spikemm_sessions_cuda",
           "spikemm_sessions_ref", "spikemm_sessions_chain_ref"]
