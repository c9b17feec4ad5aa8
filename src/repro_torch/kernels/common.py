"""Shared kernel utilities: device resolution, argument checks, padding.

`resolve_device` is the port's one rule for where work runs: the entry
points default to the card, run on the CPU only when the caller asks for
it, and raise when the card is asked for and there is none. Nothing in
the package continues on the CPU behind the caller's back.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, registry

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """`device` as a torch.device; raises for a CUDA device when there is
    no usable card (pass device="cpu" to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def check_device(what: str, t: torch.Tensor, device: torch.device) -> None:
    """Raise unless tensor `t` lies on `device` (index-insensitive for a
    bare "cuda")."""
    if t.device.type != device.type or (
            device.index is not None and t.device.index != device.index):
        raise ValueError(f"{what} lies on {t.device}, expected {device}")


def check_scan(name: str, current: torch.Tensor,
               w_rec: Optional[torch.Tensor], per_neuron: Sequence,
               per_lane: Sequence) -> None:
    """The checks of a time-scan kernel's wrapper: CUDA tensors, a
    (T, B, N) current, an (N, N) `w_rec` unless None, (N,) per-neuron and
    (B, N) per-lane tensors given as (name, tensor) pairs, all float32,
    contiguous and on the current's device."""
    if not current.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"{current.device}")
    if current.dim() != 3:
        raise ValueError(f"{name}: current {tuple(current.shape)} must be "
                         "(T, B, N)")
    T, B, N = current.shape
    args = [("current", current, (T, B, N))]
    if w_rec is not None:
        args.append(("w_rec", w_rec, (N, N)))
    args += [(nm, t, (N,)) for nm, t in per_neuron]
    args += [(nm, t, (B, N)) for nm, t in per_lane]
    for nm, t, want in args:
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {nm} {tuple(t.shape)} must be {want} "
                             f"for current {tuple(current.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {nm} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")
        if t.device != current.device:
            raise ValueError(f"{name}: {nm} on {t.device}, current on "
                             f"{current.device}")


def check_planes(name: str, like: torch.Tensor, planes: Sequence) -> None:
    """Each (name, tensor) of `planes` has `like`'s shape, dtype and
    device, and is contiguous (a backward kernel's saved outputs and
    cotangents)."""
    for nm, t in planes:
        if (t.shape != like.shape or t.dtype != like.dtype
                or t.device != like.device):
            raise ValueError(f"{name}: {nm} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device} must match {tuple(like.shape)} "
                             f"{like.dtype} on {like.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")


def check_raster(name: str, spikes: torch.Tensor,
                 sessions: bool = False) -> None:
    """The checks of a raster-only wrapper: a contiguous float32 (M, K)
    raster on a CUDA device, (T, S, K) with `sessions`."""
    if not spikes.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"{spikes.device}")
    if spikes.dim() != 2 + sessions:
        raise ValueError(f"{name}: a raster is "
                         f"{'(T, S, K)' if sessions else '(M, K)'}, got "
                         f"{tuple(spikes.shape)}")
    if spikes.dtype != torch.float32:
        raise TypeError(f"{name}: spikes must be float32, got {spikes.dtype}")
    if not spikes.is_contiguous():
        raise ValueError(f"{name}: spikes must be contiguous")


def check_matmul(name: str, spikes: torch.Tensor, w: torch.Tensor,
                 sessions: bool = False) -> None:
    """The checks of a spike-matmul wrapper: a raster as `check_raster`
    takes it and a (K, N) float32 contiguous weight on its device; with
    `sessions`, a (T, S, K) raster and S weights (S, K, N)."""
    check_raster(name, spikes, sessions)
    chain = (spikes.shape[1:] == w.shape[:2] if sessions
             else spikes.shape[1] == w.shape[0])
    if w.dim() != spikes.dim() or not chain:
        raise ValueError(f"{name}: shapes {tuple(spikes.shape)} @ "
                         f"{tuple(w.shape)} do not chain")
    if w.dtype != torch.float32:
        raise TypeError(f"{name}: w must be float32, got {w.dtype}")
    if not w.is_contiguous():
        raise ValueError(f"{name}: w must be contiguous")
    if spikes.device != w.device:
        raise ValueError(f"{name}: spikes on {spikes.device}, "
                         f"w on {w.device}")


_SM_COUNT = {}


def sm_count(device: torch.device) -> int:
    """The card's multiprocessor count, read once per device."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def plan_sms(device: Optional[torch.device] = None) -> int:
    """The SM count a tile plan reads: the card's (`device`, or the current
    one), or `_build.SM90_SMS` where there is no card (the static checks
    plan launches on the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            return _build.SM90_SMS
        device = torch.device("cuda", torch.cuda.current_device())
    return sm_count(device)


_SMEM_BUDGET: Dict[int, int] = {}


def smem_budget(device: Optional[torch.device] = None) -> int:
    """The shared memory a CTA may opt into on `device` (the current card):
    its `shared_memory_per_block_optin` where PyTorch reports it, read once
    a card, else `_build.SM90_SMEM_OPTIN` (also where there is no card)."""
    if not torch.cuda.is_available():
        return _build.SM90_SMEM_OPTIN
    idx = (torch.cuda.current_device() if device is None
           or device.index is None else device.index)
    if idx not in _SMEM_BUDGET:
        props = torch.cuda.get_device_properties(idx)
        _SMEM_BUDGET[idx] = int(getattr(props, "shared_memory_per_block_optin",
                                        _build.SM90_SMEM_OPTIN))
    return _SMEM_BUDGET[idx]


MAX_WARPS = 4              # warps a CTA of a lane scan, at most


def lane_plan(lanes: int, T: int, n_sm: int):
    """(warps a CTA, CTAs, stages of the staging ring) of a lane scan
    (`csrc/lane_scan.cuh`: `linrec`, `lif`, `alif`) over `lanes` lanes of
    T steps on a card of `n_sm` SMs.

    A warp owns 32 adjacent lanes. CTAs take the fewest warps (1, 2 or 4)
    that keep their count within one a SM, so a few thousand lanes spread
    over as many SMs as they have warps and 16384 over all 132; past 4
    warps a CTA the grid grows. The ring holds LANE_SCAN_STAGES chunks of
    LANE_SCAN_CHUNK steps, or as many chunks as T has where that is fewer
    (the kernels refuse any other count)."""
    warps = -(-lanes // 32)
    per_cta = 1
    while per_cta < MAX_WARPS and -(-warps // per_cta) > n_sm:
        per_cta *= 2
    chunks = -(-T // _build.LANE_SCAN_CHUNK)
    return (per_cta, -(-lanes // (32 * per_cta)),
            min(_build.LANE_SCAN_STAGES, chunks))


def lane_tiles(kernel: str, current: int = 0,
               planes_of=None) -> Dict[str, Any]:
    """The CTA tile declarations (`registry.KernelSpec` fields) of a lane
    scan's family: `kernel` names its CUDA kernel (`linrec_kernel`,
    `lif_kernel`, `alif_kernel`), `current` the argument whose (T, B, N)
    shape the call scans, `planes_of(*args)` the planes its ring stages (1
    without it). A CTA owns `lb` = 32 x warps adjacent lanes for
    all T steps (the time axis chains inside it: an exact axis), its ring
    `stages` x planes x LANE_SCAN_CHUNK steps of each lane; `lane_plan`
    picks warps and stages. The candidates reach each CTA width (1, 2 and
    4 warps at the served shapes' lanes and above) and a ring of fewer
    stages than LANE_SCAN_STAGES."""

    def dims_of(*args, **static):
        T, B, N = args[current].shape
        return {"T": T, "B": B, "N": N, "L": B * N,
                "P": 1 if planes_of is None else planes_of(*args)}

    def plan(dims, n_sm, overrides):
        warps, _, stages = lane_plan(dims["L"], dims["T"], n_sm)
        return {"lb": 32 * warps, "bt": dims["T"], "stages": stages}

    def tiles(dims, blocks):
        return {"ring": (blocks["stages"], dims["P"], _build.LANE_SCAN_CHUNK,
                         blocks["lb"])}

    def launches(dims, blocks):
        words = math.prod(tiles(dims, blocks)["ring"])
        return (registry.Launch(kernel, (-(-dims["L"] // blocks["lb"]), 1, 1),
                                blocks["lb"], 4 * words),)

    return dict(
        block_axes=(registry.BlockAxis("lb", "L", 32 * MAX_WARPS, 32),
                    registry.BlockAxis("bt", "T", 1, 1, exact=True)),
        dims_of=dims_of, plan=plan,
        candidates=({"T": 32, "B": 64, "N": 64, "L": 4096},
                    {"T": 32, "B": 64, "N": 130, "L": 8320},
                    {"T": 300, "B": 64, "N": 300, "L": 19200},
                    {"T": 1, "B": 1, "N": 6, "L": 6}),
        tile_model=registry.TileModel(out=(("L", "lb"), ("T", "bt")),
                                      tiles=tiles, launches=launches))


# `csrc/lane_bwd.cuh` (`lif_bwd`, `alif_bwd`): a CTA of a chain warp and
# three helpers owns 32 lanes; each holds LANE_BWD_PLANES planes of a
# segment of `_build.LANE_BWD_SEG` steps in shared memory
LANE_BWD_THREADS = 128
LANE_BWD_PLANES = 5


def lane_bwd_plan(lanes: int, T: int) -> Tuple[int, int, int]:
    """(CTAs, threads a CTA, segments) of a lane backward kernel over
    `lanes` lanes of T steps: a CTA a 32-lane group; a call of more than
    one segment keeps a checkpoint a segment (the wrappers size that
    scratch from it)."""
    return -(-lanes // 32), LANE_BWD_THREADS, -(-T // _build.LANE_BWD_SEG)


def lane_bwd_tiles(kernel: str) -> Dict[str, Any]:
    """The tile declarations of a lane backward kernel (`lif_bwd_kernel`,
    `alif_bwd_kernel`), over its forward's dims (`lane_tiles`' dims_of):
    `lane_bwd_plan`'s CTAs, the segment's planes in dynamic shared memory
    and the kernel's static flag (`last`, at most 16 bytes)."""

    def plan(dims, n_sm, overrides):
        _, _, segs = lane_bwd_plan(dims["L"], dims["T"])
        return {"lb": 32, "bt": dims["T"], "segments": segs}

    def tiles(dims, blocks):
        return {"planes": (LANE_BWD_PLANES, _build.LANE_BWD_SEG, 32),
                "last": (4,)}

    def launches(dims, blocks):
        ctas, threads, _ = lane_bwd_plan(dims["L"], dims["T"])
        return (registry.Launch(
            kernel, (ctas, 1, 1), threads,
            4 * LANE_BWD_PLANES * _build.LANE_BWD_SEG * 32, 16),)

    return dict(
        block_axes=(registry.BlockAxis("lb", "L", 32, 32),
                    registry.BlockAxis("bt", "T", 1, 1, exact=True)),
        plan=plan,
        candidates=({"T": 32, "B": 64, "N": 64, "L": 4096},
                    {"T": 250, "B": 64, "N": 64, "L": 4096},
                    {"T": 1, "B": 1, "N": 6, "L": 6}),
        tile_model=registry.TileModel(out=(("L", "lb"), ("T", "bt")),
                                      tiles=tiles, launches=launches))


# the routes of the recurrent scan (`csrc/rec_scan.cuh`)
REC_WARP, REC_BLOCK = "warp", "block"
REC_WARP_MAX_N = 32 * _build.REC_LANE_NEURONS
REC_ROWS = 4               # batch rows a block of the warp route: a warp each
REC_THREADS = 1024         # most threads a block of the block route
REC_STAGE_STEPS = 16       # steps of current a warp-route stage holds
REC_BWD_ROW_THREADS = 256  # threads a block of the backward's warp route
_REC_ROUTE_LAUNCHES = {k: {REC_WARP: 0, REC_BLOCK: 0}
                       for k in ("lifrec", "alifrec", "lifrec_bwd",
                                 "alifrec_bwd")}


def rec_route(n: int) -> str:
    """The route of the recurrent kernels (`lifrec`, `alifrec` and their
    backward `lifrec_bwd`, `alifrec_bwd`) for rows of n neurons: a warp a
    batch row up to REC_WARP_MAX_N, a block a row above."""
    return REC_WARP if n <= REC_WARP_MAX_N else REC_BLOCK


class RecPlan(NamedTuple):
    """The launch of the recurrent scan (`csrc/rec_scan.cuh`) that
    `rec_plan` chose: its route, `unit` neurons a lane (warp route) or a
    thread (block route), whether W_rec sits in shared memory, and the
    grid, threads a block and dynamic shared memory that follow."""

    route: str
    unit: int
    w_smem: bool
    grid: int
    threads: int
    smem: int


def rec_plan(n: int, batch: int, budget: int,
             route: Optional[str] = None,
             backward: bool = False) -> RecPlan:
    """The launch of the recurrent scan (or, with `backward`, of its
    backward `csrc/rec_bwd.cu`) for `batch` rows of n neurons on a card
    whose CTAs may opt into `budget` bytes of shared memory
    (`smem_budget`). The C entry points launch exactly this plan and
    refuse any other; `route` asks for the block route's plan at any width
    (which `w_in_smem` reads).

    The forward's warp route (n <= REC_WARP_MAX_N): a warp a row, REC_ROWS
    rows a block, the least power-of-two neurons a lane that covers the
    row, W_rec, two stages of REC_STAGE_STEPS steps and two event lists a
    warp in shared memory. The backward's warp route: a block of
    REC_BWD_ROW_THREADS threads a row, `unit` = KP chain threads (the
    least multiple of 32 that covers the row) and the rest helpers, the
    two Gu buffers, a chunk's spike words, two staged chunks of five
    planes, two output planes and W in shared memory (chunks of 32 steps,
    16 above 64 neurons). The block route of both: a block a row, two
    spike masks (and the backward's two Gu rows) in shared memory, and
    W_rec beside them where all fit the budget (one neuron a thread); else
    W_rec read through L2 and the least power-of-two neurons a thread
    whose REC_THREADS threads cover the row."""
    if n < 1 or batch < 1:
        raise ValueError(f"rec_plan: n={n}, batch={batch}")
    if (route or rec_route(n)) == REC_WARP:
        if backward:
            kp = -(-n // 32) * 32
            tc = 32 if kp <= 64 else 16
            words = 2 * kp + tc * (kp // 32) + 12 * tc * kp + n * n
            return RecPlan(REC_WARP, kp, True, batch, REC_BWD_ROW_THREADS,
                           4 * words)
        unit = 1
        while 32 * unit < n:
            unit *= 2
        rows = min(batch, REC_ROWS)
        stage = -(-n // 4) * 4
        words = (-(-n * n // 4) * 4
                 + rows * 2 * (REC_STAGE_STEPS * stage + REC_WARP_MAX_N + 4))
        return RecPlan(REC_WARP, unit, True, -(-batch // rows), 32 * rows,
                       4 * words)
    masks = 2 * 4 * -(-n // 32) + (2 * 4 * n if backward else 0)
    with_w = masks + 4 * n * n
    if with_w <= budget and n <= REC_THREADS:
        return RecPlan(REC_BLOCK, 1, True, batch, -(-n // 32) * 32, with_w)
    unit = 1
    while unit * REC_THREADS < n:
        unit *= 2
    if unit > 256:
        raise ValueError(f"rec_plan: rows of {n} neurons exceed the block "
                         "route")
    per = -(-n // unit)
    return RecPlan(REC_BLOCK, unit, False, batch, -(-per // 32) * 32, masks)


def rec_tiles(backward: bool = False) -> Dict[str, Any]:
    """The CTA tile declarations (`registry.KernelSpec` fields) of the
    recurrent scans (`lifrec`, `alifrec`) or, with `backward`, of their
    backward (`csrc/rec_bwd.cu`): `rec_plan`'s launch. The forward's warp
    route's CTA owns `rows` batch rows (a warp each), the backward's warp
    route and both block routes one; each holds a row's N neurons whole
    and chains all T steps (an exact axis). The candidates reach the warp
    route, the block route with W_rec in shared memory, through L2, and
    two neurons a thread."""
    kernel_warp, kernel_block = (("rec_bwd_row_kernel", "rec_bwd_block_kernel")
                                 if backward else
                                 ("rec_warp_kernel", "rec_scan_kernel"))

    def dims_of(current, *args, **static):
        T, B, N = current.shape
        return {"T": T, "B": B, "N": N}

    def plan(dims, n_sm, overrides):
        p = rec_plan(dims["N"], dims["B"], smem_budget(), backward=backward)
        return {"rows": -(-dims["B"] // p.grid), "bt": dims["T"],
                "unit": p.unit, "warp": int(p.route == REC_WARP),
                "w_smem": int(p.w_smem)}

    def tiles(dims, blocks):
        N, rows, kp = dims["N"], blocks["rows"], blocks["unit"]
        if blocks["warp"] and backward:
            tc = 32 if kp <= 64 else 16
            return {"gu": (2, kp), "spike_words": (tc, kp // 32),
                    "stages": (2, 5, tc, kp), "outputs": (2, tc, kp),
                    "w_rec": (N, N)}
        if blocks["warp"]:
            stage = -(-N // 4) * 4
            return {"w_rec": (-(-N * N // 4) * 4,),
                    "stages": (rows, 2, REC_STAGE_STEPS, stage),
                    "lists": (rows, 2, REC_WARP_MAX_N + 4)}
        out = {"masks": (2, -(-N // 32))}
        if backward:
            out["gu"] = (2, N)
        if blocks["w_smem"]:
            out["w_rec"] = (N, N)
        return out

    def launches(dims, blocks):
        p = rec_plan(dims["N"], dims["B"], smem_budget(), backward=backward)
        return (registry.Launch(kernel_warp if blocks["warp"] else
                                kernel_block, (p.grid, 1, 1), p.threads,
                                p.smem),)

    return dict(
        block_axes=(registry.BlockAxis("rows", "B", REC_ROWS, 1),
                    registry.BlockAxis("bt", "T", 1, 1, exact=True)),
        dims_of=dims_of, plan=plan,
        candidates=({"T": 32, "B": 64, "N": 64}, {"N": 200}, {"N": 300},
                    {"T": 37, "B": 3, "N": 2048}),
        tile_model=registry.TileModel(
            out=(("B", "rows"), ("N", None), ("T", "bt")), tiles=tiles,
            launches=launches))


def rec_route_launch_counts() -> Dict[str, Dict[str, int]]:
    """{kernel: {route: launches}} since import. Each launch also counts on
    the kernel's registry counter; `registry.reset_launches` leaves these as
    they are, so compare two readings."""
    return {k: dict(v) for k, v in _REC_ROUTE_LAUNCHES.items()}


def count_rec_launch(kernel: str, route: str) -> None:
    _REC_ROUTE_LAUNCHES[kernel][route] += 1


def w_in_smem(n: int, backward: bool = False) -> bool:
    """Whether the recurrent kernels' block route (with `backward`, their
    backward's, which also holds two rows of Gu) keeps an (n, n) W_rec in
    shared memory on the current device; else it reads W_rec through L2.
    (The warp route always holds it in shared memory.) `rec_plan`'s
    choice."""
    return rec_plan(n, 1, smem_budget(), route=REC_BLOCK,
                    backward=backward).w_smem


# zeroed int32 counters for each (device, stream): a kernel whose last CTA
# to finish combines the others' partials (`spikemm_wgrad`, `alif_bwd`, `lif_bwd`)
# counts its CTAs on them and sets them back to 0 before it ends, so the
# kernels of one stream, which run one after another, share them
_COUNTERS: Dict[Tuple[Optional[int], int], torch.Tensor] = {}


def zeroed_counters(device: torch.device, stream: int,
                    n: int) -> torch.Tensor:
    """At least n int32 counters at 0 on `device` for kernels launched on
    `stream`; allocated (and zeroed) once, grown for a larger n."""
    key = (device.index, stream)
    have = _COUNTERS.get(key)
    if have is None or have.numel() < n:
        have = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[key] = have
    return have


def optional_ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's data pointer, or None (a null pointer for the C entry
    points) for an output that is not asked for."""
    return None if t is None else t.data_ptr()


def tree_to(tree: Any, device: DeviceLike) -> Any:
    """A nested dict of tensors (None leaves allowed) moved to `device`."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def pad_axis(x: torch.Tensor, axis: int, mult: int, value=0.0):
    """Pad `axis` of x up to a multiple of `mult`. Returns (padded, orig_len)."""
    n = x.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return x, n
    axis = axis % x.dim()
    widths = [0, 0] * (x.dim() - axis - 1) + [0, pad]
    return F.pad(x, widths, value=value), n


__all__ = ["resolve_device", "check_device", "check_scan", "check_planes",
           "check_raster",
           "check_matmul", "sm_count", "plan_sms", "smem_budget",
           "MAX_WARPS", "lane_plan", "lane_tiles", "lane_bwd_plan", "lane_bwd_tiles",
           "LANE_BWD_THREADS", "LANE_BWD_PLANES", "rec_route", "rec_plan",
           "rec_tiles", "RecPlan",
           "rec_route_launch_counts", "REC_WARP", "REC_BLOCK",
           "REC_WARP_MAX_N", "w_in_smem", "zeroed_counters", "optional_ptr",
           "tree_to",
           "pad_axis",
           "DeviceLike"]
