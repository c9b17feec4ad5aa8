"""Shared kernel utilities: device resolution, argument checks, padding.

`resolve_device` is the port's one rule for where work runs: the entry
points default to the card, run on the CPU only when the caller asks for
it, and raise when the card is asked for and there is none. Nothing in
the package continues on the CPU behind the caller's back.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

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


# the routes of the recurrent scan (`csrc/rec_scan.cuh`)
REC_WARP, REC_BLOCK = "warp", "block"
REC_WARP_MAX_N = 32 * _build.REC_LANE_NEURONS
_REC_ROUTE_LAUNCHES = {k: {REC_WARP: 0, REC_BLOCK: 0}
                       for k in ("lifrec", "alifrec", "lifrec_bwd",
                                 "alifrec_bwd")}


def rec_route(n: int) -> str:
    """The route of the recurrent kernels (`lifrec`, `alifrec` and their
    backward `lifrec_bwd`, `alifrec_bwd`) for rows of n neurons: a warp a
    batch row up to REC_WARP_MAX_N, a block a row above."""
    return REC_WARP if n <= REC_WARP_MAX_N else REC_BLOCK


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
    (The warp route always holds it in shared memory.)"""
    lib = _build.library()
    code = (lib.rec_bwd_w_in_smem if backward else lib.rec_scan_w_in_smem)(n)
    _build.check("rec_scan", max(-code, 0))
    return bool(code)


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
           "check_matmul", "sm_count", "MAX_WARPS", "lane_plan", "rec_route",
           "rec_route_launch_counts", "REC_WARP", "REC_BLOCK",
           "REC_WARP_MAX_N", "w_in_smem", "zeroed_counters", "optional_ptr",
           "tree_to",
           "pad_axis",
           "DeviceLike"]
