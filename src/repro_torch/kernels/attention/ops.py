"""Flash attention public entry: registry dispatch, route and split
planning, and a straight-through VJP.

`flash_attention(q, k, v, causal=, window=)` takes q (BH, T, d) and k, v
(BH, S, d) with heads folded into the batch. CUDA tensors launch
`csrc/flash_attention.cu` (fp32 or bf16, 1 <= d <= 256), CPU tensors run
the plain version `attention_ref`. The kernel file has two routes, and
`plan_call` picks one per call from the shapes, the dtype and the card's
SM count alone (no environment variable, no fallback: a route that fails
to build or launch raises):

  * **tensor cores** (`flash_fwd_tc`) for bf16 with d = 64 or 128 (the
    configs' head widths) and S >= 1: wgmma on TMA-fed shared memory. When
    its grid, BH * ceil(T / 128) CTAs, is under about twice the SM count,
    `plan_split` cuts each q tile's KV range into `nsplit` whole-tile
    chunks; the kernel then writes partial results to scratch and a second
    kernel (`flash_combine`) merges them in fixed split order. Such a call
    launches two kernels and counts two launches.
  * **CUDA cores** (`flash_fwd`) for fp32 and for bf16 at any other d.

`attention_split_ref` (in `ref.py`) is the plain version of the split:
the same per-split partial results, merged as the combine kernel merges
them. `route_launch_counts()` says which kernels a run launched.

The kernel is forward-only, as the JAX package's is: `_FlashST` launches
it in its forward and, in its backward, differentiates the plain version,
a straight-through gradient that is exact because the forward equals it.
A backward hand kernel is the training slice's work.

The JAX entry's `bq`, `bk` and `force_pallas` are not ported: the first
two are VMEM block choices of the TPU kernel, the third a switch of its
dispatch chain, and the port dispatches by tensor device alone. Its
wrapper also zero-pads K/V up to the block, which lets padded keys into
the softmax of causal rows t >= S; the CUDA kernel masks ragged edges
itself and pads nothing.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch

from repro_torch.kernels import _build, registry
from repro_torch.kernels.attention.ref import (attention_ref,
                                               attention_split_ref)
from repro_torch.kernels.common import sm_count

MAX_HEAD_DIM = 256          # the largest d `csrc/flash_attention.cu` takes
_TYPES = (torch.float32, torch.bfloat16)
# the tensor-core route's tiles (TC_BQ, TC_BK in csrc/flash_attention.cu)
TC_BLOCK_Q = TC_BLOCK_K = 128
TC_HEAD_DIMS = (64, 128)
# the CUDA-core route's head-dim tiles (its DMAX instantiations) and its
# q rows a CTA (BQ in csrc/flash_attention.cu)
HEAD_TILES = (16, 32, 64, 128, 256)
CC_BLOCK_Q = 64
# split over KV while the grid is under this many CTAs per SM, into at
# most this many chunks (bounds the scratch: nsplit * BH * T * d fp32)
SPLIT_CTAS_PER_SM = 2
MAX_SPLITS = 128
TENSOR_CORES, CUDA_CORES, COMBINE = "tensor_cores", "cuda_cores", "combine"


class AttentionPlan(NamedTuple):
    route: str                 # TENSOR_CORES or CUDA_CORES
    nsplit: int                # KV chunks per q tile (1: no split)


def pick_route(dtype: torch.dtype, d: int, S: int = 1) -> str:
    """The kernel route for inputs of this dtype and head dim: the tensor
    cores for bf16 at d = 64 or 128 (with at least one key), else the CUDA
    cores."""
    if dtype == torch.bfloat16 and d in TC_HEAD_DIMS and S >= 1:
        return TENSOR_CORES
    return CUDA_CORES


def plan_split(BH: int, T: int, S: int, n_sm: int) -> int:
    """Whole-tile KV chunks per q tile for the tensor-core route: 1 when
    its BH * ceil(T / 128) CTAs reach SPLIT_CTAS_PER_SM per SM, else enough
    chunks to get there, at most one per KV tile and MAX_SPLITS."""
    ctas = BH * math.ceil(T / TC_BLOCK_Q)
    want = SPLIT_CTAS_PER_SM * n_sm
    if ctas == 0 or ctas >= want:
        return 1
    return max(1, min(math.ceil(want / ctas), math.ceil(S / TC_BLOCK_K),
                      MAX_SPLITS))


def plan_call(BH: int, T: int, S: int, d: int, dtype: torch.dtype,
              n_sm: int) -> AttentionPlan:
    """The route and split of one call: a pure function of the shapes,
    the dtype and the card's SM count."""
    route = pick_route(dtype, d, S)
    return AttentionPlan(route, plan_split(BH, T, S, n_sm)
                         if route == TENSOR_CORES else 1)


def head_tile(d: int) -> int:
    """The CUDA-core route's head-dim tile for head dim d: the least of
    HEAD_TILES that holds d. The wrapper hands it to the C entry point,
    which launches that instantiation and refuses any other."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_tile: head dim {d} outside 1..{MAX_HEAD_DIM}")
    return next(t for t in HEAD_TILES if d <= t)


_ROUTE_LAUNCHES = {TENSOR_CORES: 0, CUDA_CORES: 0, COMBINE: 0}


def route_launch_counts() -> Dict[str, int]:
    """{kernel: launches} since import: the tensor-core kernel, the
    CUDA-core kernel and the split's combine kernel. Each launch also
    counts on the registry's `attention` counter; `registry.reset_launches`
    leaves these as they are, so compare two readings."""
    return dict(_ROUTE_LAUNCHES)


def _count(kernel: str) -> None:
    _ROUTE_LAUNCHES[kernel] += 1
    flash_attention_cuda.launches += 1


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> None:
    """The wrapper's refusals: shapes that do not chain, head dims past
    MAX_HEAD_DIM, other dtypes, non-contiguous or CPU tensors, tensors on
    two devices, sizes past int32."""
    if q.dim() != 3 or k.dim() != 3 or tuple(k.shape) != tuple(v.shape) \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not "
                         "chain: q (BH, T, d), k and v (BH, S, d)")
    BH, T, d = q.shape
    S = k.shape[1]
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {d} outside 1.."
                         f"{MAX_HEAD_DIM}")
    for nm, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.dtype not in _TYPES:
            raise TypeError(f"flash_attention: q, k and v must share one "
                            f"dtype of {_TYPES}, got {nm} {t.dtype} "
                            f"(q {q.dtype})")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {nm} must be contiguous")
    if not q.is_cuda:
        raise ValueError(f"flash_attention: the CUDA kernel takes CUDA "
                         f"tensors, got {q.device}")
    for nm, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {nm} on {t.device}, q on "
                             f"{q.device}")
    if max(BH, T, S, abs(int(window))) >= 2 ** 31:
        raise ValueError(f"flash_attention: (BH, T, S, window) = "
                         f"{(BH, T, S, window)} exceeds the kernel's int32 "
                         "sizes")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int) -> torch.Tensor:
    """Check the arguments and launch the planned route on PyTorch's
    current stream; counts each launch on `flash_attention_cuda` (two for
    a split: the kernel and the combine)."""
    _check(q, k, v, window)
    BH, T, d = q.shape
    S = k.shape[1]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    plan = plan_call(BH, T, S, d, q.dtype, sm_count(q.device))
    lib = _build.library()
    scale = float(d ** -0.5)
    if plan.route == CUDA_CORES:
        fn = (lib.flash_attention_f32 if q.dtype == torch.float32
              else lib.flash_attention_bf16)
        with torch.cuda.device(q.device):
            code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), BH, T, S, d, int(bool(causal)),
                      int(window), scale, head_tile(d),
                      torch.cuda.current_stream().cuda_stream)
        _build.check("flash_attention", code)
        _count(CUDA_CORES)
        return out
    for nm, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {nm} must be 16-byte "
                             "aligned for the tensor-core route (TMA)")
    part = ml = None
    if plan.nsplit > 1:
        part = torch.empty((plan.nsplit, BH, T, d), dtype=torch.float32,
                           device=q.device)
        ml = torch.empty((plan.nsplit, BH, T, 2), dtype=torch.float32,
                         device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.flash_attention_bf16_tc(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(),
            None if ml is None else ml.data_ptr(), BH, T, S, d,
            int(bool(causal)), int(window), scale, plan.nsplit, stream)
        _build.check("flash_attention", code)
        _count(TENSOR_CORES)
        if part is not None:
            code = lib.flash_attention_combine_bf16(
                part.data_ptr(), ml.data_ptr(), out.data_ptr(), BH * T, d,
                plan.nsplit, stream)
            _build.check("flash_attention (combine)", code)
            _count(COMBINE)
    return out


class _FlashST(torch.autograd.Function):
    """The kernel forward with the plain version's VJP."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _launch(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            args = [t.detach().requires_grad_(n)
                    for t, n in zip(ctx.saved_tensors, need)]
            out = attention_ref(*args, causal=ctx.causal, window=ctx.window)
            wrt = [a for a, n in zip(args, need) if n]
            grads = iter(torch.autograd.grad(out, wrt, g))
        return (*(next(grads) if n else None for n in need), None, None)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0
                         ) -> torch.Tensor:
    """Launch `csrc/flash_attention.cu` on CUDA tensors (differentiable
    through `_FlashST`)."""
    return _FlashST.apply(q, k, v, causal, window)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (BH, T, d); k, v: (BH, S, d) — heads pre-folded into batch."""
    return registry.dispatch("attention", (q, k, v), causal=causal,
                             window=window)


def _make_inputs(generator: torch.Generator):
    BH, T, d = 2, 160, 64      # as the JAX family's: T not a multiple of 128
    q, k, v = (torch.randn((BH, T, d), generator=generator)
               for _ in range(3))
    return q, k, v


# The routes' shared memory (`csrc/flash_attention.cu`). CUDA cores: Q
# transposed (dt x (BQ + 4)), a KV tile (BK x (dt + 1)) and P transposed
# (BK x (BQ + 4)) floats, at BQ = BK = CC_BLOCK_Q. Tensor cores: the
# 1024-byte aligned Q tile and a ring of 3 K/V tile pairs (2 at d = 128)
# in bf16, and 8-byte mbarriers (one for Q, three a stage).
CC_THREADS, TC_THREADS, COMBINE_THREADS, COMBINE_ROWS = 256, 288, 256, 8


def _tc_stages(d: int) -> int:
    return 2 if d == 128 else 3


def _dims(q, k, v, **static):
    BH, T, d = q.shape
    return {"BH": BH, "T": T, "S": k.shape[1], "d": d,
            "bf16": int(q.dtype == torch.bfloat16)}


def _plan(dims, n_sm, overrides):
    """`plan_call`'s route and split, and the route's tiles: q rows a CTA
    and (CUDA cores) `head_tile`'s head-dim tile."""
    dtype = torch.bfloat16 if dims["bf16"] else torch.float32
    plan = plan_call(dims["BH"], dims["T"], dims["S"], dims["d"], dtype, n_sm)
    if plan.route == TENSOR_CORES:
        return {"bq": TC_BLOCK_Q, "dt": dims["d"], "nsplit": plan.nsplit,
                "tc": 1}
    return {"bq": CC_BLOCK_Q, "dt": head_tile(dims["d"]), "nsplit": 1,
            "tc": 0}


def _tiles(dims, blocks):
    dt, bq = blocks["dt"], blocks["bq"]
    if not blocks["tc"]:
        return {"q": (dt, bq + 4), "kv": (CC_BLOCK_Q, dt + 1),
                "p": (CC_BLOCK_Q, bq + 4)}
    nst = _tc_stages(dt)
    return {"align": (256,), "q": (bq * dt // 2,),
            "kv": (2 * nst, TC_BLOCK_K * dt // 2), "bars": (2 * (1 + 3 * nst),)}


def _launches(dims, blocks):
    BH, T, d = dims["BH"], dims["T"], dims["d"]
    words = sum(math.prod(v) for v in _tiles(dims, blocks).values())
    ctas = BH * -(-T // blocks["bq"]) * blocks["nsplit"]
    if not blocks["tc"]:
        return (registry.Launch("flash_fwd", (ctas, 1, 1), CC_THREADS,
                                4 * words),)
    out = (registry.Launch("flash_fwd_tc", (ctas, 1, 1), TC_THREADS,
                           4 * words),)
    if blocks["nsplit"] > 1:
        out += (registry.Launch("flash_combine",
                                (-(-BH * T // COMBINE_ROWS), 1, 1),
                                COMBINE_THREADS, 0),)
    return out


def _coverage(dims, blocks):
    """The output rows each CTA of the kernel writes, or with a split the
    combine's: COMBINE_ROWS rows of the (BH T, d) output a CTA."""
    BH, T, d = dims["BH"], dims["T"], dims["d"]
    if blocks["nsplit"] == 1:
        for (b0, b1), (t0, t1) in registry.tile_cells((BH, 1),
                                                      (T, blocks["bq"])):
            yield (b0, b1), (t0, t1), (0, d)
        return
    for r0 in range(0, BH * T, COMBINE_ROWS):
        r1 = min(r0 + COMBINE_ROWS, BH * T)
        while r0 < r1:
            b, t = divmod(r0, T)
            hi = min(r1, (b + 1) * T)
            yield (b, b + 1), (t, t + hi - r0), (0, d)
            r0 = hi


registry.register(registry.KernelSpec(
    name="attention", plain=attention_ref, cuda=flash_attention_cuda,
    make_inputs=_make_inputs, static=dict(causal=True), tol=2e-3,
    diff_argnums=(0, 1, 2),
    block_axes=(registry.BlockAxis("bq", "T", TC_BLOCK_Q, CC_BLOCK_Q),
                registry.BlockAxis("dt", "d", MAX_HEAD_DIM, 1)),
    dims_of=_dims, plan=_plan,
    # the tensor cores at d = 64 (unsplit) and d = 128 split over KV with
    # the combine; the CUDA cores in bf16 at d = 80 and in fp32 at d = 256
    candidates=({"bf16": 1, "BH": 64, "T": 1024, "S": 1024, "d": 64},
                {"bf16": 1, "BH": 2, "T": 160, "S": 4096, "d": 128},
                {"bf16": 1, "d": 80}, {"d": 256}),
    tile_model=registry.TileModel(
        out=(("BH", None), ("T", "bq"), ("d", None)), tiles=_tiles,
        launches=_launches, coverage=_coverage)))

__all__ = ["flash_attention", "flash_attention_cuda", "attention_ref",
           "attention_split_ref", "AttentionPlan", "pick_route", "head_tile",
           "plan_split", "plan_call", "route_launch_counts", "sm_count",
           "MAX_HEAD_DIM"]
