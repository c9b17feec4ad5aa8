"""Public entry for the DIFF recurrence, dispatched via the registry.

`linrec(a, x, h0)`: y_t = a_t * y_{t-1} + x_t over axis 0 of x (T, B, D),
from h0 (B, D). `a` is anything that broadcasts to x's shape; a per-neuron
decay (D,) broadcast over T and B reaches the kernel as a stride-0 view
and is never materialised. It is differentiable in (a, x, h0) through
`_LinRec`, the reverse-time adjoint of the JAX package's custom VJP:
`csrc/linrec_bwd.cu`'s `linrec_bwd_f32` kernel on CUDA tensors
(`linrec_bwd_cuda`, its own launch counter, listed as `linrec_bwd`),
`linrec_bwd_ref` on CPU tensors. g_a and g_h0 are computed only where
autograd needs them (an LI readout's decay is a constant); g_a comes back
in x's shape, or, for a decay of D values (`lanes_decay`), summed over T
and B by the backward itself.

`linrec_branches(a, x, h0, K)`: a DH-LIF layer's dendritic prologue, the
same recurrence over (T, B, K N) lanes and then the soma's fixed-order
sum of its K branches, (T, B, N); its backward (`_LinRecBranches`) is
one `linrec_bwd` launch that reads the soma's cotangent as it is.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build, registry
from repro_torch.kernels.common import (MAX_WARPS, check_planes, lane_plan,
                                        lane_tiles,
                                        optional_ptr, sm_count,
                                        zeroed_counters)
from repro_torch.kernels.linrec.ref import (lanes_decay, linrec_bwd_ref,
                                            linrec_naive, linrec_ref)


def _check(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor) -> None:
    if not x.is_cuda:
        raise ValueError(f"linrec: the CUDA kernel takes CUDA tensors, got "
                         f"{x.device}")
    if x.dim() != 3 or tuple(h0.shape) != tuple(x.shape[1:]):
        raise ValueError(f"linrec: x {tuple(x.shape)} must be (T, B, D) and "
                         f"h0 {tuple(h0.shape)} (B, D)")
    for nm, t in (("a", a), ("x", x), ("h0", h0)):
        if t.dtype != torch.float32:
            raise TypeError(f"linrec: {nm} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"linrec: {nm} on {t.device}, x on {x.device}")
    for nm, t in (("x", x), ("h0", h0)):
        if not t.is_contiguous():
            raise ValueError(f"linrec: {nm} must be contiguous")


def linrec_cuda(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor):
    """Launch `csrc/linrec.cu` on CUDA tensors."""
    _check(a, x, h0)
    T, B, D = x.shape
    av = a.expand(x.shape)                   # a view: strides 0 where broadcast
    y = torch.empty_like(x)
    hT = torch.empty_like(h0)
    if T == 0:
        return y, hT.copy_(h0)
    if h0.numel() == 0:
        return y, hT
    warps, _, stages = lane_plan(B * D, T, sm_count(x.device))
    with torch.cuda.device(x.device):
        code = _build.library().linrec_f32(
            av.data_ptr(), av.stride(0), av.stride(1), av.stride(2),
            x.data_ptr(), h0.data_ptr(), y.data_ptr(), hT.data_ptr(),
            T, B, D, warps, stages, torch.cuda.current_stream().cuda_stream)
    _build.check("linrec", code)
    linrec_cuda.launches += 1
    return y, hT


# `csrc/linrec_bwd.cu`'s CTA: LINREC_BWD_THREADS threads (a chain warp and
# helpers) own 32 lanes; their planes come in by segments of
# LINREC_BWD_SEG steps, a ring of up to LINREC_BWD_BUFS of them, or a call
# of at most LINREC_BWD_TMA_ROWS steps in one tensor copy a plane
LINREC_BWD_THREADS = 256
LINREC_BWD_SEG = 32
LINREC_BWD_BUFS = 8
LINREC_BWD_TMA_ROWS = 256
GA_NONE, GA_PLANE, GA_SUM = 0, 1, 2


class LinrecBwdPlan(NamedTuple):
    """`linrec_bwd_plan`'s launch: the tensor-copy route or not, the rows
    of each plane a CTA stages, its planes, and the grid, threads and
    dynamic shared memory that follow."""

    tma: bool
    rows: int
    planes: int
    grid: int
    threads: int
    smem: int


def linrec_bwd_plan(T: int, B: int, D: int, a_plane: bool, ga_mode: int,
                    copyable: bool) -> LinrecBwdPlan:
    """The backward's launch over B x D lanes of T steps: a CTA a 32-lane
    group. Its planes come in as one tensor copy each (TMA, all T steps in
    one pass) where the call allows it: no decay plane, at most
    LINREC_BWD_TMA_ROWS steps and `copyable` (g_y's rows of whole 16-byte
    groups, or the soma's of whole warps, 16-byte aligned, and y's where
    g_a is asked for: the wrapper reads the pointers); else by cp.async in
    LINREC_BWD_SEG-step segments, a ring of up to LINREC_BWD_BUFS. The
    staged planes: g_y, y where g_a is asked for (`ga_mode`), the decay
    plane; each holds the staged rows and a segment of scratch rows of 32
    lanes, plus 128 bytes of alignment. The C entry point takes `tma` and
    refuses a call it does not fit."""
    tma = not a_plane and T <= LINREC_BWD_TMA_ROWS and copyable
    rows = T if tma else min(-(-T // LINREC_BWD_SEG),
                             LINREC_BWD_BUFS) * LINREC_BWD_SEG
    planes = 1 + (ga_mode != GA_NONE) + bool(a_plane)
    return LinrecBwdPlan(tma, rows, planes, -(-B * D // 32),
                         LINREC_BWD_THREADS,
                         4 * (rows + LINREC_BWD_SEG) * planes * 32 + 128)


def linrec_bwd_cuda(a: torch.Tensor, y: torch.Tensor, h0: torch.Tensor,
                    g_y: torch.Tensor, g_hT, need_a: bool = True,
                    need_h0: bool = True):
    """Launch `csrc/linrec_bwd.cu` on CUDA tensors: `linrec_bwd_ref`'s
    (g_a, g_x, g_h0), None where not needed. g_y is (T, B, D) or the soma
    cotangent (T, B, N) of D = K N branch lanes; g_hT may be None (zero).
    One launch and nothing after it: g_a of a decay of D values
    (`lanes_decay`) is summed over T and B by the kernel, on a (B, D)
    scratch of per-lane partials and zeroed counters of the stream."""
    _check(a, y, h0)
    T, B, D = y.shape
    N = g_y.shape[-1] if g_y.dim() == 3 else 0
    if (g_y.dim() != 3 or tuple(g_y.shape[:2]) != (T, B) or N < 1
            or D % N):
        raise ValueError(f"linrec_bwd: g_y {tuple(g_y.shape)} must be "
                         f"(T, B, N) with N dividing D, y {tuple(y.shape)}")
    if (g_y.dtype != y.dtype or g_y.device != y.device
            or not g_y.is_contiguous()):
        raise ValueError(f"linrec_bwd: g_y must be contiguous {y.dtype} on "
                         f"{y.device}, got {g_y.dtype} on {g_y.device}")
    if g_hT is not None:
        check_planes("linrec_bwd", h0, [("g_hT", g_hT)])
    av = a.expand(y.shape)                   # a view: strides 0 where broadcast
    summed = need_a and lanes_decay(a, D)
    g_x = torch.empty_like(y)
    g_a = None
    if need_a:
        g_a = torch.empty(a.shape, dtype=y.dtype, device=y.device) \
            if summed else torch.empty_like(y)
    g_h0 = torch.empty_like(h0) if need_h0 else None
    if T == 0 or h0.numel() == 0:
        if summed:
            g_a.zero_()
        if g_h0 is not None:
            g_h0 = g_h0.zero_() if g_hT is None else g_h0.copy_(g_hT)
        return g_a, g_x, g_h0
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        part = count = None
        if summed:
            part = torch.empty((B, D), dtype=torch.float32, device=y.device)
            # a counter a group of 32 columns (`csrc/linrec_bwd.cu`)
            count = zeroed_counters(y.device, stream,
                                    D // 32 if D % 32 == 0 else 1)
        # a dimension of one step or row has no stride to walk
        sa = [0 if n == 1 else st for n, st in zip(av.shape, av.stride())]
        ga_mode = GA_NONE if not need_a else GA_SUM if summed else GA_PLANE
        lanes = B * D
        copyable = (g_y.data_ptr() % 16 == 0
                    and (lanes % 4 == 0 if N == D else N % 32 == 0)
                    and (ga_mode == GA_NONE
                         or (lanes % 4 == 0 and y.data_ptr() % 16 == 0)))
        plan = linrec_bwd_plan(T, B, D, sa[0] != 0, ga_mode, copyable)
        code = _build.library().linrec_bwd_f32(
            av.data_ptr(), *sa,
            y.data_ptr(), h0.data_ptr(), g_y.data_ptr(), optional_ptr(g_hT),
            optional_ptr(part), optional_ptr(count), g_x.data_ptr(),
            optional_ptr(g_a), optional_ptr(g_h0), T, B, D, N, int(summed),
            int(plan.tma), stream)
    _build.check("linrec_bwd", code)
    linrec_bwd_cuda.launches += 1
    return g_a, g_x, g_h0


class _LinRec(torch.autograd.Function):
    """`fwd` forward, `bwd` backward: the implementations `linrec`
    dispatches to by device (None), or the pair the parity harness holds
    against each other."""

    @staticmethod
    def forward(ctx, a, x, h0, fwd, bwd):
        y, hT = (registry.dispatch("linrec", (a, x, h0)) if fwd is None
                 else fwd(a, x, h0))
        ctx.save_for_backward(a, y, h0)
        ctx.bwd = bwd
        return y, hT

    @staticmethod
    def backward(ctx, g_y, g_hT):
        a, y, h0 = ctx.saved_tensors
        need_a, need_x, need_h0 = ctx.needs_input_grad[:3]
        args = (a, y, h0, g_y.contiguous(), g_hT.contiguous())
        kw = dict(need_a=need_a, need_h0=need_h0)
        g_a, g_x, g_h0 = (registry.dispatch_bwd("linrec", args, **kw)
                          if ctx.bwd is None else ctx.bwd(*args, **kw))
        if g_a is not None and g_a.shape != a.shape:
            g_a = g_a.sum_to_size(a.shape)
        return g_a, g_x if need_x else None, g_h0, None, None


class _LinRecBranches(torch.autograd.Function):
    """A DH-LIF layer's dendritic prologue: `linrec` over the (T, B, K N)
    branch lanes, then the soma's sum of the K branches in a fixed order,
    ((d_0 + d_1) + d_2) + ..., so that a lane's result never depends on
    the batch it was packed into. Returns (the soma's current (T, B, N),
    the branches' final state (B, K N)).

    Its backward is one `linrec_bwd` that reads the soma's cotangent
    (T, B, N) for every branch of a neuron: no (T, B, K, N) cotangent
    plane is filled, copied or added, and a decay of K N values gets its
    gradient summed over T and B by the kernel. The sum's own backward
    only handed every branch the soma's cotangent (adding exact zeros),
    so g_x is bit for bit what autograd through the sum and `linrec`
    gave. An unused final state costs nothing (no zero cotangent is
    made)."""

    @staticmethod
    def forward(ctx, a, x, h0, K):
        T, B, D = x.shape
        y, hT = registry.dispatch("linrec", (a, x, h0))
        d4 = y.reshape(T, B, K, D // K)
        soma = d4[:, :, 0]
        for k in range(1, K):
            soma = soma + d4[:, :, k]
        ctx.save_for_backward(a, y, h0)
        ctx.K = K
        ctx.set_materialize_grads(False)
        return soma.contiguous(), hT

    @staticmethod
    def backward(ctx, g_soma, g_hT):
        a, y, h0 = ctx.saved_tensors
        need_a, need_x, need_h0 = ctx.needs_input_grad[:3]
        if g_soma is None:
            T, B, D = y.shape
            g_soma = y.new_zeros((T, B, D // ctx.K))
        args = (a, y, h0, g_soma.contiguous(),
                None if g_hT is None else g_hT.contiguous())
        g_a, g_x, g_h0 = registry.dispatch_bwd(
            "linrec", args, need_a=need_a, need_h0=need_h0)
        if g_a is not None and g_a.shape != a.shape:
            g_a = g_a.sum_to_size(a.shape)
        return g_a, g_x if need_x else None, g_h0, None


def linrec_branches(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor,
                    K: int):
    """The K-branch dendritic prologue: y = linrec(a, x, h0) over x's
    (T, B, K N) lanes, then (the soma's current sum_k y[:, :, k N : (k + 1)
    N] in ascending k, (T, B, N); y's final state (B, K N)).
    Differentiable in (a, x, h0) through `_LinRecBranches`."""
    if x.dim() != 3 or x.shape[2] % K:
        raise ValueError(f"linrec_branches: x {tuple(x.shape)} must be "
                         f"(T, B, K N) with K = {K}")
    return _LinRecBranches.apply(a, x, h0, K)


def linrec(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor):
    """y_t = a_t * y_{t-1} + x_t over axis 0. x: (T,B,D); h0: (B,D).

    Differentiable in (a, x, h0)."""
    return _LinRec.apply(a, x, h0, None, None)


def _vjp(fwd, bwd, a, x, h0):
    return _LinRec.apply(a, x, h0, fwd, bwd)


def _make_inputs(generator: torch.Generator):
    T, B, D = 24, 3, 136
    a = 0.5 + 0.49 * torch.rand((T, B, D), generator=generator)
    x = torch.randn((T, B, D), generator=generator)
    h0 = torch.randn((B, D), generator=generator)
    return a, x, h0


def _planes(a, x, h0):
    """The planes `csrc/linrec.cu`'s ring stages: x, and a decay with a
    time stride (a full plane; a (D,) or (B, D) decay is read in place)."""
    return 2 if a.expand(x.shape).stride(0) else 1


_TILES = lane_tiles("linrec_kernel", current=1, planes_of=_planes)


def _bwd_dims(a, x, h0):
    """The forward's dims, and the backward's: G, the width of the
    cotangent's rows (D, or the soma's N of the branch call), GA, the
    mode of g_a (`GA_PLANE` for a decay plane, `GA_SUM` for a (D,) decay),
    and V, whether its planes take the tensor copies (the wrapper reads
    the pointers; the calls here are 16-byte aligned)."""
    d = _TILES["dims_of"](a, x, h0)
    lanes = d["B"] * d["N"]
    return {**d, "G": d["N"], "GA": GA_PLANE if d["P"] == 2 else GA_SUM,
            "V": int(lanes % 4 == 0)}


def _bwd_launch(dims) -> LinrecBwdPlan:
    return linrec_bwd_plan(dims["T"], dims["B"], dims["N"], dims["P"] == 2,
                           dims["GA"], bool(dims["V"]))


def _bwd_plan(dims, n_sm, overrides):
    p = _bwd_launch(dims)
    return {"lb": 32, "bt": dims["T"], "tma": int(p.tma), "rows": p.rows}


def _bwd_tiles(dims, blocks):
    p = _bwd_launch(dims)
    # "flags": LINREC_BWD_BUFS 8-byte mbarriers, a progress count and a
    # flag, static (80 bytes)
    return {"planes": (p.planes, p.rows + LINREC_BWD_SEG, 32),
            "align": (32,), "flags": (20,)}


def _bwd_launches(dims, blocks):
    p = _bwd_launch(dims)
    return (registry.Launch("linrec_bwd_kernel", (p.grid, 1, 1), p.threads,
                            p.smem, 80),)


registry.register(registry.KernelSpec(
    name="linrec", plain=linrec_ref, cuda=linrec_cuda,
    make_inputs=_make_inputs, tol=1e-4, diff_argnums=(0, 1, 2),
    bwd=registry.Channel(plain=linrec_bwd_ref, cuda=linrec_bwd_cuda),
    vjp=_vjp, **_TILES,
    bwd_tiles=registry.KernelSpec(
        name="linrec_bwd", plain=linrec_bwd_ref, cuda=linrec_bwd_cuda,
        make_inputs=_make_inputs, dims_of=_bwd_dims, plan=_bwd_plan,
        block_axes=(registry.BlockAxis("lb", "L", 32, 32),
                    registry.BlockAxis("bt", "T", 1, 1, exact=True)),
        # the DH-LIF branch call (the soma's cotangent, tensor copies), the
        # readout (a full cotangent plane, tensor copies) and a long call
        # (cp.async segments, a ring of 8)
        candidates=({"T": 32, "B": 64, "N": 256, "L": 16384, "P": 1,
                     "G": 64, "GA": GA_SUM, "V": 1},
                    {"T": 32, "B": 64, "N": 20, "L": 1280, "P": 1, "G": 20,
                     "GA": GA_SUM, "V": 1},
                    {"T": 300, "B": 8, "N": 256, "L": 2048, "P": 1,
                     "G": 256, "GA": GA_SUM, "V": 1}),
        tile_model=registry.TileModel(out=(("L", "lb"), ("T", "bt")),
                                      tiles=_bwd_tiles,
                                      launches=_bwd_launches))))

__all__ = ["linrec", "linrec_branches", "linrec_cuda", "linrec_bwd_cuda",
           "linrec_ref", "linrec_bwd_ref", "linrec_naive", "lanes_decay",
           "lane_plan", "MAX_WARPS"]
