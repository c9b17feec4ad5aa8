"""Public STDP entry points, dispatched via the registry.

`stdp_update(x_pre, s_post, s_pre, x_post, w, ...)` — one pair-STDP step
on precomputed traces; `core/plasticity.stdp_step(use_kernel=True)` calls
it. `stdp_seq(P, Q, w, amps=, w_min=, w_max=, batch=)` — K signed
outer-product term planes over T serial steps with a per-step clip; the
plan compiler lowers matching `SynapseProgram`s to it (`core/plan.py`).
Both run `csrc/stdp.cu` on CUDA tensors and their plain versions on CPU
tensors, and both return a new weight tensor. They are weight writes, not
differentiable ops.

`stdp_seq_sessions(P, Q, w, amps=, w_min=, w_max=)` — `stdp_seq` with a
session axis, its own family (`stdp_seq_sessions`): w (S, M, N) holds one
weight a session, and session s's weight takes, at each step t, only row
t * S + s of each flat (K, T * S, .) plane, with batch-1 arithmetic (the
JAX package's per-session `vmap` of the learning pass). One launch of
`csrc/stdp_sessions.cu` covers every session, a CTA a tile of one
session's weight as `stdp_session_tile` picks it; each session's weight
is bit for bit the unbatched kernel's at batch 1 on its rows alone. Its
plain version loops `stdp_seq_ref` over the sessions.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import _build, registry
from repro_torch.kernels.common import sm_count
from repro_torch.kernels.stdp.ref import (stdp_seq_ref,
                                         stdp_seq_sessions_ref,
                                         stdp_update_ref)

MAX_TERMS = 4             # the most term planes `csrc/stdp.cu` takes
_TRACE_TYPES = (torch.float32, torch.bfloat16)


def _check(name: str, shapes, w: torch.Tensor, trace_types) -> None:
    """CUDA tensors on w's device, contiguous, of the given shapes; w
    fp32, the others of one dtype in `trace_types`."""
    if not w.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors, got "
                         f"{w.device}")
    if w.dtype != torch.float32:
        raise TypeError(f"{name}: w must be float32, got {w.dtype}")
    dtypes = {t.dtype for _, t, _ in shapes}
    if len(dtypes) != 1 or not dtypes <= set(trace_types):
        raise TypeError(f"{name}: traces and spikes must share one dtype "
                        f"of {trace_types}, got {sorted(map(str, dtypes))}")
    for nm, t, want in shapes + [("w", w, tuple(w.shape))]:
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {nm} {tuple(t.shape)} must be {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be contiguous")
        if t.device != w.device:
            raise ValueError(f"{name}: {nm} on {t.device}, w on {w.device}")


def stdp_update_cuda(x_pre: torch.Tensor, s_post: torch.Tensor,
                     s_pre: torch.Tensor, x_post: torch.Tensor,
                     w: torch.Tensor, *, a_plus: float = 0.01,
                     a_minus: float = 0.012, w_min: float = -1.0,
                     w_max: float = 1.0) -> torch.Tensor:
    """Launch `csrc/stdp.cu`'s single pair-STDP step on CUDA tensors."""
    if w.dim() != 2 or x_pre.dim() != 2:
        raise ValueError(f"stdp: w {tuple(w.shape)} must be (M, N) and "
                         f"x_pre {tuple(x_pre.shape)} (B, M)")
    M, N = w.shape
    B = x_pre.shape[0]
    _check("stdp", [("x_pre", x_pre, (B, M)), ("s_post", s_post, (B, N)),
                    ("s_pre", s_pre, (B, M)), ("x_post", x_post, (B, N))],
           w, _TRACE_TYPES)
    out = torch.empty_like(w)
    if out.numel() == 0:
        return out
    lib = _build.library()
    fn = lib.stdp_f32 if x_pre.dtype == torch.float32 else lib.stdp_bf16
    with torch.cuda.device(w.device):
        code = fn(x_pre.data_ptr(), s_post.data_ptr(), s_pre.data_ptr(),
                  x_post.data_ptr(), w.data_ptr(), out.data_ptr(), B, M, N,
                  float(a_plus), float(a_minus), float(w_min), float(w_max),
                  stdp_pair_plan(M, N)[0],
                  torch.cuda.current_stream().cuda_stream)
    _build.check("stdp", code)
    stdp_update_cuda.launches += 1
    return out


def _amps(name: str, K: int, amps: Sequence[float]):
    """The K amplitudes as the C array the kernels take."""
    if not 1 <= K <= MAX_TERMS or len(amps) != K:
        raise ValueError(f"{name}: {K} term planes and {len(amps)} amps; "
                         f"the kernel takes 1 to {MAX_TERMS} of each, as many "
                         "amps as planes")
    return (ctypes.c_float * K)(*amps)


# `csrc/stdp.cu`'s one stdp_seq tile: (rows of M, columns of N) of the
# weight a CTA owns (TM, TN there), a thread a (step, 4 x 4 micro-tile) of
# a group of `_build.STDP_SEQ_GROUP` steps; its ring of SEQ_STAGES stages
# of SEQ_ROWS rows of each step's P and Q rows (padded by 16 and 8 floats)
# and two buffers of a group's dw in shared memory
SEQ_TILE = (16, 8)
SEQ_MICRO = 4
SEQ_STAGES, SEQ_ROWS = 3, 8
# `csrc/stdp_sessions.cu`'s ring: (step, term) rows a stage, and its stages
# (5 where a row, tm + tn floats, is at most 80, else 3)
SESSION_RING_ROWS = 16
# `csrc/stdp.cu`'s pair step: adjacent weights of a row a thread, threads
# a CTA (PAIR_V, PAIR_THREADS there)
PAIR_WEIGHTS = 2
PAIR_THREADS = 128


def stdp_seq_plan(M: int, N: int) -> Tuple[int, int, int, int, int]:
    """(tm, tn, grid x, grid y, threads) of `stdp_seq_cuda`'s launch for
    an (M, N) weight: SEQ_TILE's tiles, a CTA of one thread a micro-tile
    and a step of a group. The C entry point takes (tm, tn) and refuses any
    other tile."""
    tm, tn = SEQ_TILE
    threads = (tm // SEQ_MICRO) * (tn // SEQ_MICRO) * _build.STDP_SEQ_GROUP
    return tm, tn, -(-N // tn), -(-M // tm), threads


def stdp_pair_plan(M: int, N: int) -> Tuple[int, int]:
    """(CTAs, threads a CTA) of the single pair step on an (M, N) weight:
    PAIR_WEIGHTS adjacent weights of a row a thread. The C entry point
    takes the CTAs and refuses any other grid."""
    pairs = M * -(-N // PAIR_WEIGHTS)
    return -(-pairs // PAIR_THREADS), PAIR_THREADS


def stdp_seq_cuda(P: torch.Tensor, Q: torch.Tensor, w: torch.Tensor, *,
                  amps: Sequence[float], w_min: float, w_max: float,
                  batch: int) -> torch.Tensor:
    """Launch `csrc/stdp.cu`'s multi-step kernel on CUDA tensors: w (M, N)
    with `batch` rows a step of P (K, T*B, M) and Q (K, T*B, N); one
    launch."""
    if P.dim() != 3 or w.dim() != 2:
        raise ValueError(f"stdp_seq: P {tuple(P.shape)} must be (K, rows, "
                         f"M) and w {tuple(w.shape)} (M, N)")
    K, rows, _ = P.shape
    M, N = w.shape
    amp = _amps("stdp_seq", K, amps)
    if batch < 1 or rows % batch:
        raise ValueError(f"stdp_seq: {rows} rows are not whole steps of "
                         f"batch {batch}")
    _check("stdp_seq", [("P", P, (K, rows, M)), ("Q", Q, (K, rows, N))], w,
           (torch.float32,))
    out = torch.empty_like(w)
    if out.numel() == 0:
        return out
    with torch.cuda.device(w.device):
        code = _build.library().stdp_seq_f32(
            P.data_ptr(), Q.data_ptr(), w.data_ptr(), out.data_ptr(),
            ctypes.addressof(amp), K, rows // batch, batch, M, N,
            *stdp_seq_plan(M, N)[:2], float(w_min), float(w_max),
            torch.cuda.current_stream().cuda_stream)
    _build.check("stdp_seq", code)
    stdp_seq_cuda.launches += 1
    return out


# (rows, columns) of a thread's micro-tile in `csrc/stdp_sessions.cu`,
# largest first (a CTA of 8 x 16 threads owns 8 x 16 of them): the rows
# halve, then the columns, then the rows again, then one weight a thread
SESSION_MICRO = ((4, 8), (2, 8), (2, 4), (1, 4), (1, 1))
SESSION_THREADS = (8, 16)


def stdp_session_tile(S: int, M: int, N: int, n_sm: int
                      ) -> Tuple[int, int, int, int]:
    """(tm, tn, ur, uc): the weight tile of a CTA of
    `csrc/stdp_sessions.cu` (128 threads) for S sessions of (M, N)
    weights, and each thread's ur x uc micro-tile of it (tm = 8 ur, tn =
    16 uc). The largest micro-tile, 4 x 8, gives a thread the most
    weights for each P and Q value it reads; it shrinks (`SESSION_MICRO`,
    down to one weight a thread) while the grid, S x row tiles x column
    tiles, holds fewer CTAs than the card has SMs: each weight's chain is
    serial, so a small grid is only as fast as one thread's share of its
    weights."""
    if S < 1 or M < 1 or N < 1:
        raise ValueError(f"stdp_session_tile: S={S}, M={M}, N={N}")
    for ur, uc in SESSION_MICRO:
        tm, tn = SESSION_THREADS[0] * ur, SESSION_THREADS[1] * uc
        if S * math.ceil(M / tm) * math.ceil(N / tn) >= n_sm:
            break
    return tm, tn, ur, uc


def stdp_seq_sessions_cuda(P: torch.Tensor, Q: torch.Tensor,
                           w: torch.Tensor, *, amps: Sequence[float],
                           w_min: float, w_max: float) -> torch.Tensor:
    """Launch `csrc/stdp_sessions.cu` on CUDA tensors: w (S, M, N), P (K,
    T * S, M), Q (K, T * S, N); one launch, the tile
    `stdp_session_tile`'s."""
    if P.dim() != 3 or w.dim() != 3:
        raise ValueError(f"stdp_seq_sessions: P {tuple(P.shape)} must be "
                         f"(K, rows, M) and w {tuple(w.shape)} (S, M, N)")
    K, rows, _ = P.shape
    S, M, N = w.shape
    amp = _amps("stdp_seq_sessions", K, amps)
    if S < 1 or rows % S:
        raise ValueError(f"stdp_seq_sessions: {rows} rows are not whole "
                         f"steps of {S} sessions")
    _check("stdp_seq_sessions", [("P", P, (K, rows, M)),
                                 ("Q", Q, (K, rows, N))], w,
           (torch.float32,))
    out = torch.empty_like(w)
    if out.numel() == 0:
        return out
    tm, tn, _, _ = stdp_session_tile(S, M, N, sm_count(w.device))
    with torch.cuda.device(w.device):
        code = _build.library().stdp_seq_sessions_f32(
            P.data_ptr(), Q.data_ptr(), w.data_ptr(), out.data_ptr(),
            ctypes.addressof(amp), K, rows // S, M, N, S, tm, tn,
            float(w_min), float(w_max),
            torch.cuda.current_stream().cuda_stream)
    _build.check("stdp_seq_sessions", code)
    stdp_seq_sessions_cuda.launches += 1
    return out


def stdp_update(x_pre: torch.Tensor, s_post: torch.Tensor,
                s_pre: torch.Tensor, x_post: torch.Tensor, w: torch.Tensor,
                *, a_plus: float = 0.01, a_minus: float = 0.012,
                w_min: float = -1.0, w_max: float = 1.0) -> torch.Tensor:
    """One STDP weight step. Traces/spikes: (B, N_*); w: (N_pre, N_post)."""
    return registry.dispatch("stdp", (x_pre, s_post, s_pre, x_post, w),
                             a_plus=a_plus, a_minus=a_minus, w_min=w_min,
                             w_max=w_max)


def stdp_seq(P: torch.Tensor, Q: torch.Tensor, w: torch.Tensor, *,
             amps: Sequence[float], w_min: float, w_max: float,
             batch: int) -> torch.Tensor:
    """Multi-step STDP window. P: (K, T*B, M); Q: (K, T*B, N); w: (M, N).

    Per step t: w <- clip(w + sum_k amps[k] * P_k_t^T @ Q_k_t, w_min,
    w_max)."""
    return registry.dispatch("stdp_seq", (P, Q, w), amps=tuple(amps),
                             w_min=w_min, w_max=w_max, batch=batch)


def stdp_seq_sessions(P: torch.Tensor, Q: torch.Tensor, w: torch.Tensor, *,
                      amps: Sequence[float], w_min: float,
                      w_max: float) -> torch.Tensor:
    """Session-batched learning window. P: (K, T*S, M); Q: (K, T*S, N);
    w: (S, M, N). Per step t and session s: w[s] <- clip(w[s] + sum_k
    amps[k] * P_k[t S + s]^T Q_k[t S + s], w_min, w_max)."""
    return registry.dispatch("stdp_seq_sessions", (P, Q, w),
                             amps=tuple(amps), w_min=w_min, w_max=w_max)


def _make_inputs(generator: torch.Generator):
    B, M, N = 6, 130, 140                     # as the JAX family's
    x_pre = torch.rand((B, M), generator=generator)
    x_post = torch.rand((B, N), generator=generator)
    s_pre = (torch.rand((B, M), generator=generator) < 0.2).float()
    s_post = (torch.rand((B, N), generator=generator) < 0.2).float()
    w = 0.5 * torch.randn((M, N), generator=generator)
    return x_pre, s_post, s_pre, x_post, w


_SEQ_STATIC = dict(amps=(0.01, -0.012), w_min=-1.0, w_max=1.0, batch=4)


def _make_seq_inputs(generator: torch.Generator):
    K, T, B, M, N = 2, 12, 4, 130, 140        # as the JAX family's
    P = torch.rand((K, T * B, M), generator=generator)
    Q = (torch.rand((K, T * B, N), generator=generator) < 0.2).float()
    w = 0.5 * torch.randn((M, N), generator=generator)
    return P, Q, w


def _seq_dims(P, Q, w, *, batch, **static):
    K, rows, M = P.shape
    return {"K": K, "T": rows // batch, "B": batch, "M": M, "N": w.shape[1]}


def _seq_plan(dims, n_sm, overrides):
    tm, tn, *_ = stdp_seq_plan(dims["M"], dims["N"])
    return {"tm": tm, "tn": tn}


def _seq_tiles(dims, blocks):
    G, tm, tn = _build.STDP_SEQ_GROUP, blocks["tm"], blocks["tn"]
    return {"p_ring": (SEQ_STAGES, G, SEQ_ROWS * tm + 16),
            "q_ring": (SEQ_STAGES, G, SEQ_ROWS * tn + 8),
            "dw": (2, G, tm * tn)}


def _seq_launches(dims, blocks):
    *_, gx, gy, threads = stdp_seq_plan(dims["M"], dims["N"])
    words = sum(math.prod(v) for v in _seq_tiles(dims, blocks).values())
    return (registry.Launch("stdp_seq_kernel", (gx, gy, 1), threads,
                            4 * words),)


registry.register(registry.KernelSpec(
    name="stdp_seq", plain=stdp_seq_ref, cuda=stdp_seq_cuda,
    make_inputs=_make_seq_inputs, static=_SEQ_STATIC, tol=1e-4,
    block_axes=(registry.BlockAxis("tm", "M", SEQ_TILE[0], SEQ_TILE[0]),
                registry.BlockAxis("tn", "N", SEQ_TILE[1], SEQ_TILE[1])),
    dims_of=_seq_dims, plan=_seq_plan,
    candidates=({"K": 4, "T": 300, "B": 8, "M": 256, "N": 128},),
    tile_model=registry.TileModel(out=(("M", "tm"), ("N", "tn")),
                                  tiles=_seq_tiles,
                                  launches=_seq_launches)))

_SESSIONS_STATIC = dict(amps=(0.01, -0.012), w_min=-1.0, w_max=1.0)


def _make_session_inputs(generator: torch.Generator):
    K, T, S, M, N = 2, 12, 5, 130, 140        # the family's, 5 sessions
    P = torch.rand((K, T * S, M), generator=generator)
    Q = (torch.rand((K, T * S, N), generator=generator) < 0.2).float()
    w = 0.5 * torch.randn((S, M, N), generator=generator)
    return P, Q, w


def _session_dims(P, Q, w, **static):
    S, M, N = w.shape
    return {"K": P.shape[0], "T": P.shape[1] // S, "S": S, "M": M, "N": N}


def _session_plan(dims, n_sm, overrides):
    tm, tn, _, _ = stdp_session_tile(dims["S"], dims["M"], dims["N"], n_sm)
    return {"sb": 1, "tm": tm, "tn": tn}


def _session_tiles(dims, blocks):
    row = blocks["tm"] + blocks["tn"]
    return {"ring": (5 if row <= 80 else 3, SESSION_RING_ROWS, row)}


def _session_launches(dims, blocks):
    tm, tn = blocks["tm"], blocks["tn"]
    words = math.prod(_session_tiles(dims, blocks)["ring"])
    return (registry.Launch(
        "stdp_sessions_kernel",
        (-(-dims["N"] // tn), -(-dims["M"] // tm), dims["S"]),
        math.prod(SESSION_THREADS), 0, 4 * words),)


registry.register(registry.KernelSpec(
    name="stdp_seq_sessions", plain=stdp_seq_sessions_ref,
    cuda=stdp_seq_sessions_cuda, make_inputs=_make_session_inputs,
    static=_SESSIONS_STATIC, tol=1e-4,
    block_axes=(registry.BlockAxis("sb", "S", 1, 1),
                registry.BlockAxis("tm", "M", 32, 8),
                registry.BlockAxis("tn", "N", 128, 16)),
    dims_of=_session_dims, plan=_session_plan,
    # the largest micro-tile (a full learning cohort), the smallest (one
    # session), one between
    candidates=({"S": 64, "T": 32, "M": 700, "N": 64},
                {"S": 1, "T": 32, "M": 128, "N": 64},
                {"S": 7, "T": 32, "M": 130, "N": 140}),
    tile_model=registry.TileModel(
        out=(("S", "sb"), ("M", "tm"), ("N", "tn")), tiles=_session_tiles,
        launches=_session_launches)))


def _pair_dims(x_pre, s_post, s_pre, x_post, w, **static):
    M, N = w.shape
    return {"B": x_pre.shape[0], "M": M, "N": N,
            "PAIRS": M * -(-N // PAIR_WEIGHTS)}


def _pair_plan(dims, n_sm, overrides):
    return {"pb": stdp_pair_plan(dims["M"], dims["N"])[1]}


registry.register(registry.KernelSpec(
    name="stdp", plain=stdp_update_ref, cuda=stdp_update_cuda,
    make_inputs=_make_inputs, tol=1e-4,
    static=dict(a_plus=0.01, a_minus=0.012, w_min=-1.0, w_max=1.0),
    # a CTA owns PAIR_THREADS consecutive pairs of adjacent weights of the
    # (M, ceil(N / 2)) pair grid, and holds nothing in shared memory
    block_axes=(registry.BlockAxis("pb", "PAIRS", PAIR_THREADS,
                                   PAIR_THREADS),),
    dims_of=_pair_dims, plan=_pair_plan,
    candidates=({"M": 256, "N": 128, "PAIRS": 256 * 64},),
    tile_model=registry.TileModel(
        out=(("PAIRS", "pb"),), tiles=lambda dims, blocks: {},
        launches=lambda dims, blocks: (registry.Launch(
            "stdp_pair_kernel",
            (stdp_pair_plan(dims["M"], dims["N"])[0], 1, 1),
            blocks["pb"], 0),))))

__all__ = ["stdp_update", "stdp_seq", "stdp_update_cuda", "stdp_seq_cuda",
           "stdp_update_ref", "stdp_seq_ref", "stdp_seq_sessions",
           "stdp_seq_sessions_cuda", "stdp_seq_sessions_ref",
           "stdp_session_tile", "stdp_seq_plan", "stdp_pair_plan",
           "MAX_TERMS"]
