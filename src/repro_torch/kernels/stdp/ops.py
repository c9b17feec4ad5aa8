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
`csrc/stdp.cu`'s `stdp_seq_kernel` covers every session (grid.z); each
session's weight is bit for bit the unbatched kernel's at batch 1 on its
rows alone. Its plain version loops `stdp_seq_ref` over the sessions.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import _build, registry
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
                  torch.cuda.current_stream().cuda_stream)
    _build.check("stdp", code)
    stdp_update_cuda.launches += 1
    return out


def _seq_launch(wrapper, name: str, P: torch.Tensor, Q: torch.Tensor,
                w: torch.Tensor, amps: Sequence[float], w_min: float,
                w_max: float, batch: int) -> torch.Tensor:
    """`csrc/stdp.cu`'s multi-step kernel, one launch: w (M, N) with `batch`
    rows a step of P (K, T*B, M) and Q (K, T*B, N), or S weights (S, M, N),
    each one row of every step (batch 1), the sessions on the grid's z.
    Counted on `wrapper`."""
    what = "(S, M, N)" if w.dim() == 3 else "(M, N)"
    if P.dim() != 3 or w.dim() not in (2, 3):
        raise ValueError(f"{name}: P {tuple(P.shape)} must be (K, rows, M) "
                         f"and w {tuple(w.shape)} {what}")
    K, rows, _ = P.shape
    S = w.shape[0] if w.dim() == 3 else 1
    M, N = w.shape[-2:]
    if not 1 <= K <= MAX_TERMS or len(amps) != K:
        raise ValueError(f"{name}: {K} term planes and {len(amps)} amps; "
                         f"the kernel takes 1 to {MAX_TERMS} of each, as many "
                         "amps as planes")
    if batch < 1 or S < 1 or rows % (S * batch):
        raise ValueError(f"{name}: {rows} rows are not whole steps of "
                         f"{S} sessions of batch {batch}")
    _check(name, [("P", P, (K, rows, M)), ("Q", Q, (K, rows, N))], w,
           (torch.float32,))
    out = torch.empty_like(w)
    if out.numel() == 0:
        return out
    amp = (ctypes.c_float * K)(*amps)
    with torch.cuda.device(w.device):
        code = _build.library().stdp_seq_f32(
            P.data_ptr(), Q.data_ptr(), w.data_ptr(), out.data_ptr(),
            ctypes.addressof(amp), K, rows // (S * batch), batch, M, N, S,
            float(w_min), float(w_max),
            torch.cuda.current_stream().cuda_stream)
    _build.check(name, code)
    wrapper.launches += 1
    return out


def stdp_seq_cuda(P: torch.Tensor, Q: torch.Tensor, w: torch.Tensor, *,
                  amps: Sequence[float], w_min: float, w_max: float,
                  batch: int) -> torch.Tensor:
    """Launch `csrc/stdp.cu`'s multi-step kernel on CUDA tensors."""
    if w.dim() != 2:
        raise ValueError(f"stdp_seq: w {tuple(w.shape)} must be (M, N)")
    return _seq_launch(stdp_seq_cuda, "stdp_seq", P, Q, w, amps, w_min,
                       w_max, batch)


def stdp_seq_sessions_cuda(P: torch.Tensor, Q: torch.Tensor,
                           w: torch.Tensor, *, amps: Sequence[float],
                           w_min: float, w_max: float) -> torch.Tensor:
    """Launch `csrc/stdp.cu`'s multi-step kernel with a session axis:
    w (S, M, N), P (K, T * S, M), Q (K, T * S, N); one launch."""
    if w.dim() != 3:
        raise ValueError(f"stdp_seq_sessions: w {tuple(w.shape)} must be "
                         "(S, M, N)")
    return _seq_launch(stdp_seq_sessions_cuda, "stdp_seq_sessions", P, Q, w,
                       amps, w_min, w_max, 1)


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


registry.register(registry.KernelSpec(
    name="stdp_seq", plain=stdp_seq_ref, cuda=stdp_seq_cuda,
    make_inputs=_make_seq_inputs, static=_SEQ_STATIC, tol=1e-4))

_SESSIONS_STATIC = dict(amps=(0.01, -0.012), w_min=-1.0, w_max=1.0)


def _make_session_inputs(generator: torch.Generator):
    K, T, S, M, N = 2, 12, 5, 130, 140        # the family's, 5 sessions
    P = torch.rand((K, T * S, M), generator=generator)
    Q = (torch.rand((K, T * S, N), generator=generator) < 0.2).float()
    w = 0.5 * torch.randn((S, M, N), generator=generator)
    return P, Q, w


registry.register(registry.KernelSpec(
    name="stdp_seq_sessions", plain=stdp_seq_sessions_ref,
    cuda=stdp_seq_sessions_cuda, make_inputs=_make_session_inputs,
    static=_SESSIONS_STATIC, tol=1e-4))

registry.register(registry.KernelSpec(
    name="stdp", plain=stdp_update_ref, cuda=stdp_update_cuda,
    make_inputs=_make_inputs, tol=1e-4,
    static=dict(a_plus=0.01, a_minus=0.012, w_min=-1.0, w_max=1.0)))

__all__ = ["stdp_update", "stdp_seq", "stdp_update_cuda", "stdp_seq_cuda",
           "stdp_update_ref", "stdp_seq_ref", "stdp_seq_sessions",
           "stdp_seq_sessions_cuda", "stdp_seq_sessions_ref", "MAX_TERMS"]
