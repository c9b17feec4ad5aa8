"""The session axis of kernels 1 and 7 (a learning serve window), on the CPU.

* The plain versions of the session-batched `spikemm` and `stdp_seq` equal,
  bit for bit, the unbatched plain versions on each session's rows alone
  (`spikemm_ref` on rows (T, K) against w[s]; `stdp_seq_ref` at batch 1 on
  rows t * S + s), at S = 1 and at ragged (S, M, N); and
  `spikemm_sessions_chain_ref`, the card's chain, equals `spikemm_chain_ref`
  session by session.
* The session-axis `stdp_seq` equals the JAX package's `stdp_seq` under
  `jax.vmap` over sessions at batch 1 (the reference engine's learning
  step, on its reference route), and keeps every bit of the unbatched
  plain version with -0 weights and signed-zero planes, as does the order
  `csrc/stdp_sessions.cu` sums in (each 0 + p q dropped).
* With a recording stand-in for the kernel library (no card here), each
  CUDA wrapper makes one C call for all sessions with the shape and tile
  the kernel is to take (`session_tile`, `stdp_session_tile`), and counts
  one launch; the unbatched `stdp_seq` wrapper passes no session axis.
* `plan.run(learn=True)` with one weight a batch row (a (B, n_pre, n_post)
  plastic weight and stacked synapse state) equals the unbatched
  `plan.run` of each row alone, bit for bit: outputs, neuron state and the
  learned weight and traces, on the fused `stdp_seq` lowering. The
  per-step synapse interpreter (TB210), the stepper engine and a weight
  with a session axis on a connection that does not learn are refused.
"""

import dataclasses
from contextlib import nullcontext
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from repro.kernels.stdp.ops import stdp_seq as jax_stdp_seq

from repro_torch.core import plan, plasticity
from repro_torch.core.snn_layers import make_plastic_ff
from repro_torch.kernels import _build, registry
from repro_torch.kernels.spikemm import ops as spikemm_ops
from repro_torch.kernels.spikemm.ops import (spikemm_sessions,
                                             spikemm_sessions_chain_ref,
                                             spikemm_sessions_cuda,
                                             spikemm_sessions_ref)
from repro_torch.kernels.spikemm.ref import spikemm_chain_ref, spikemm_ref
from repro_torch.kernels.stdp import ops as stdp_ops
from repro_torch.kernels.stdp.ops import (stdp_seq_cuda, stdp_seq_sessions,
                                          stdp_seq_sessions_cuda,
                                          stdp_session_tile)
from repro_torch.kernels.stdp.ref import stdp_seq_ref, stdp_seq_sessions_ref

# (T, S, K, N): one session, and ragged against every tile
SPIKE_SHAPES = [(32, 1, 256, 128), (37, 5, 130, 70), (9, 3, 7, 1)]
# (K terms, T, S, M, N)
STDP_SHAPES = [(2, 32, 1, 256, 128), (2, 12, 5, 130, 140),
               (4, 7, 3, 9, 5)]
AMPS = (0.01, -0.012, 0.003, -0.02)


def _raster(shape, seed, rate=0.15):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(shape, generator=g) < rate).float()


@pytest.mark.parametrize("T,S,K,N", SPIKE_SHAPES)
def test_spikemm_sessions_plain_is_the_unbatched_plain_a_session_at_a_time(
        T, S, K, N):
    s = _raster((T, S, K), T * S)
    w = torch.randn((S, K, N), generator=torch.Generator().manual_seed(K))
    got = spikemm_sessions(s, w)
    chain = spikemm_sessions_chain_ref(s, w)
    assert got.shape == chain.shape == (T, S, N)
    for i in range(S):
        alone = s[:, i].contiguous()
        assert torch.equal(got[:, i], spikemm_ref(alone, w[i]))
        assert torch.equal(chain[:, i], spikemm_chain_ref(alone, w[i]))
    torch.testing.assert_close(got, chain, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, spikemm_sessions_ref(s, w))


@pytest.mark.parametrize("K,T,S,M,N", STDP_SHAPES)
def test_stdp_seq_sessions_plain_is_the_unbatched_plain_at_batch_1(
        K, T, S, M, N):
    g = torch.Generator().manual_seed(M)
    P = torch.rand((K, T * S, M), generator=g)
    Q = (torch.rand((K, T * S, N), generator=g) < 0.3).float()
    w = 0.5 * torch.randn((S, M, N), generator=g)
    kw = dict(amps=AMPS[:K], w_min=-0.4, w_max=0.4)
    got = stdp_seq_sessions(P, Q, w, **kw)
    assert got.shape == w.shape and not torch.equal(got, w)
    for i in range(S):
        rows = torch.arange(i, T * S, S)
        alone = stdp_seq_ref(P[:, rows].contiguous(), Q[:, rows].contiguous(),
                             w[i], batch=1, **kw)
        assert torch.equal(got[i], alone)
    assert torch.equal(got, stdp_seq_sessions_ref(P, Q, w, **kw))


@pytest.fixture
def stand_in(monkeypatch):
    """A recording stand-in for the kernel library: CPU tensors through the
    CUDA wrappers, device and stream stood in for."""
    lib = mock.Mock(**{"spikemm_sessions_f32.return_value": 0,
                       "stdp_seq_f32.return_value": 0,
                       "stdp_seq_sessions_f32.return_value": 0})
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(spikemm_ops, "sm_count", lambda dev: 132)
    monkeypatch.setattr(stdp_ops, "sm_count", lambda dev: 132)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    registry.reset_launches()
    yield lib
    registry.reset_launches()


@pytest.mark.parametrize("T,S,K,N", SPIKE_SHAPES + [(32, 64, 256, 128)])
def test_spikemm_sessions_wrapper_is_one_launch(stand_in, T, S, K, N):
    out = spikemm_sessions_cuda(torch.zeros((T, S, K)),
                                torch.zeros((S, K, N)))
    assert out.shape == (T, S, N)
    assert [c[0] for c in stand_in.method_calls] == ["spikemm_sessions_f32"]
    assert stand_in.spikemm_sessions_f32.call_args.args[3:9] == (
        (T, K, N, S) + spikemm_ops.session_tile(T, N, 132, S))
    assert registry.launch_counts()["spikemm_sessions"] == 1
    assert registry.launch_counts()["spikemm"] == 0


# (T, N, S) -> (bm, cw): serve_plastic's window at S = 64 (four 32-wide
# slabs a session: 256 CTAs), 7 and 1; a ragged window; rows past a tile
SESSION_TILES = {(32, 128, 64): (32, 32), (32, 128, 7): (32, 8),
                 (32, 128, 1): (32, 8), (37, 70, 5): (64, 8),
                 (9, 1, 3): (16, 8), (16, 300, 200): (16, 64),
                 (300, 128, 64): (64, 64)}


@pytest.mark.parametrize("T,N,S", sorted(SESSION_TILES))
def test_session_tile_plan(T, N, S):
    """No CTA owns more rows than its session has, past the rounding to
    the least tile that holds them (8, 16, 32, 64; 16 to 128 at the 8-wide
    slab); the slab is the least that covers N (up to 64), narrowed while
    the grid holds fewer CTAs than 132 SMs; at serve_plastic's window the
    grid holds at least a wave."""
    bm, cw = spikemm_ops.session_tile(T, N, 132, S)
    assert (bm, cw) == SESSION_TILES[(T, N, S)]
    least = 16 if cw == 8 else 8
    assert bm == min(8 * least, max(least, 1 << (T - 1).bit_length()))
    assert cw in spikemm_ops.SESSION_COLS
    ctas = S * -(-T // bm) * -(-N // cw)
    assert cw == 8 or ctas >= 132
    if (T, N, S) == (32, 128, 64):
        assert ctas >= 132 and bm == T


@pytest.mark.parametrize("K,T,S,M,N", STDP_SHAPES + [
    (2, 32, 64, 256, 128), (4, 32, 64, 256, 128)])
def test_stdp_seq_sessions_wrapper_is_one_launch(stand_in, K, T, S, M, N):
    out = stdp_seq_sessions_cuda(torch.zeros((K, T * S, M)),
                                 torch.zeros((K, T * S, N)),
                                 torch.zeros((S, M, N)), amps=AMPS[:K],
                                 w_min=-1.0, w_max=1.0)
    assert out.shape == (S, M, N)
    assert [c[0] for c in stand_in.method_calls] == ["stdp_seq_sessions_f32"]
    assert stand_in.stdp_seq_sessions_f32.call_args.args[5:12] == (
        (K, T, M, N, S) + stdp_session_tile(S, M, N, 132)[:2])
    assert registry.launch_counts()["stdp_seq_sessions"] == 1
    assert registry.launch_counts()["stdp_seq"] == 0


def test_stdp_seq_wrapper_passes_no_session_axis(stand_in):
    """`csrc/stdp.cu`'s entry point has no session axis: (K, T, B, M, N),
    the plan's weight tile (`stdp_seq_plan`: 16 x 8) and the bounds,
    counted on `stdp_seq` alone."""
    K, T, B, M, N = 2, 6, 3, 9, 5
    stdp_seq_cuda(torch.zeros((K, T * B, M)), torch.zeros((K, T * B, N)),
                  torch.zeros((M, N)), amps=AMPS[:K], w_min=-1.0, w_max=1.0,
                  batch=B)
    assert [c[0] for c in stand_in.method_calls] == ["stdp_seq_f32"]
    args = stand_in.stdp_seq_f32.call_args.args
    assert len(args) == 15 and args[5:14] == (K, T, B, M, N, 16, 8, -1.0,
                                              1.0)
    assert registry.launch_counts()["stdp_seq"] == 1
    assert registry.launch_counts()["stdp_seq_sessions"] == 0


# (S, M, N) -> (tm, tn, ur, uc) on 132 SMs: serve_plastic's window at S =
# 64 (the pair and the triplet rule alike: the plan does not read K; one
# wave of 512 CTAs), 10, 7 and 1 (one weight a thread, 256 CTAs); the
# family's ragged (130, 140) and the triplet test shape (9, 5); weights
# of 64 columns; many ragged sessions
STDP_SESSION_TILES = {(64, 256, 128): (32, 128, 4, 8),
                      (10, 256, 128): (16, 128, 2, 8),
                      (7, 256, 128): (16, 64, 2, 4),
                      (1, 256, 128): (8, 16, 1, 1),
                      (5, 130, 140): (16, 64, 2, 4),
                      (3, 9, 5): (8, 16, 1, 1),
                      (7, 256, 64): (8, 64, 1, 4),
                      (200, 130, 140): (32, 128, 4, 8)}


@pytest.mark.parametrize("S,M,N", sorted(STDP_SESSION_TILES))
def test_stdp_session_tile_plan(S, M, N):
    """The tile is 8 x 16 threads times the micro-tile; the micro-tile is
    the largest of its sequence (4 x 8, 2 x 8, 2 x 4, 1 x 4, 1 x 1) whose
    grid holds at least as many CTAs as SMs, or the least where none
    does."""
    tm, tn, ur, uc = stdp_session_tile(S, M, N, 132)
    assert (tm, tn, ur, uc) == STDP_SESSION_TILES[(S, M, N)]
    assert (tm, tn) == (8 * ur, 16 * uc)
    micro = stdp_ops.SESSION_MICRO
    i = micro.index((ur, uc))

    def ctas(u, c):
        return S * -(-M // (8 * u)) * -(-N // (16 * c))
    assert all(ctas(*m) < 132 for m in micro[:i])
    assert ctas(ur, uc) >= 132 or i == len(micro) - 1
    if (S, M, N) == (64, 256, 128):
        assert ctas(ur, uc) == 512


@pytest.mark.parametrize("K", [2, 4])
def test_stdp_seq_sessions_matches_the_reference_vmap(K):
    """The port's session axis against the JAX package's learning step in
    a serve window: `stdp_seq` at batch 1 under `jax.vmap` over sessions
    (reference route), on inputs from a numpy seed. The reference sums a
    step's terms in one einsum, in another order than the port's dw +
    amp_k s_k, so the two agree within 1e-6 (relative and absolute), not
    bit for bit."""
    T, S, M, N = 9, 4, 24, 20
    rng = np.random.default_rng(K)
    P = rng.random((K, T * S, M)).astype(np.float32)
    Q = (rng.random((K, T * S, N)) < 0.3).astype(np.float32)
    w = (0.3 * rng.standard_normal((S, M, N))).astype(np.float32)
    kw = dict(amps=AMPS[:K], w_min=-0.4, w_max=0.4)
    ref = jax.vmap(lambda p, q, ws: jax_stdp_seq(p, q, ws, batch=1, **kw),
                   in_axes=(2, 2, 0))(P.reshape(K, T, S, M),
                                      Q.reshape(K, T, S, N), w)
    got = stdp_seq_sessions(*(torch.from_numpy(a) for a in (P, Q, w)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    assert not np.array_equal(got.numpy(), w)
    assert (np.abs(got.numpy()) == 0.4).any(), "no weight reached the clip"


def _kernel_order(P, Q, w, *, amps, w_min, w_max):
    """`csrc/stdp_sessions.cu`'s arithmetic on the CPU: per session and
    step, dw from +0 as dw + amp_k * (p q) over k ascending (each 0 + p q
    of the plain order dropped), then clip(w + dw)."""
    S = w.shape[0]
    out = []
    for s in range(S):
        ws = w[s].clone()
        for r in range(s, P.shape[1], S):
            dw = torch.zeros_like(ws)
            for k, a in enumerate(amps):
                dw = dw + torch.tensor(a, dtype=torch.float32) * (
                    P[k, r, :, None] * Q[k, r, None, :])
            ws = torch.clamp(ws + dw, w_min, w_max)
        out.append(ws)
    return torch.stack(out)


@pytest.mark.parametrize("planes", ["zero", "signed"])
def test_stdp_seq_sessions_plain_keeps_signed_zeros(planes):
    """-0 weights (and +0 ones) against planes of signed zeros alone, or
    with nonzero pre-side values whose products with +0 are -0: the
    session-axis plain version equals `stdp_seq_ref` at batch 1 on each
    session's rows as int32 views, and so does the kernel's order, which
    drops each 0 + p q. Session 0's every term is -0 (p of the sign
    opposite to amp_k against q = +0): its dw must still be +0, since it
    is summed from +0, so each -0 weight of session 0 becomes +0."""
    K, T, S, M, N = 3, 4, 3, 6, 5
    amps = (0.5, -0.25, 0.125)
    rng = np.random.default_rng(7)
    sign = np.where(rng.random((K, T * S, M)) < 0.5, -1.0, 1.0)
    sign[:, 0::S] = -np.sign(amps)[:, None, None]
    P = sign * (0.0 if planes == "zero" else rng.random((K, T * S, M)))
    Q = np.where(rng.random((K, T * S, N)) < 0.5, -0.0, 0.0)
    if planes == "signed":
        Q = np.where(rng.random((K, T * S, N)) < 0.4, 1.0, Q)
    Q[:, 0::S] = 0.0
    w = np.where(rng.random((S, M, N)) < 0.6, -0.0,
                 0.2 * rng.standard_normal((S, M, N)))
    P, Q, w = (torch.from_numpy(a.astype(np.float32)) for a in (P, Q, w))
    assert torch.signbit(w[0]).logical_and(w[0] == 0).any()
    kw = dict(amps=amps, w_min=-0.4, w_max=0.4)
    got = stdp_seq_sessions(P, Q, w, **kw)
    for i in range(S):
        alone = stdp_seq_ref(P[:, i::S].contiguous(), Q[:, i::S].contiguous(),
                             w[i], batch=1, **kw)
        assert torch.equal(got[i].view(torch.int32), alone.view(torch.int32))
    assert torch.equal(_kernel_order(P, Q, w, **kw).view(torch.int32),
                       got.view(torch.int32))
    # session 0: every -0 weight became +0 at its first step, the rest
    # clipped (in the zero planes' case, every session)
    want = torch.clamp(torch.where(w == 0, 0.0, w), -0.4, 0.4)
    some = slice(None) if planes == "zero" else slice(0, 1)
    assert torch.equal(got[some].view(torch.int32),
                       want[some].view(torch.int32))


def test_session_wrappers_refuse_shapes_they_cannot_take(stand_in):
    with pytest.raises(ValueError, match="do not chain"):
        spikemm_sessions_cuda(torch.zeros((4, 3, 5)), torch.zeros((2, 5, 6)))
    with pytest.raises(ValueError, match="whole steps"):
        stdp_seq_sessions_cuda(torch.zeros((1, 7, 4)), torch.zeros((1, 7, 3)),
                               torch.zeros((2, 4, 3)), amps=(0.1,),
                               w_min=-1.0, w_max=1.0)
    assert registry.launch_counts()["spikemm_sessions"] == 0


def test_spikemm_sessions_refuses_a_gradient():
    w = torch.zeros((2, 5, 3), requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        spikemm_sessions(torch.zeros((4, 2, 5)), w)
    with torch.no_grad():
        assert spikemm_sessions(torch.zeros((4, 2, 5)), w).shape == (4, 2, 3)


def _model(rule="pair_stdp"):
    return make_plastic_ff(torch.Generator().manual_seed(5), n_in=20,
                           n_hidden=16, n_out=3,
                           rule=plasticity.make_synapse(rule), device="cpu")


def _stacked(nodes, params, states):
    """Stacked state and params of per-row states (the serve engine's
    cohort: weights stacked, traces and neuron state along the batch)."""
    from repro_torch.serve.engine import _stack_sessions
    st = _stack_sessions(states)
    return st, plasticity.apply_learned(nodes, params, st)


@pytest.mark.parametrize("rule", ["pair_stdp", "triplet_stdp"])
def test_plan_run_with_a_weight_a_row_equals_each_row_alone(rule):
    """Two windows: the first from the seed, the second from each row's own
    learned weight (distinct per row); the stacked run of the second equals
    the unbatched run of each row alone, bit for bit."""
    nodes, params = _model(rule)
    compiled = plan.compile_program(nodes)
    rng = np.random.default_rng(2)
    B, T = 4, 19
    x1, x2 = (torch.from_numpy((rng.random((T, B, 20)) < 0.3).astype(
        np.float32)) for _ in range(2))
    with torch.no_grad():
        rows = []
        for b in range(B):
            st, _, _ = plan.run(nodes, params, x1[:, b:b + 1],
                                plan=compiled, device="cpu")
            rows.append(st)
        assert not torch.equal(rows[0]["hidden"]["syn:input"]["w"],
                               rows[1]["hidden"]["syn:input"]["w"])
        st, p = _stacked(nodes, params, rows)
        assert p["hidden"]["w_input"].shape == (B, 20, 16)
        ns, out, _ = plan.run(nodes, p, x2, state=st, plan=compiled,
                              device="cpu")
        for b in range(B):
            pb = plasticity.apply_learned(nodes, params, rows[b])
            nb, ob, _ = plan.run(nodes, pb, x2[:, b:b + 1], state=rows[b],
                                 plan=compiled, device="cpu")
            assert torch.equal(out[:, b:b + 1], ob)
            for node, nd in nb.items():
                for k, v in nd.items():
                    if k.startswith("syn:"):
                        for e, t in v.items():
                            got = ns[node][k][e]
                            got = got[b] if e == "w" else got[b:b + 1]
                            assert torch.equal(got, t), (node, k, e)
                    else:
                        assert torch.equal(ns[node][k][b:b + 1], v), (node, k)


@pytest.mark.parametrize("rule", ["pair_stdp", "triplet_stdp"])
def test_a_weight_a_row_is_refused_on_the_per_step_synapse_lowering(rule):
    """The per-step synapse interpreter (TB210) has no session axis: a
    learning run with a weight a row raises, naming item 7; without
    learning the forward takes the weights a row on the fused plan."""
    nodes, params = _model(rule)
    compiled = plan.compile_program(nodes)
    compiled = dataclasses.replace(compiled, plastic=tuple(
        dataclasses.replace(p, lower=plan.SYN_STEP)
        for p in compiled.plastic))
    p = dict(params)
    p["hidden"] = {"w_input": params["hidden"]["w_input"].expand(
        2, 20, 16).contiguous()}
    x = torch.zeros((5, 2, 20))
    with torch.no_grad():
        with pytest.raises(NotImplementedError,
                           match="per-step synapse lowering.*item 7"):
            plan.run(nodes, p, x, plan=compiled, device="cpu")
        _, out, _ = plan.run(nodes, p, x, plan=compiled, device="cpu",
                             learn=False)
    assert out.shape == (5, 2, 3)


def test_a_weight_a_row_is_refused_off_the_fused_plan(monkeypatch):
    nodes, params = _model()
    p = dict(params)
    p["hidden"] = {"w_input": params["hidden"]["w_input"].expand(
        2, 20, 16).contiguous()}
    x = torch.zeros((5, 2, 20))
    monkeypatch.setenv("REPRO_SNN_ENGINE", "stepper")
    with pytest.raises(NotImplementedError, match="item 7"):
        plan.run(nodes, p, x, device="cpu")
    monkeypatch.delenv("REPRO_SNN_ENGINE")
    p["readout"] = {"w_hidden": params["readout"]["w_hidden"].expand(
        2, 16, 3).contiguous()}
    with torch.no_grad(), pytest.raises(ValueError, match="plastic"):
        plan.run(nodes, p, x, device="cpu", learn=False)
