"""Training through the port held against the JAX package, on the CPU.

* The VJP of each op of the SHD slice against `jax.vjp` of the JAX op on
  the same numpy inputs and cotangents, at the family's `KernelSpec.tol`
  (1e-4, relative and absolute):
  - `lif_scan`: 4 surrogates x 2 resets x alpha 0.5, 1, 2, at a prime
    T = 37; a lane-step whose reference membrane lies within 1e-5 of a
    rectangle or triangle window edge may differ from that step back
    (`tests/_torch_parity.py::surrogate_edges`), and the test asserts
    there is none at these inputs; and at T = 2 SEG + 5 (three segments
    of the lane backward), where the lanes at an edge are left out from
    that step back and g_tau, a long sum in another order than JAX's, is
    held within a relative L2 error of 1e-4; the plain g_tau is its
    per-lane partials summed over B in ascending b, bit for bit;
  - `linrec`: a full decay plane and a per-neuron decay broadcast over
    (T, B) (a stride-0 view on the port's side);
  - `spikemm`: under `REPRO_SPIKEMM_SPARSE=never` and `always`, on a
    binary and a graded raster.
* The SHD DH-SNN, dendritic and homogeneous, at the JAX test's sizes
  (n_hidden 32, T 40, B 16): the loss and every gradient leaf of the
  port's `plan.run` and `events.run` against `jax.value_and_grad` of the
  JAX `plan.run` and `events.run` on the same weights: the loss within
  `CROSS_ENGINE_ATOL`, each leaf within a relative L2 error of 1e-4, the
  hidden spike trains under the threshold-tie rule; and three clipped-SGD
  steps (`examples/shd_dhsnn.py`'s update) with the losses within 1e-4
  relative of the reference's.
* A port twin of `tests/test_events_and_apps.py::test_dhsnn_shd_learns`:
  25 clipped-SGD steps at lr 0.3 lower the loss below 0.9x the first, on
  both engines.
* The learning pass stays out of the graph; the recurrent and ALIF
  scans pass a gradient (their backward, B4 and B5, is held against the
  JAX package in `tests/test_torch_train_ecg.py`), and the ECG SRNN's
  gradients agree across the two engines; serving builds no graph.
* The gather's backward (B6, the gather on the transposed tables) against
  `jax.grad` through the JAX package's custom VJP, for each encoding of
  `tests/test_topology_exec.py` that executes through the gather.
* `train_banded` at a small size (48 -> 256 LIF -> a +-8 band of 256 LIF
  -> 20 LI, T = 16, B = 4, built from both packages' parts): the loss and
  every leaf against `jax.value_and_grad` of the JAX `plan.run`.
* The seven programs of `tests/test_torch_plan.py` (`_six_programs`,
  `_delayed_program`): loss mean(out^2) and every leaf against
  `jax.value_and_grad` of the JAX `plan.run`.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import events as jevents
from repro.core import plan as jplan
from repro.core.snn_layers import make_dhsnn_shd as jmake_dhsnn
from repro.kernels.lif.ops import lif_scan as jlif_scan
from repro.kernels.linrec.ops import linrec as jlinrec
from repro.kernels.spikemm.ops import spikemm as jspikemm
from repro_torch.core import events, plan
from repro_torch.core.snn_layers import (make_dhsnn_shd, make_plastic_ff,
                                         make_srnn_ecg)
from repro_torch.data.spikes import gen_shd_spikes
from repro_torch.kernels import _build, registry
from repro_torch.kernels.alifrec.ops import alif_scan, alifrec_scan
from repro_torch.kernels.lif.ops import lif_scan
from repro_torch.kernels.lifrec.ops import lifrec_scan
from repro_torch.kernels.linrec.ops import linrec, linrec_branches
from repro_torch.kernels.linrec.ref import linrec_bwd_ref
from repro_torch.kernels.spikemm.ops import spikemm
from repro_torch.serve import EngineConfig, make_engine
from repro_torch.weights import grads_to_numpy, params_from_numpy
from tests._torch_parity import hidden_membrane, surrogate_edges, tie_rule

TOL = 1e-4                       # the families' KernelSpec.tol
SEG = _build.LANE_BWD_SEG        # steps a segment of the lane backward
LEAF_RTOL = 1e-4                 # relative L2 error of a gradient leaf
N_HIDDEN, T_STEPS, BATCH = 32, 40, 16
SURROGATES = ("arctan", "rectangle", "sigmoid", "triangle")


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _close(got, want, what):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=what)


# ---------------------------------------------------------------------------
# the ops' VJPs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", (37, 2 * SEG + 5))
@pytest.mark.parametrize("alpha", (0.5, 1.0, 2.0))
@pytest.mark.parametrize("reset", ("zero", "subtract"))
@pytest.mark.parametrize("surrogate", SURROGATES)
def test_lif_scan_vjp_matches_jax(surrogate, reset, alpha, T):
    rng = np.random.default_rng(7)
    B, N = 3, 130
    cur = (0.6 * rng.standard_normal((T, B, N))).astype(np.float32)
    tau = rng.uniform(0.7, 0.98, N).astype(np.float32)
    v0 = (0.3 * rng.standard_normal((B, N))).astype(np.float32)
    gs = rng.standard_normal((T, B, N)).astype(np.float32)
    gvT = rng.standard_normal((B, N)).astype(np.float32)
    (s_j, vT_j), vjp = jax.vjp(
        lambda c, t, v: jlif_scan(c, t, v, 1.0, surrogate, alpha, False,
                                  reset), jnp.asarray(cur), jnp.asarray(tau),
        jnp.asarray(v0))
    g_j = vjp((jnp.asarray(gs), jnp.asarray(gvT)))
    args = [torch.from_numpy(a).requires_grad_() for a in (cur, tau, v0)]
    s_t, vT_t = lif_scan(*args, 1.0, surrogate, alpha, reset)
    g_t = torch.autograd.grad((s_t, vT_t), args, (torch.from_numpy(gs),
                                                  torch.from_numpy(gvT)))
    np.testing.assert_array_equal(_np(s_t), np.asarray(s_j))
    _close(vT_t, vT_j, "v_final")
    # the reference's pre-reset membrane, in float64 along its spikes
    s = np.asarray(s_j, np.float64)
    u = np.zeros((T, B, N))
    v = v0.astype(np.float64)
    for t in range(T):
        u[t] = tau * v + cur[t]
        v = u[t] - s[t] if reset == "subtract" else u[t] * (1.0 - s[t])
    edges = surrogate_edges(u, 1.0, surrogate, alpha)
    if T == 37:
        assert not edges.any(), \
            f"{int(edges.sum())} lane-steps at a window edge"
        for name, got, want in zip(("g_current", "g_tau", "g_v0"), g_t,
                                   g_j):
            _close(got, want, name)
        return
    # past two segments: a lane may differ from a window-edge step back
    # (the tie rule), so its g_current up to that step and its g_v0 are
    # left out; g_tau, a sum of T B terms in another order than JAX's
    # (at T = 133 as small as 0.04 from terms summing to 270 in size), is
    # held as a gradient leaf, within a relative L2 error of LEAF_RTOL
    assert edges.sum() <= 2, f"{int(edges.sum())} lane-steps at an edge"
    keep = np.ones((T, B, N), bool)
    for t, b, n in np.argwhere(edges):
        keep[:t + 1, b, n] = False
    _close(_np(g_t[0])[keep], np.asarray(g_j[0])[keep], "g_current")
    _close(_np(g_t[2])[keep[0]], np.asarray(g_j[2])[keep[0]], "g_v0")
    err = np.linalg.norm(_np(g_t[1]) - np.asarray(g_j[1])) / \
        np.linalg.norm(np.asarray(g_j[1]))
    assert err <= LEAF_RTOL, f"g_tau relative L2 error {err:.3e}"


@pytest.mark.parametrize("reset", ("zero", "subtract"))
def test_lif_bwd_g_tau_sums_the_lane_partials_in_ascending_b(reset):
    """The plain backward's g_tau is its per-lane partials (each lane's
    sum over t, descending) summed over B in ascending b
    (`sum_rows_ascending`, the kernel's order), bit for bit; a batch row
    alone gives its own partials as g_tau."""
    from repro_torch.kernels.lif.ref import (lif_scan_bwd_partials,
                                             lif_scan_bwd_ref)
    from repro_torch.kernels.lifrec.ref import sum_rows_ascending
    g = torch.Generator().manual_seed(30)
    T, B, N = 37, 7, 33
    cur = 0.6 * torch.randn((T, B, N), generator=g) + 0.4
    tau = 0.7 + 0.28 * torch.rand((N,), generator=g)
    v0 = 0.3 * torch.randn((B, N), generator=g)
    s, _ = lif_scan(cur, tau, v0, 1.0, "triangle", 1.0, reset)
    gs, gv = torch.randn((T, B, N), generator=g), torch.randn((B, N),
                                                             generator=g)
    args = (cur, tau, v0, s, gs, gv, 1.0, "triangle", 1.0, reset)
    g_cur, g_tau, g_v0 = lif_scan_bwd_ref(*args)
    p_cur, part, p_v0 = lif_scan_bwd_partials(*args)
    assert torch.equal(g_cur, p_cur) and torch.equal(g_v0, p_v0)
    assert torch.equal(g_tau, sum_rows_ascending(part))
    ascending = part[0].clone()
    for b in range(1, B):
        ascending += part[b]
    assert torch.equal(g_tau, ascending)
    rows = torch.stack([lif_scan_bwd_ref(
        cur[:, b:b + 1], tau, v0[b:b + 1], s[:, b:b + 1], gs[:, b:b + 1],
        gv[b:b + 1], 1.0, "triangle", 1.0, reset)[1] for b in range(B)])
    assert torch.equal(rows, part)
    assert lif_scan_bwd_ref(*args, need_tau=False, need_v0=False)[1:] == (
        None, None)


def test_surrogate_edges_find_the_window_edges():
    u = np.array([1.5, 1.5 + 2e-5, 1.0])
    assert surrogate_edges(u, 1.0, "rectangle", 1.0).tolist() == [
        True, False, False]
    assert not surrogate_edges(u, 1.0, "sigmoid", 1.0).any()


@pytest.mark.parametrize("decay", ("full_plane", "per_neuron"))
def test_linrec_vjp_matches_jax(decay):
    rng = np.random.default_rng(3)
    T, B, D = 37, 3, 136
    a_shape = (T, B, D) if decay == "full_plane" else (D,)
    a = rng.uniform(0.5, 0.99, a_shape).astype(np.float32)
    x = rng.standard_normal((T, B, D)).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    gy = rng.standard_normal((T, B, D)).astype(np.float32)
    ghT = rng.standard_normal((B, D)).astype(np.float32)
    (y_j, hT_j), vjp = jax.vjp(
        lambda a_, x_, h_: jlinrec(jnp.broadcast_to(a_, (T, B, D)), x_, h_),
        jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0))
    g_j = vjp((jnp.asarray(gy), jnp.asarray(ghT)))
    args = [torch.from_numpy(v).requires_grad_() for v in (a, x, h0)]
    y_t, hT_t = linrec(args[0].expand(T, B, D), args[1], args[2])
    g_t = torch.autograd.grad((y_t, hT_t), args, (torch.from_numpy(gy),
                                                  torch.from_numpy(ghT)))
    _close(y_t, y_j, "y")
    _close(hT_t, hT_j, "h_final")
    for name, got, want in zip(("g_a", "g_x", "g_h0"), g_t, g_j):
        assert got.shape == tuple(np.shape(want))
        _close(got, want, name)


def test_linrec_bwd_computes_only_what_is_needed(monkeypatch):
    """A constant decay and state (the LI readout's) need g_x alone: the
    backward is asked for no g_a and no g_h0, and g_x is the reversed,
    one-shifted forward recurrence."""
    asked = []
    spec = registry.get("linrec")

    def recording(*args, **kw):
        asked.append(kw)
        return linrec_bwd_ref(*args, **kw)
    monkeypatch.setattr(registry, "_REGISTRY", {
        **registry._REGISTRY, "linrec": dataclasses.replace(
            spec, bwd=dataclasses.replace(spec.bwd, plain=recording))})
    rng = np.random.default_rng(4)
    T, B, D = 9, 2, 5
    a = torch.full((D,), 0.97).expand(T, B, D)
    x = torch.from_numpy(rng.standard_normal((T, B, D)).astype(np.float32))
    x.requires_grad_()
    h0 = torch.zeros(B, D)
    y, hT = linrec(a, x, h0)
    gy = torch.from_numpy(rng.standard_normal((T, B, D)).astype(np.float32))
    (gx,) = torch.autograd.grad(y, x, gy)
    g_a, g_x, g_h0 = linrec_bwd_ref(a, y.detach(), h0, gy, torch.zeros(B, D),
                                    need_a=False, need_h0=False)
    assert g_a is None and g_h0 is None
    assert asked == [dict(need_a=False, need_h0=False)]
    assert torch.equal(gx, g_x)
    a_rev = torch.cat([a[1:], torch.zeros(1, B, D)]).flip(0)
    y_rev, _ = linrec(a_rev, gy.flip(0).contiguous(), torch.zeros(B, D))
    assert torch.equal(y_rev.flip(0), gx)


@pytest.mark.parametrize("raster", ("binary", "graded"))
@pytest.mark.parametrize("mode", ("never", "always"))
def test_spikemm_vjp_matches_jax(mode, raster, monkeypatch):
    monkeypatch.setenv("REPRO_SPIKEMM_SPARSE", mode)
    rng = np.random.default_rng(5)
    M, K, N = 100, 300, 200
    s = (rng.random((M, K)) < 0.13).astype(np.float32)
    if raster == "graded":
        s = s * rng.uniform(0.5, 2.0, (M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    g = rng.standard_normal((M, N)).astype(np.float32)
    out_j, vjp = jax.vjp(jspikemm, jnp.asarray(s), jnp.asarray(w))
    g_j = vjp(jnp.asarray(g))
    args = [torch.from_numpy(v).requires_grad_() for v in (s, w)]
    out_t = spikemm(*args)
    g_t = torch.autograd.grad(out_t, args, torch.from_numpy(g))
    _close(out_t, out_j, "out")
    for name, got, want in zip(("g_spikes", "g_w"), g_t, g_j):
        _close(got, want, name)


def test_spikemm_input_raster_gets_no_gradient(monkeypatch):
    """g_w alone where the raster needs no gradient (an input layer's):
    the dense g_spikes product is skipped, and g_w goes to spikemm's
    backward pair (its weight-gradient kernel on the card), handed the
    raster as it is, untransposed."""
    calls, g_w_calls = [], []
    spec = registry.get("spikemm")
    real, real_bwd = spec.plain, spec.bwd.plain

    def counting(s, w):
        calls.append((tuple(s.shape), tuple(w.shape)))
        return real(s, w)

    def counting_bwd(s, g, head=None):
        g_w_calls.append((tuple(s.shape), tuple(g.shape), head))
        return real_bwd(s, g, head=head)
    monkeypatch.setattr(registry, "_REGISTRY", {
        **registry._REGISTRY, "spikemm": dataclasses.replace(
            spec, plain=counting, bwd=dataclasses.replace(
                spec.bwd, plain=counting_bwd))})
    monkeypatch.setenv("REPRO_SPIKEMM_SPARSE", "never")
    s = (torch.rand(12, 7, generator=torch.Generator().manual_seed(0))
         < 0.3).float()
    w = torch.randn(7, 5, requires_grad=True)
    spikemm(s, w).sum().backward()
    assert calls == [((12, 7), (7, 5))]
    assert g_w_calls == [((12, 7), (12, 5), None)]
    assert torch.allclose(w.grad, s.t() @ torch.ones(12, 5))


# ---------------------------------------------------------------------------
# the SHD DH-SNN end to end
# ---------------------------------------------------------------------------


def _shd_data():
    xs, ys = gen_shd_spikes(BATCH, T=T_STEPS)
    return np.ascontiguousarray(xs.transpose(1, 0, 2)), ys


def _jax_loss(nodes, x, y, run):
    def loss(p):
        _, outs, _ = run(nodes, p, x)
        logits = jnp.mean(outs, 0)
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(len(y)), y])
    return loss


def _port_loss(nodes, params, x, y, run):
    _, outs, _ = run(nodes, params, x, device="cpu")
    logits = outs.mean(0)
    return -torch.log_softmax(logits, -1)[torch.arange(len(y)), y].mean()


def _leaves_with_paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], prefix + (k,))
    elif tree is not None:
        yield prefix, tree


def _requires_grad(tree):
    for _, t in _leaves_with_paths(tree):
        t.requires_grad_()
    return tree


def _clipped_sgd(params, grads, lr):
    """`examples/shd_dhsnn.py`'s update: SGD with the global gradient norm
    clipped to 1."""
    gn = torch.sqrt(sum((g ** 2).sum() for _, g in _leaves_with_paths(
        grads)))
    sc = torch.clamp_max(1.0 / (gn + 1e-9), 1.0)
    with torch.no_grad():
        for path, p in _leaves_with_paths(params):
            g = grads
            for k in path:
                g = g[k]
            p -= lr * sc * g


def _jax_sgd(params, grads, lr):
    gn = jnp.sqrt(sum(jnp.sum(jnp.square(g))
                      for g in jax.tree.leaves(grads)))
    sc = jnp.minimum(1.0, 1.0 / (gn + 1e-9))
    return jax.tree.map(lambda p, g: p - lr * sc * g, params, grads)


@functools.lru_cache(maxsize=None)
def _reference(dendritic, engine, steps=1):
    """The JAX model's weights, data, and the losses, gradient trees and
    recorded hidden spikes of `steps` clipped-SGD steps at lr 0.2."""
    jn, jp = jmake_dhsnn(jax.random.PRNGKey(1), n_hidden=N_HIDDEN,
                         dendritic=dendritic)
    x, y = _shd_data()
    run = jplan.run if engine == "plan" else jevents.run
    vg = jax.jit(jax.value_and_grad(_jax_loss(jn, jnp.asarray(x),
                                              jnp.asarray(y), run)))
    p0 = jax.tree_util.tree_map(np.asarray, jp)
    _, _, rec = run(jn, jp, jnp.asarray(x), record=("hidden",))
    losses, grads = [], []
    p = jp
    for _ in range(steps):
        loss, g = vg(p)
        losses.append(float(loss))
        grads.append(jax.tree_util.tree_map(np.asarray, g))
        p = _jax_sgd(p, g, 0.2)
    return jn, p0, x, y, losses, grads, np.asarray(rec["hidden"])


def _port_model(dendritic, p0):
    tn, _ = make_dhsnn_shd(torch.Generator().manual_seed(0),
                           n_hidden=N_HIDDEN, dendritic=dendritic,
                           device="cpu")
    return tn, _requires_grad(params_from_numpy(p0, "cpu"))


@pytest.mark.parametrize("engine", ("plan", "events"))
@pytest.mark.parametrize("dendritic", (True, False),
                         ids=("dendritic", "homogeneous"))
def test_shd_dhsnn_loss_and_gradients_match_jax(dendritic, engine):
    jn, p0, x, y, losses, grads, spikes_ref = _reference(dendritic, engine)
    tn, tp = _port_model(dendritic, p0)
    run = plan.run if engine == "plan" else events.run
    xt = torch.from_numpy(x)
    loss = _port_loss(tn, tp, xt, torch.from_numpy(y).long(), run)
    loss.backward()
    assert abs(loss.item() - losses[0]) <= plan.CROSS_ENGINE_ATOL
    got = grads_to_numpy(tp)
    want = dict(_leaves_with_paths(grads[0]))
    got_leaves = dict(_leaves_with_paths(got))
    assert set(got_leaves) == set(want)
    # the hidden trains under the tie rule, and the window edges counted
    with torch.no_grad():
        _, _, rec = run(tn, tp, xt, record=("hidden",), device="cpu")
    hp = {k: np.asarray(v) for k, v in p0["hidden"].items()
          if k != "neuron"}
    hp["neuron"] = p0["hidden"].get("neuron")
    u, th = hidden_membrane(tn[0], hp, x, spikes_ref)
    tie_rule(spikes_ref, rec["hidden"].numpy(), u, th)
    edges = surrogate_edges(u, th, tn[0].neuron.surrogate,
                            tn[0].neuron.alpha)
    for path, w in want.items():
        rel = np.linalg.norm(got_leaves[path] - w) / np.linalg.norm(w)
        assert rel <= LEAF_RTOL, (
            f"{'/'.join(path)}: relative L2 error {rel:.3e} "
            f"({int(edges.sum())} hidden lane-steps at a window edge)")


@pytest.mark.parametrize("dendritic", (True, False),
                         ids=("dendritic", "homogeneous"))
def test_shd_dhsnn_three_sgd_steps_follow_jax(dendritic):
    _, p0, x, y, losses, _, _ = _reference(dendritic, "plan", steps=3)
    tn, tp = _port_model(dendritic, p0)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    got = []
    for _ in range(3):
        for _, p in _leaves_with_paths(tp):
            p.grad = None
        loss = _port_loss(tn, tp, xt, yt, plan.run)
        loss.backward()
        got.append(loss.item())
        _clipped_sgd(tp, grads_tree(tp), 0.2)
    np.testing.assert_allclose(got, losses, rtol=1e-4)


def grads_tree(params):
    """The `.grad` tensors of a parameter tree, shaped like it."""
    if isinstance(params, dict):
        return {k: grads_tree(v) for k, v in params.items()
                if v is not None}
    return params.grad


@pytest.mark.parametrize("engine", ("events", "plan"))
def test_port_dhsnn_shd_learns(engine):
    """The port's twin of `test_dhsnn_shd_learns`: 25 clipped-SGD steps at
    lr 0.3 on the JAX test's data and sizes (weights from the port's own
    generator)."""
    x, y = _shd_data()
    nodes, params = make_dhsnn_shd(torch.Generator().manual_seed(1),
                                   n_hidden=N_HIDDEN, device="cpu")
    _requires_grad(params)
    run = plan.run if engine == "plan" else events.run
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    losses = []
    for _ in range(25):
        for _, p in _leaves_with_paths(params):
            p.grad = None
        loss = _port_loss(nodes, params, xt, yt, run)
        loss.backward()
        losses.append(loss.item())
        _clipped_sgd(params, grads_tree(params), 0.3)
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.9, losses


# ---------------------------------------------------------------------------
# what stays out of the graph, what passes a gradient and what refuses one
# ---------------------------------------------------------------------------


def test_learning_pass_stays_out_of_the_graph():
    nodes, params = make_plastic_ff(torch.Generator().manual_seed(2),
                                    device="cpu")
    x = torch.from_numpy((np.random.default_rng(2).random((30, 4, 64))
                          < 0.3).astype(np.float32))
    grads = {}
    for learn in (True, False):
        p = {k: {kk: vv.clone().requires_grad_() for kk, vv in v.items()}
             for k, v in params.items()}
        state, out, _ = plan.run(nodes, p, x, learn=learn, device="cpu")
        out.pow(2).mean().backward()
        grads[learn] = grads_to_numpy(p)
        if learn:
            syn = state["hidden"]["syn:input"]
            assert syn and all(v.grad_fn is None and not v.requires_grad
                               for v in syn.values())
    for path, g in _leaves_with_paths(grads[False]):
        other = grads[True]
        for k in path:
            other = other[k]
        assert np.abs(g).sum() > 0
        np.testing.assert_array_equal(other, g)


@pytest.mark.parametrize("call", [
    lambda t: lifrec_scan(t, torch.zeros(4, 4), torch.ones(4),
                          torch.zeros(2, 4), torch.zeros(2, 4)),
    lambda t: alif_scan(t, torch.ones(4), torch.ones(4), torch.zeros(2, 4),
                        torch.zeros(2, 4)),
    lambda t: alifrec_scan(t, torch.zeros(4, 4), torch.ones(4),
                           torch.ones(4), torch.zeros(2, 4),
                           torch.zeros(2, 4), torch.zeros(2, 4)),
], ids=("lifrec", "alif", "alifrec"))
def test_recurrent_and_alif_scans_pass_a_gradient(call):
    """The recurrent and ALIF scans have their backward (B4, B5): a
    gradient flows through each (a current that fires in some steps
    gets a nonzero one, under the default surrogate), and inference under
    `no_grad` or on tensors that need none builds no graph."""
    cur = torch.full((5, 2, 4), 0.6).requires_grad_()
    out = call(cur)
    assert out[0].grad_fn is not None
    assert out[0].sum() > 0                     # some steps fire
    (g,) = torch.autograd.grad(out[1].sum() + out[0].sum(), cur)
    assert g.shape == cur.shape and torch.isfinite(g).all()
    assert g.abs().sum() > 0
    with torch.no_grad():
        assert call(cur)[0].grad_fn is None     # inference runs
    assert call(cur.detach())[0].grad_fn is None


def test_ecg_srnn_trains_alike_on_both_engines():
    """The ECG SRNN trains on both engines: `plan.run` (the
    fused `alifrec`, its backward kernel's plain version and `spikemm`'s
    g_w) and `events.run` (autograd through `surrogate.spike`) give the
    same loss and gradients on the same weights."""
    x = torch.from_numpy((np.random.default_rng(0).random((30, 2, 4))
                          < 0.3).astype(np.float32))
    grads, losses = {}, {}
    for engine, run in (("plan", plan.run), ("events", events.run)):
        nodes, params = make_srnn_ecg(torch.Generator().manual_seed(0),
                                      n_hidden=16, device="cpu")
        _requires_grad(params)
        _, out, _ = run(nodes, params, x, device="cpu")
        loss = out.pow(2).mean()
        loss.backward()
        losses[engine] = loss.item()
        grads[engine] = dict(_leaves_with_paths(grads_to_numpy(params)))
    assert abs(losses["plan"] - losses["events"]) <= plan.CROSS_ENGINE_ATOL
    assert set(grads["plan"]) == set(grads["events"])
    for path, g in grads["events"].items():
        assert np.abs(g).sum() > 0, path
        rel = np.linalg.norm(grads["plan"][path] - g) / np.linalg.norm(g)
        assert rel <= LEAF_RTOL, f"{'/'.join(path)}: {rel:.3e}"


@pytest.fixture(scope="module")
def gather_encs():
    """{name: (JAX encoding, port encoding)} of `tests/test_topology_exec.py`'s
    fixture (the same numpy arrays in both packages), the encodings that
    execute through the gather."""
    from repro.core import topology as jtopo
    from repro_torch.core import topology as topo
    from tests.test_torch_topology import GATHER_NAMES, _encodings
    j = _encodings(jtopo, np.random.default_rng(3))
    t = _encodings(topo, np.random.default_rng(3))
    return {k: (j[k], t[k]) for k in GATHER_NAMES}


@pytest.mark.parametrize("name", ["sparse_t0", "sparse_t1", "sparse_coo_t1",
                                  "conv_t3", "pool_t0"])
def test_gather_gradient_matches_jax(gather_encs, name):
    """B6: `apply_spikes`' gradient through the gather (the gather on the
    transposed tables) against `jax.grad` through the JAX package's custom
    VJP (`tests/test_topology_exec.py::test_gather_vjp_matches_dense`'s
    loss), within 1e-4; the same call under `no_grad` builds no graph."""
    jenc, tenc = gather_encs[name]
    assert tenc.exec_channel() == jenc.exec_channel() == "gather"
    x = (np.random.default_rng(7).random((6, tenc.n_pre)) < 0.35).astype(
        np.float32)
    want = jax.grad(lambda s: jnp.sum(jnp.tanh(jenc.apply_spikes(s))))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad(torch.tanh(tenc.apply_spikes(xt)).sum(), xt)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    assert float(got.abs().sum()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    with torch.no_grad():
        out = tenc.apply_spikes(xt)
    assert out.grad_fn is None and out.shape == (6, tenc.n_post)


def test_serving_builds_no_graph():
    nodes, params = make_dhsnn_shd(torch.Generator().manual_seed(0),
                                   n_in=24, n_hidden=8, n_out=3,
                                   device="cpu")
    _requires_grad(params)
    eng = make_engine(nodes, params, EngineConfig(window=4, capacity=2),
                      device="cpu")
    sid = eng.open()
    eng.submit(sid, (np.random.default_rng(0).random((10, 24)) < 0.3)
               .astype(np.float32))
    eng.close(sid)
    assert eng.drain() > 0
    assert eng.outputs(sid).shape == (10, 3)
    for nd in eng.state_of(sid).values():
        for v in nd.values():
            assert v.grad_fn is None and not v.requires_grad


@pytest.fixture
def lif_stand_in(monkeypatch):
    """A recording stand-in for the kernel library (no card here):
    `lif_bwd_f32` returns 0; the wrapper's device checks are skipped."""
    from contextlib import nullcontext
    from unittest import mock
    from repro_torch.kernels.lif import ops as lif_ops
    lib = mock.Mock(**{"lif_bwd_f32.return_value": 0})
    monkeypatch.setattr(lif_ops, "check_scan", lambda *a: None)
    monkeypatch.setattr(lif_ops, "check_planes", lambda *a: None)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    registry.reset_launches()
    yield lib
    registry.reset_launches()


@pytest.mark.parametrize("surrogate", SURROGATES)
def test_lif_bwd_wrapper_passes_the_kernel_its_arguments(lif_stand_in,
                                                         surrogate):
    """With a recording stand-in for the library (no card here),
    `lif_bwd_cuda` hands `lif_bwd_f32` the inputs' pointers, no checkpoint
    scratch within one segment, the (B, N) partials scratch and a counter
    for g_tau, the outputs' pointers (g_tau is the (N,) tensor the kernel
    sums into: nothing is launched after it), the shape, the reset, the
    surrogate's index in sorted names and alpha; null pointers for the
    gradients not asked for; counts one launch."""
    from repro_torch.kernels.lif import ops as lif_ops
    T, B, N = 60, 48, 64
    plane, lane = torch.zeros((T, B, N)), torch.zeros((B, N))
    tau = torch.ones(N)
    g_cur, g_tau, g_v0 = lif_ops.lif_bwd_cuda(
        plane, tau, lane, plane, plane, lane, 1.0, surrogate, 2.0,
        "subtract")
    (call,) = lif_stand_in.lif_bwd_f32.call_args_list
    a = call.args
    assert a[:6] == (plane.data_ptr(), tau.data_ptr(), lane.data_ptr(),
                     plane.data_ptr(), plane.data_ptr(), lane.data_ptr())
    assert a[6] is None and a[7] is not None and a[8] is not None
    assert a[9:12] == (g_cur.data_ptr(), g_tau.data_ptr(), g_v0.data_ptr())
    assert a[12:] == (T, B, N, 1.0, 1, SURROGATES.index(surrogate), 2.0, 0)
    assert g_cur.shape == (T, B, N) and g_tau.shape == (N,)
    assert g_v0.shape == (B, N)
    assert registry.launch_counts()["lif_bwd"] == 1
    g_cur, g_tau, g_v0 = lif_ops.lif_bwd_cuda(
        plane, tau, lane, plane, plane, lane, 1.0, surrogate, 2.0, "zero",
        need_tau=False, need_v0=False)
    a = lif_stand_in.lif_bwd_f32.call_args_list[1].args
    assert a[7] is None and a[8] is None and a[10] is None and a[11] is None
    assert g_tau is None and g_v0 is None and a[16] == 0
    assert registry.launch_counts()["lif_bwd"] == 2
    with pytest.raises(ValueError, match="unknown surrogate"):
        lif_ops.lif_bwd_cuda(plane, tau, lane, plane, plane, lane, 1.0,
                             "nope")


@pytest.mark.parametrize("T", (1, SEG - 1, SEG, SEG + 1, 2 * SEG + 5))
def test_lif_bwd_checkpoints_only_past_one_segment(lif_stand_in, T):
    """The checkpoint scratch exists only for a call of more than one
    segment, and then holds a v a segment and lane; beside it only the
    (B, N) partials of g_tau are allocated for the kernel (no (T, B, N)
    scratch plane)."""
    from repro_torch.kernels.lif import ops as lif_ops
    B, N = 48, 64
    cur, s, gs = (torch.zeros((T, B, N)) for _ in range(3))
    v0, gv = torch.zeros((B, N)), torch.zeros((B, N))
    sizes = []
    real = torch.empty

    def empty(*shape, **kw):
        sizes.append(tuple(shape[0]) if len(shape) == 1 else shape)
        return real(*shape, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "empty", empty)
        lif_ops.lif_bwd_cuda(cur, torch.ones(N), v0, s, gs, gv, 1.0,
                             "sigmoid", 4.0)
    (call,) = lif_stand_in.lif_bwd_f32.call_args_list
    segs = -(-T // SEG)
    assert (call.args[6] is None) == (segs == 1)
    assert sizes == ([] if segs == 1 else [(segs, B, N)]) + [(B, N)]


def _linrec_bwd_stand_in(monkeypatch):
    """A recording stand-in for the library's `linrec_bwd_f32` (no card
    here), the wrapper's device checks off."""
    from contextlib import nullcontext
    from unittest import mock
    from repro_torch.kernels.linrec import ops as lin_ops
    lib = mock.Mock(**{"linrec_bwd_f32.return_value": 0})
    monkeypatch.setattr(lin_ops, "_check", lambda *a: None)
    monkeypatch.setattr(lin_ops, "check_planes", lambda *a: None)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    return lib


@pytest.mark.parametrize("need_a,need_h0", [(True, True), (False, False),
                                            (True, False)])
def test_linrec_bwd_wrapper_passes_the_kernel_its_arguments(
        monkeypatch, need_a, need_h0):
    """`linrec_bwd_cuda` hands `linrec_bwd_f32` the decay's strides (0 where
    broadcast: never materialised), null pointers for the gradients not
    asked for, the full plane's N = D, no scratch for a g_a plane (a
    decay handed as a (T, B, D) view keeps its (T, B, D) g_a), and counts
    one launch."""
    from repro_torch.kernels.linrec import ops as lin_ops
    lib = _linrec_bwd_stand_in(monkeypatch)
    T, B, D = 60, 48, 256
    a = torch.rand(D).expand(T, B, D)
    y, h = torch.zeros((T, B, D)), torch.zeros((B, D))
    registry.reset_launches()
    g_a, g_x, g_h0 = lin_ops.linrec_bwd_cuda(a, y, h, y, h, need_a, need_h0)
    (call,) = lib.linrec_bwd_f32.call_args_list
    assert call.args[1:4] == (0, 0, 1)
    assert call.args[6] == y.data_ptr() and call.args[7] == h.data_ptr()
    assert call.args[8] is None and call.args[9] is None
    assert (call.args[11] is None) == (not need_a)
    assert (call.args[12] is None) == (not need_h0)
    assert call.args[13:18] == (T, B, D, D, 0)
    assert (g_a is None) == (not need_a) and (g_h0 is None) == (not need_h0)
    assert g_x.shape == (T, B, D)
    assert g_a is None or g_a.shape == (T, B, D)
    assert registry.launch_counts()["linrec_bwd"] == 1
    registry.reset_launches()


@pytest.mark.parametrize("with_hT", [True, False])
def test_linrec_bwd_wrapper_takes_the_soma_cotangent(monkeypatch, with_hT):
    """The branch call (`linrec_branches`' backward): one launch that gets
    the soma's (T, B, N) cotangent itself (its pointer; N, from which the
    kernel reads K = D / N branches of it), g_hT or a null pointer, a
    (B, D) scratch of partials and a zeroed counter, and returns g_a in
    the decay's (K N,) shape, summed by the kernel (flag 1)."""
    from repro_torch.kernels.linrec import ops as lin_ops
    lib = _linrec_bwd_stand_in(monkeypatch)
    T, B, K, N = 60, 48, 4, 64
    D = K * N
    a = torch.rand(D)
    y, h = torch.zeros((T, B, D)), torch.zeros((B, D))
    g_soma = torch.zeros((T, B, N))
    g_hT = torch.zeros((B, D)) if with_hT else None
    registry.reset_launches()
    g_a, g_x, g_h0 = lin_ops.linrec_bwd_cuda(a, y, h, g_soma, g_hT)
    (call,) = lib.linrec_bwd_f32.call_args_list
    assert call.args[0] == a.data_ptr() and call.args[1:4] == (0, 0, 1)
    assert call.args[6] == g_soma.data_ptr()
    assert call.args[7] == (g_hT.data_ptr() if with_hT else None)
    assert call.args[8] is not None and call.args[9] is not None
    assert call.args[10:13] == (g_x.data_ptr(), g_a.data_ptr(),
                                g_h0.data_ptr())
    assert call.args[13:18] == (T, B, D, N, 1)
    assert g_a.shape == (D,) and g_x.shape == (T, B, D)
    assert g_h0.shape == (B, D)
    assert registry.launch_counts()["linrec_bwd"] == 1
    registry.reset_launches()
    with pytest.raises(ValueError, match="N dividing D"):
        lin_ops.linrec_bwd_cuda(a, y, h, torch.zeros((T, B, 48)), g_hT)


def _bits(t):
    return t.detach().contiguous().view(torch.int32)


@pytest.mark.parametrize("with_hT", [True, False])
@pytest.mark.parametrize("T", [1, 23, SEG + 5])
def test_linrec_branches_matches_the_parent_formulation(T, with_hT):
    """`linrec_branches`, the DH-LIF prologue as one Function: its forward
    equals `linrec` then the fixed-order branch sum bit for bit; its g_x
    equals `linrec_bwd_ref` on the materialised K-fold cotangent plane bit
    for bit (the autograd of the sum only handed every branch the soma's
    cotangent); g_a, now summed in the kernel's order, and g_h0 agree with
    autograd through the parent formulation within 1e-6 relative. An
    unused final state gives a zero g_hT."""
    rng = np.random.default_rng(T)
    B, K, N = 3, 4, 10
    D = K * N
    a_np = rng.uniform(0.5, 0.99, D).astype(np.float32)
    x_np = rng.standard_normal((T, B, D)).astype(np.float32)
    h_np = rng.standard_normal((B, D)).astype(np.float32)
    gs = torch.from_numpy(rng.standard_normal((T, B, N)).astype(np.float32))
    ghT = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32))

    def leaves():
        return [torch.from_numpy(v.copy()).requires_grad_()
                for v in (a_np, x_np, h_np)]
    new = leaves()
    soma, dT = linrec_branches(*new, K)
    old = leaves()
    y, hT = linrec(old[0].expand(T, B, D), old[1], old[2])
    d4 = y.reshape(T, B, K, N)
    parent = d4[:, :, 0]
    for k in range(1, K):
        parent = parent + d4[:, :, k]
    assert torch.equal(_bits(soma), _bits(parent))
    assert torch.equal(_bits(dT), _bits(hT))
    outs_new, outs_old = ((soma, dT), (parent, hT)) if with_hT else (
        (soma,), (parent,))
    cots = (gs, ghT) if with_hT else (gs,)
    g_new = torch.autograd.grad(outs_new, new, cots)
    g_old = torch.autograd.grad(outs_old, old, cots)
    plane = gs[:, :, None, :].expand(T, B, K, N).reshape(T, B, D)
    _, gx_ref, _ = linrec_bwd_ref(
        new[0].detach(), y.detach(), new[2].detach(), plane.contiguous(),
        ghT if with_hT else torch.zeros(B, D))
    assert torch.equal(_bits(g_new[1]), _bits(gx_ref))
    assert torch.equal(g_new[1], g_old[1])
    assert g_new[0].shape == (D,)
    for got, want in ((g_new[0], g_old[0]), (g_new[2], g_old[2])):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(want.abs().max()))


def _backward_nodes(root):
    """The names of the autograd nodes reachable from `root`, itself
    included."""
    seen, todo, names = set(), [root], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo += [nxt for nxt, _ in fn.next_functions]
    return names


def test_dhsnn_step_graph_has_no_branch_plumbing():
    """A DH-SNN training step's graph: the branch call is one
    `_LinRecBranchesBackward` node, fed by the soma's LIF scan directly,
    and nothing under it (toward the leaves) is a select, an expand or a
    sum over (T, B): the parent's four SelectBackward0s (each a zero fill
    and a slice copy, then adds) and the ExpandBackward0 of its decay
    (a sum over T and B) are gone from the branch path."""
    x, y = _shd_data()
    nodes, params = make_dhsnn_shd(torch.Generator().manual_seed(1),
                                   n_hidden=N_HIDDEN, device="cpu")
    _requires_grad(params)
    _, outs, _ = plan.run(nodes, params, torch.from_numpy(x),
                          device="cpu")
    loss = outs.float().pow(2).mean()
    names = _backward_nodes(loss.grad_fn)
    assert names.count("_LinRecBranchesBackward") == 1
    fn = consumer = None
    todo, branch = [loss.grad_fn], set()
    while todo:                         # the branch node, and its consumer
        f = todo.pop()
        if f is None or f in branch:
            continue
        branch.add(f)
        for nxt, _ in f.next_functions:
            if nxt is not None and type(nxt).__name__ == \
                    "_LinRecBranchesBackward":
                fn = nxt
                consumer = type(f).__name__
            todo.append(nxt)
    assert consumer == "_LifScanBackward"
    under = _backward_nodes(fn)
    for bad in ("SelectBackward0", "ExpandBackward0", "SumBackward0",
                "SumBackward1"):
        assert bad not in under, (bad, under)
    assert "SelectBackward0" not in names


def test_run_stream_carries_the_graph_across_chunks():
    """BPTT through `run_stream`: the loss over the streamed chunks'
    outputs has the one-shot `run`'s gradients (the state carried between
    chunks carries their cotangents back)."""
    x, y = _shd_data()
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    grads = []
    for chunks in (1, 2):
        nodes, params = make_dhsnn_shd(torch.Generator().manual_seed(1),
                                       n_hidden=N_HIDDEN, device="cpu")
        _requires_grad(params)
        outs = [o for _, o in plan.run_stream(
            nodes, params, xt.chunk(chunks, dim=0), device="cpu")]
        logits = torch.cat(outs).mean(0)
        loss = -torch.log_softmax(logits, -1)[torch.arange(len(yt)),
                                              yt].mean()
        loss.backward()
        grads.append(dict(_leaves_with_paths(grads_to_numpy(params))))
    for path, g in grads[0].items():
        assert np.abs(g).sum() > 0, path
        np.testing.assert_allclose(grads[1][path], g, rtol=1e-5, atol=1e-7,
                                   err_msg="/".join(path))


# ---------------------------------------------------------------------------
# programs against jax.value_and_grad of the JAX plan.run
# ---------------------------------------------------------------------------


def _assert_grads_match_jax(jn, jp, tn, tp, x, loss_j, loss_t):
    """The loss and every gradient leaf of the port's `plan.run` (params
    `tp`, made to require grad) against `jax.value_and_grad` of the JAX
    `plan.run` on the same weights: the loss within `CROSS_ENGINE_ATOL`
    relative to max(1, |loss|), each leaf within a relative L2 error of
    LEAF_RTOL. Leaves that hold no tensor (a topology) have no gradient."""
    value, grads = jax.value_and_grad(
        lambda p: loss_j(jplan.run(jn, p, jnp.asarray(x))[1]))(jp)
    _requires_grad({k: {n: v for n, v in d.items()
                        if isinstance(v, (torch.Tensor, dict))}
                    for k, d in tp.items()})
    loss = loss_t(plan.run(tn, tp, torch.from_numpy(x), device="cpu")[1])
    loss.backward()
    assert abs(loss.item() - float(value)) <= \
        plan.CROSS_ENGINE_ATOL * max(1.0, abs(float(value)))
    want = {p: np.asarray(g) for p, g in _leaves_with_paths(grads)
            if hasattr(g, "shape")}
    got = {p: t.grad.numpy() for p, t in _leaves_with_paths(tp)
           if isinstance(t, torch.Tensor)}
    assert set(got) == set(want) and want
    for path, w in want.items():
        assert np.abs(w).sum() > 0, path
        rel = np.linalg.norm(got[path] - w) / np.linalg.norm(w)
        assert rel <= LEAF_RTOL, f"{'/'.join(path)}: {rel:.3e}"


@pytest.mark.parametrize("name", ["ff_subtract", "rec_subtract", "ff_plif",
                                  "rec_plif", "back_ref", "self_at_2",
                                  "delayed"])
def test_plan_programs_gradients_match_jax(name):
    """The seven programs of `tests/test_torch_plan.py` (feed-forward and
    self-recurrent subtract reset and PLIF, a back-reference and a
    self-connection two steps late, both on the fallback stepper, and the
    delayed three-layer program): loss mean(out^2), every leaf."""
    from repro.core import neuron as jneuron
    from repro.core.neuron import LI as JLI, LIF as JLIF
    from repro.core.snn_layers import ff_integrate as jff
    from repro_torch.core import neuron
    from repro_torch.core.neuron import LI, LIF
    from repro_torch.core.snn_layers import ff_integrate
    from tests.test_torch_plan import (_delayed_program, _raster,
                                       _six_params, _six_programs)
    if name == "delayed":
        jn, jp, tn, tp = _delayed_program()
        x = _raster(37, 3, 20, 0.3, seed=2)
    else:
        jn = _six_programs(jevents, JLIF, jneuron.PLIF, JLI, jff)[name]
        tn = _six_programs(events, LIF, neuron.PLIF, LI, ff_integrate)[name]
        jp, tp = _six_params(name)
        x = _raster(37, 3, 12, 0.3, seed=22)
    _assert_grads_match_jax(jn, jp, tn, tp, x,
                            lambda o: jnp.mean(jnp.square(o)),
                            lambda o: o.pow(2).mean())


# train_banded at a small size: input -> front (LIF) -> a band of hidden
# LIF (a +-BANDED_SMALL[1] sparse_coo topology) -> readout (LI)
BANDED_SMALL = dict(n_in=48, n=256, band=8, w=0.1, n_out=20, T=16, B=4)


def _train_banded_small():
    """(JAX nodes, JAX params, port nodes, port params, x, y) of the small
    train_banded: each package's LayerNode, Connection(topology=), LIF, LI
    and ff_integrate, the band encoded by each from the same arrays, the
    dense weights from numpy (seed 4)."""
    from repro.core import topology as jtopo
    from repro.core.neuron import LI as JLI, LIF as JLIF
    from repro.core.snn_layers import ff_integrate as jff
    from repro_torch.core import topology as topo
    from repro_torch.core.neuron import LI, LIF
    from repro_torch.core.snn_layers import ff_integrate
    c = BANDED_SMALL
    n, band = c["n"], c["band"]
    rows = np.repeat(np.arange(n), 2 * band + 1)
    cols = rows + np.tile(np.arange(-band, band + 1), n)
    keep = (cols >= 0) & (cols < n)
    coo = (rows[keep], cols[keep], np.full(keep.sum(), c["w"], np.float32))
    rng = np.random.default_rng(4)
    w = {"front": {"w_input": (2.0 / np.sqrt(c["n_in"])) * rng.standard_normal(
            (c["n_in"], n))},
         "hidden": {},
         "readout": {"w_hidden": rng.standard_normal((n, c["n_out"]))
                     / np.sqrt(n)}}
    w = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), w)
    x = (rng.random((c["T"], c["B"], c["n_in"])) < 0.1).astype(np.float32)
    y = rng.integers(0, c["n_out"], c["B"])

    def build(ev, enc, lif, li, ff):
        return [ev.LayerNode("front", lif(tau=0.8, v_th=0.6), ff,
                             ("input",), n),
                ev.LayerNode("hidden", lif(tau=0.8, v_th=0.6), ff,
                             (ev.Connection("front", topology=enc),), n),
                ev.LayerNode("readout", li(tau=0.9), ff, ("hidden",),
                             c["n_out"])]
    jenc = jtopo.encode(coo, kind="sparse_coo", n_pre=n, n_post=n)
    tenc = topo.encode(coo, kind="sparse_coo", n_pre=n, n_post=n)
    return (build(jevents, jenc, JLIF, JLI, jff),
            jax.tree_util.tree_map(jnp.asarray, w),
            build(events, tenc, LIF, LI, ff_integrate),
            params_from_numpy(w, "cpu"), x, y)


def test_train_banded_small_matches_jax():
    """The train_banded program at a small size: both LIF layers fire in
    at least 1 % of their lane-steps, the trains equal the JAX package's,
    and the loss (cross-entropy of the summed readout) and each leaf
    (w_input, w_hidden; the band has none) match `jax.value_and_grad`. The
    gradient of w_input reaches it only through the band's backward."""
    jn, jp, tn, tp, x, y = _train_banded_small()
    _, _, jr = jplan.run(jn, jp, jnp.asarray(x), record=("front", "hidden"))
    with torch.no_grad():
        _, _, tr = plan.run(tn, tp, torch.from_numpy(x),
                            record=("front", "hidden"), device="cpu")
    for layer in ("front", "hidden"):
        ref = np.asarray(jr[layer])
        assert ref.mean() >= 0.01, f"{layer} fires in {ref.mean():.2%}"
        np.testing.assert_array_equal(tr[layer].numpy(), ref,
                                      err_msg=layer)

    def loss_j(o):
        return -jnp.mean(jax.nn.log_softmax(jnp.sum(o, 0))[
            jnp.arange(len(y)), y])

    def loss_t(o):
        return -torch.log_softmax(o.sum(0), -1)[torch.arange(len(y)),
                                                torch.from_numpy(y)].mean()
    _assert_grads_match_jax(jn, jp, tn, tp, x, loss_j, loss_t)
