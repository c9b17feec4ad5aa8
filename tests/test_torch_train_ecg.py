"""Training the ECG SRNN and the ALIF feed-forward net through the port,
held against the JAX package, on the CPU.

* The VJP of `lifrec_scan`, `alif_scan` and `alifrec_scan` against
  `jax.vjp` of the JAX op on the same numpy inputs and cotangents: 4
  surrogates x alpha 0.5, 1, 4 at a prime T = 37, N = 70 and 130, from a
  nonzero v0, a0 and s0, at the families' `KernelSpec.tol` (1e-4: the
  forward relative and absolute, each gradient of the gradient's scale,
  see `_close_to_scale`); `tests/_torch_parity.py::surrogate_edges`
  asserts that no lane-step's reference membrane lies at a window edge
  (the seed of the inputs is one where none does). Each cotangent
  asked for alone is the same tensor, and the backward is asked for no
  other (the `needs_input_grad` pruning).
* The ECG SRNN, heterogeneous (ALIF) and homogeneous (LIF), at the JAX
  test's sizes (n_hidden 32, gen_ecg_qtdb(8, T=160)): the loss and every
  gradient leaf of the port's `plan.run` and `events.run` against
  `jax.value_and_grad` of the JAX ones (the loss within
  `CROSS_ENGINE_ATOL`, each leaf within a relative L2 error of 1e-4, the
  hidden trains under the row-wise tie rule); three clipped-SGD steps
  follow the JAX losses within 1e-4 relative; and the same for the ALIF
  feed-forward program at narrow widths. The sigmoid-alpha-4 gradient is
  the JAX package's, and the default surrogate's is not: `plan.run` hands
  the scans the node's surrogate.
* A port twin of `tests/test_events_and_apps.py::
  test_srnn_ecg_learns_both_variants`: 60 clipped-SGD steps at lr 0.1
  through `plan.run` lower the loss below 0.7x the first.
* The CUDA wrappers `lifrec_bwd_cuda`, `alif_bwd_cuda` and
  `alifrec_bwd_cuda` against a recording stand-in library: pointers,
  shapes, route and surrogate index, null pointers for what is not asked
  for, the partials summed over B, one launch counted.
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
from repro.core.neuron import ALIF as JALIF
from repro.core.neuron import LI as JLI
from repro.core.snn_layers import ff_integrate as jff_integrate
from repro.core.snn_layers import make_srnn_ecg as jmake_srnn_ecg
from repro.kernels.alifrec.ops import alif_scan as jalif_scan
from repro.kernels.alifrec.ops import alifrec_scan as jalifrec_scan
from repro.kernels.lifrec.ops import lifrec_scan as jlifrec_scan
from repro_torch.core import events, plan
from repro_torch.core.neuron import ALIF, LI
from repro_torch.core.snn_layers import ff_integrate, make_srnn_ecg
from repro_torch.data.spikes import gen_ecg_qtdb, gen_shd_spikes
from repro_torch.kernels import registry
from repro_torch.kernels.alifrec.ops import alif_scan, alifrec_scan
from repro_torch.kernels.lifrec.ops import lifrec_scan
from repro_torch.weights import grads_to_numpy, params_from_numpy
from tests._torch_parity import hidden_membrane, surrogate_edges, tie_rule

TOL = 1e-4                       # the families' KernelSpec.tol
LEAF_RTOL = 1e-4                 # relative L2 error of a gradient leaf
SURROGATES = ("arctan", "rectangle", "sigmoid", "triangle")
# the threshold and, for the ALIF pair, the adaptation strength of both
# models this slice trains (`make_srnn_ecg`'s and the ALIF feed-forward
# program's ALIF(beta=0.5)); at the families' default beta = 1.8 a sharp
# surrogate makes the adjoint grow ~(rho - beta g) a step, to |g| ~ 1e4
# at T = 37, where fp32's rounding alone exceeds 1e-4 on small elements
V_TH, BETA = 1.0, 0.5
# the JAX test's ECG sizes
ECG_HIDDEN, ECG_B, ECG_T = 32, 8, 160
# the ALIF feed-forward program at narrow widths
FF_IN, FF_HIDDEN, FF_OUT, FF_B, FF_T = 48, 16, 5, 12, 40


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def _close(got, want, what):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=what)


def _close_to_scale(got, want, what):
    """Within TOL of the reference relative to its largest element (1 at
    least). The adaptive and recurrent adjoints grow under the sharp
    surrogates (rectangle at alpha 0.5, triangle at 4: |g| up to 1e6 at
    T = 37), and there two fp32 orders of the same sums (the JAX
    package's matmul and fused steps, the port's fixed chains) differ by
    more than 1e-4 on elements that cancel to small values, by ~1e-5 of
    the gradient's scale at most."""
    want = np.asarray(want, np.float64)
    err = float(np.abs(_np(got) - want).max()) if want.size else 0.0
    scale = max(1.0, float(np.abs(want).max()) if want.size else 0.0)
    assert err <= TOL * scale, (
        f"{what}: max abs error {err:.3e} > {TOL} x {scale:.3e}")


# ---------------------------------------------------------------------------
# the scans' VJPs
# ---------------------------------------------------------------------------

# per op: (its argument names, the JAX op, the port's op, the statics
# after v_th (beta for the ALIF pair), the state cotangents)
OPS = {
    "lifrec": (("current", "w_rec", "tau", "v0", "s0"), jlifrec_scan,
               lifrec_scan, (), ("g_vT",)),
    "alif": (("current", "tau", "rho", "v0", "a0"), jalif_scan, alif_scan,
             (BETA,), ("g_vT", "g_aT")),
    "alifrec": (("current", "w_rec", "tau", "rho", "v0", "a0", "s0"),
                jalifrec_scan, alifrec_scan, (BETA,), ("g_vT", "g_aT")),
}


def _scan_inputs(op, N, seed=9):
    """The op's inputs and cotangents as numpy: T = 37, B = 3, nonzero
    v0, a0 and a Bernoulli(0.3) s0; a quarter of the lanes driven hard, so
    rows fire in many steps."""
    rng = np.random.default_rng(seed)
    T, B = 37, 3

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    hot = (rng.random((B, N)) < 0.25).astype(np.float32) * 0.6
    pool = {"current": (0.6 * f(T, B, N) + hot).astype(np.float32),
            "w_rec": ((0.4 / np.sqrt(N)) * f(N, N)).astype(np.float32),
            "tau": rng.uniform(0.7, 0.98, N).astype(np.float32),
            "rho": rng.uniform(0.85, 0.99, N).astype(np.float32),
            "v0": (0.3 * f(B, N)).astype(np.float32),
            "a0": rng.uniform(0.0, 0.5, (B, N)).astype(np.float32),
            "s0": (rng.random((B, N)) < 0.3).astype(np.float32)}
    names = OPS[op][0]
    cts = {"g_spikes": f(T, B, N), "g_vT": f(B, N), "g_aT": f(B, N)}
    return [pool[k] for k in names], cts


def _reference_membrane(op, args, spikes):
    """(u, th), each (T, B, N) float64: the reference's pre-reset membrane
    and threshold along its own spikes (the tie rule's margin)."""
    a = dict(zip(OPS[op][0], (np.asarray(x, np.float64) for x in args)))
    s = np.asarray(spikes, np.float64)
    T = s.shape[0]
    v = a["v0"]
    adapt = a.get("a0")
    s_prev = a.get("s0")
    u = np.zeros(s.shape)
    th = np.full(s.shape, V_TH)
    for t in range(T):
        u[t] = a["tau"] * v + a["current"][t]
        if "w_rec" in a:
            u[t] += s_prev @ a["w_rec"]
            s_prev = s[t]
        if adapt is not None:
            th[t] = V_TH + BETA * adapt
            adapt = a["rho"] * adapt + s[t]
        v = u[t] * (1.0 - s[t])
    return u, th


@functools.lru_cache(maxsize=None)
def _jax_vjp(op, N, surrogate, alpha):
    """The JAX op's outputs and VJP on `_scan_inputs`, as numpy."""
    names, jop, _, statics, ct_names = OPS[op]
    args, cts = _scan_inputs(op, N)

    @jax.jit
    def outs_and_grads(args, cts):
        outs, vjp = jax.vjp(
            lambda *a: jop(*a, V_TH, *statics, surrogate, alpha), *args)
        return outs, vjp((cts["g_spikes"], *(cts[k] for k in ct_names)))
    outs, grads = outs_and_grads(list(map(jnp.asarray, args)),
                                 {k: jnp.asarray(v) for k, v in cts.items()})
    return ([np.asarray(o) for o in outs], [np.asarray(g) for g in grads])


def _port_vjp(op, N, surrogate, alpha, wrt=None):
    """The port's outputs and the gradients of the arguments in `wrt`
    (indices; all by default), on `_scan_inputs`."""
    names, _, top, statics, ct_names = OPS[op]
    args, cts = _scan_inputs(op, N)
    wrt = range(len(names)) if wrt is None else wrt
    t_args = [torch.from_numpy(a) for a in args]
    for i in wrt:
        t_args[i].requires_grad_()
    outs = top(*t_args, V_TH, *statics, surrogate, alpha)
    grads = torch.autograd.grad(
        outs, [t_args[i] for i in wrt],
        (torch.from_numpy(cts["g_spikes"]),
         *(torch.from_numpy(cts[k]) for k in ct_names)))
    return outs, grads


@pytest.mark.parametrize("N", (70, 130))
@pytest.mark.parametrize("alpha", (0.5, 1.0, 4.0))
@pytest.mark.parametrize("surrogate", SURROGATES)
@pytest.mark.parametrize("op", tuple(OPS))
def test_scan_vjp_matches_jax(op, surrogate, alpha, N):
    outs_j, grads_j = _jax_vjp(op, N, surrogate, alpha)
    outs_t, grads_t = _port_vjp(op, N, surrogate, alpha)
    np.testing.assert_array_equal(_np(outs_t[0]), outs_j[0])
    for i, (got, want) in enumerate(zip(outs_t[1:], outs_j[1:])):
        _close(got, want, f"final state {i}")
    args, _ = _scan_inputs(op, N)
    u, th = _reference_membrane(op, args, outs_j[0])
    edges = surrogate_edges(u, th, surrogate, alpha)
    assert not edges.any(), f"{int(edges.sum())} lane-steps at a window edge"
    for name, got, want in zip(OPS[op][0], grads_t, grads_j):
        assert got.shape == want.shape, name
        _close_to_scale(got, want, f"g_{name}")


def _asked(monkeypatch, op):
    """Record the `need_*` flags each backward call of `op` is given."""
    asked = []
    spec = registry.get(op)

    def recording(*args, _plain=spec.bwd.plain, **kw):
        asked.append({k: v for k, v in kw.items() if k.startswith("need_")})
        return _plain(*args, **kw)
    monkeypatch.setattr(registry, "_REGISTRY", {
        **registry._REGISTRY, op: dataclasses.replace(
            spec, bwd=dataclasses.replace(spec.bwd, plain=recording))})
    return asked


@pytest.mark.parametrize("op,arg", [(op, i) for op in OPS
                                    for i in range(len(OPS[op][0]))])
def test_each_cotangent_alone_is_the_same(op, arg, monkeypatch):
    """Asked for one gradient, the Function computes that one: the
    backward is handed need_* flags for the others False (g_current is
    the chain itself and always computed) and the gradient equals the
    one computed with all the others, bit for bit."""
    _, all_grads = _port_vjp(op, 70, "sigmoid", 4.0)
    asked = _asked(monkeypatch, op)
    _, (alone,) = _port_vjp(op, 70, "sigmoid", 4.0, wrt=[arg])
    assert torch.equal(alone, all_grads[arg])
    name = OPS[op][0][arg]
    (flags,) = asked
    assert flags == {f"need_{k}": k == name for k in OPS[op][0]
                     if k not in ("current", "w_rec")}


def test_recurrent_g_w_goes_through_the_spike_product(monkeypatch):
    """g_W of a self-recurrent scan is spikemm's weight gradient on the
    (T * B, N) raster shifted one step, [s0; s_0 .. s_{T-2}], handed over
    as s0 (`head`) and the spikes plane, not concatenated: one dispatch
    to spikemm's backward pair and none to its forward, and it is the JAX
    package's g_W."""
    calls, g_w_calls = [], []
    spec = registry.get("spikemm")

    def counting(s, w, _plain=spec.plain):
        calls.append((tuple(s.shape), tuple(w.shape)))
        return _plain(s, w)

    def counting_bwd(s, g, head=None, _plain=spec.bwd.plain):
        g_w_calls.append((tuple(s.shape), tuple(g.shape),
                          None if head is None else tuple(head.shape)))
        return _plain(s, g, head=head)
    monkeypatch.setattr(registry, "_REGISTRY", {
        **registry._REGISTRY, "spikemm": dataclasses.replace(
            spec, plain=counting, bwd=dataclasses.replace(
                spec.bwd, plain=counting_bwd))})
    monkeypatch.setenv("REPRO_SPIKEMM_SPARSE", "never")
    outs, (g_w,) = _port_vjp("lifrec", 70, "sigmoid", 4.0, wrt=[1])
    assert calls == []
    assert g_w_calls == [((37 * 3, 70), (37 * 3, 70), (3, 70))]
    _, grads_j = _jax_vjp("lifrec", 70, "sigmoid", 4.0)
    _close_to_scale(g_w, grads_j[1], "g_w_rec")


# ---------------------------------------------------------------------------
# the ECG SRNN and the ALIF feed-forward net end to end
# ---------------------------------------------------------------------------


def _ecg_data():
    xs, ys = gen_ecg_qtdb(ECG_B, T=ECG_T)
    return (np.ascontiguousarray(xs.transpose(1, 0, 2)),
            np.ascontiguousarray(ys.T))


def _ff_data():
    xs, ys = gen_shd_spikes(FF_B, T=FF_T, n_in=FF_IN, n_classes=FF_OUT)
    return np.ascontiguousarray(xs.transpose(1, 0, 2)), ys


def _jax_ff_model():
    """The ALIF feed-forward program of `chip_smoke.make_alif_ff` (700 ->
    64 ALIF(beta=0.5) -> 20 LI(tau=0.97)) at narrow widths."""
    rng = np.random.default_rng(3)
    nodes = [jevents.LayerNode("hidden", JALIF(beta=0.5), jff_integrate,
                               ("input",), FF_HIDDEN),
             jevents.LayerNode("readout", JLI(tau=0.97), jff_integrate,
                               ("hidden",), FF_OUT)]
    neuron = JALIF(beta=0.5).param_init(jax.random.PRNGKey(4), (FF_HIDDEN,))
    params = {"hidden": {"w_input": (3.0 * rng.standard_normal(
        (FF_IN, FF_HIDDEN)) / np.sqrt(FF_IN)).astype(np.float32),
        "neuron": jax.tree_util.tree_map(np.asarray, neuron)},
        "readout": {"w_hidden": (rng.standard_normal(
            (FF_HIDDEN, FF_OUT)) / 4.0).astype(np.float32)}}
    return nodes, params


def _port_ff_nodes():
    return [events.LayerNode("hidden", ALIF(beta=0.5), ff_integrate,
                             ("input",), FF_HIDDEN),
            events.LayerNode("readout", LI(tau=0.97), ff_integrate,
                             ("hidden",), FF_OUT)]


def _ecg_loss_jax(nodes, x, y, run):
    def loss(p):
        _, outs, _ = run(nodes, p, x)
        logp = jax.nn.log_softmax(outs, -1)
        return -jnp.mean(jnp.take_along_axis(logp, y[..., None], -1))
    return loss


def _ff_loss_jax(nodes, x, y, run):
    def loss(p):
        _, outs, _ = run(nodes, p, x)
        logits = jnp.mean(outs, 0)
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(len(y)), y])
    return loss


def _ecg_loss(nodes, params, x, y, run):
    _, outs, _ = run(nodes, params, x, device="cpu")
    return -torch.log_softmax(outs, -1).gather(-1, y[..., None]).mean()


def _ff_loss(nodes, params, x, y, run):
    _, outs, _ = run(nodes, params, x, device="cpu")
    logits = outs.mean(0)
    return -torch.log_softmax(logits, -1)[torch.arange(len(y)), y].mean()


MODELS = {
    "heterogeneous": ("ecg", True),
    "homogeneous": ("ecg", False),
    "alif_ff": ("ff", None),
}


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


def _grads_tree(params):
    if isinstance(params, dict):
        return {k: _grads_tree(v) for k, v in params.items()
                if v is not None}
    return params.grad


def _clipped_sgd(params, lr):
    """`examples/ecg_srnn.py`'s update: SGD with the global gradient norm
    clipped to 1."""
    leaves = list(_leaves_with_paths(params))
    gn = torch.sqrt(sum((p.grad ** 2).sum() for _, p in leaves))
    sc = torch.clamp_max(1.0 / (gn + 1e-9), 1.0)
    with torch.no_grad():
        for _, p in leaves:
            p -= lr * sc * p.grad
            p.grad = None


def _jax_sgd(params, grads, lr):
    gn = jnp.sqrt(sum(jnp.sum(jnp.square(g))
                      for g in jax.tree.leaves(grads)))
    sc = jnp.minimum(1.0, 1.0 / (gn + 1e-9))
    return jax.tree.map(lambda p, g: p - lr * sc * g, params, grads)


@functools.lru_cache(maxsize=None)
def _reference(model, engine):
    """The JAX model, its numpy weights and data, the losses and gradient
    trees of clipped-SGD steps at lr 0.1 (three through `plan.run`, one
    through `events.run`), and the recorded hidden spikes of the first
    forward."""
    steps = 3 if engine == "plan" else 1
    kind, het = MODELS[model]
    if kind == "ecg":
        jn, jp = jmake_srnn_ecg(jax.random.PRNGKey(0), heterogeneous=het,
                                n_hidden=ECG_HIDDEN)
        x, y = _ecg_data()
        make_loss = _ecg_loss_jax
    else:
        jn, jp = _jax_ff_model()
        x, y = _ff_data()
        make_loss = _ff_loss_jax
    run = jplan.run if engine == "plan" else jevents.run
    vg = jax.jit(jax.value_and_grad(make_loss(jn, jnp.asarray(x),
                                              jnp.asarray(y), run)))
    p0 = jax.tree_util.tree_map(np.asarray, jp)
    # jitted: an eager first run compiles each primitive on its own
    _, _, rec = jax.jit(lambda p: run(jn, p, jnp.asarray(x),
                                      record=("hidden",)))(jp)
    losses, grads = [], []
    p = jp
    for _ in range(steps):
        loss, g = vg(p)
        losses.append(float(loss))
        grads.append(jax.tree_util.tree_map(np.asarray, g))
        p = _jax_sgd(p, g, 0.1)
    return jn, p0, x, y, losses, grads, np.asarray(rec["hidden"])


def _port_model(model, p0):
    kind, het = MODELS[model]
    if kind == "ecg":
        tn, _ = make_srnn_ecg(torch.Generator().manual_seed(0),
                              heterogeneous=het, n_hidden=ECG_HIDDEN,
                              device="cpu")
    else:
        tn = _port_ff_nodes()
    loss = _ecg_loss if kind == "ecg" else _ff_loss
    return tn, _requires_grad(params_from_numpy(p0, "cpu")), loss


def _hidden_check(tn, p0, x, spikes_ref, spikes_got):
    """The hidden trains under the tie rule (row-wise where recurrent);
    returns the hidden lane-steps at a surrogate window edge."""
    hp = {k: np.asarray(v) for k, v in p0["hidden"].items()
          if k != "neuron"}
    hp["neuron"] = p0["hidden"].get("neuron")
    u, th = hidden_membrane(tn[0], hp, x, spikes_ref)
    rowwise = any(c.src == "self" for c in tn[0].connections)
    tie_rule(spikes_ref, spikes_got, u, th, rowwise=rowwise)
    return surrogate_edges(u, th, tn[0].neuron.surrogate, tn[0].neuron.alpha)


def _assert_leaves(got_tree, want_tree, edges):
    got = dict(_leaves_with_paths(got_tree))
    want = dict(_leaves_with_paths(want_tree))
    assert set(got) == set(want)
    for path, w in want.items():
        rel = np.linalg.norm(got[path] - w) / np.linalg.norm(w)
        assert rel <= LEAF_RTOL, (
            f"{'/'.join(path)}: relative L2 error {rel:.3e} "
            f"({int(edges.sum())} hidden lane-steps at a window edge)")


@pytest.mark.parametrize("engine", ("plan", "events"))
@pytest.mark.parametrize("model", tuple(MODELS))
def test_loss_and_gradients_match_jax(model, engine):
    jn, p0, x, y, losses, grads, spikes_ref = _reference(model, engine)
    tn, tp, loss_fn = _port_model(model, p0)
    run = plan.run if engine == "plan" else events.run
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    loss = loss_fn(tn, tp, xt, yt, run)
    loss.backward()
    assert abs(loss.item() - losses[0]) <= plan.CROSS_ENGINE_ATOL
    with torch.no_grad():
        _, _, rec = run(tn, tp, xt, record=("hidden",), device="cpu")
    edges = _hidden_check(tn, p0, x, spikes_ref, rec["hidden"].numpy())
    _assert_leaves(grads_to_numpy(tp), grads[0], edges)


def test_ecg_gradient_needs_the_node_surrogate():
    """The heterogeneous ECG SRNN trains under sigmoid alpha = 4: through
    `plan.run` its gradient is the JAX package's, and the same model
    under the default surrogate (rectangle, alpha 1: what the scans would
    compute if the plan did not hand them the node's) is another
    gradient, though the forward is the same."""
    jn, p0, x, y, losses, grads, _ = _reference("heterogeneous", "plan")
    tn, tp, loss_fn = _port_model("heterogeneous", p0)
    assert (tn[0].neuron.surrogate, tn[0].neuron.alpha) == ("sigmoid", 4.0)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    loss_fn(tn, tp, xt, yt, plan.run).backward()
    _assert_leaves(grads_to_numpy(tp), grads[0], np.zeros(1, bool))
    default = [dataclasses.replace(tn[0], neuron=dataclasses.replace(
        tn[0].neuron, surrogate="rectangle", alpha=1.0))] + tn[1:]
    _, tp_d, _ = _port_model("heterogeneous", p0)
    loss_d = loss_fn(default, tp_d, xt, yt, plan.run)
    loss_d.backward()
    assert abs(loss_d.item() - losses[0]) <= plan.CROSS_ENGINE_ATOL
    got = dict(_leaves_with_paths(grads_to_numpy(tp_d)))
    want = dict(_leaves_with_paths(grads[0]))
    rel = {"/".join(k): np.linalg.norm(got[k] - w) / np.linalg.norm(w)
           for k, w in want.items()}
    assert rel["hidden/w_self"] > 1e-2 and rel["hidden/w_input"] > 1e-2, rel


@pytest.mark.parametrize("model", tuple(MODELS))
def test_three_sgd_steps_follow_jax(model):
    _, p0, x, y, losses, _, _ = _reference(model, "plan")
    tn, tp, loss_fn = _port_model(model, p0)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    got = []
    for _ in range(3):
        loss = loss_fn(tn, tp, xt, yt, plan.run)
        loss.backward()
        got.append(loss.item())
        _clipped_sgd(tp, 0.1)
    np.testing.assert_allclose(got, losses, rtol=1e-4)


@pytest.mark.parametrize("heterogeneous", (True, False),
                         ids=("heterogeneous", "homogeneous"))
def test_port_srnn_ecg_learns(heterogeneous):
    """The port's twin of `test_srnn_ecg_learns_both_variants`: 60
    clipped-SGD steps at lr 0.1 through `plan.run` on the JAX test's data
    and sizes (weights from the port's own generator)."""
    x, y = _ecg_data()
    nodes, params = make_srnn_ecg(torch.Generator().manual_seed(0),
                                  heterogeneous=heterogeneous,
                                  n_hidden=ECG_HIDDEN, device="cpu")
    _requires_grad(params)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    losses = []
    for _ in range(60):
        loss = _ecg_loss(nodes, params, xt, yt, plan.run)
        loss.backward()
        losses.append(loss.item())
        _clipped_sgd(params, 0.1)
    assert all(np.isfinite(losses))
    assert losses[-1] < 0.7 * losses[0], losses


# ---------------------------------------------------------------------------
# the warp route's padded rows
# ---------------------------------------------------------------------------


def _pad(x, n, axes):
    """x zero-padded to n along each of `axes`."""
    out = x.new_zeros([n if i in axes else d for i, d in enumerate(x.shape)])
    out[tuple(slice(0, d) for d in x.shape)] = x
    return out


@pytest.mark.parametrize("N", (33, 63, 64, 65))
@pytest.mark.parametrize("surrogate", ("arctan", "triangle"))
@pytest.mark.parametrize("op", ("lifrec", "alifrec"))
def test_warp_route_padding_changes_no_bit(op, surrogate, N):
    """`csrc/rec_bwd.cu`'s warp route gives a row KP = 32 ceil(N / 32)
    threads and sums each rec_t over all KP terms, W's and Gu's zero past
    N. Those +0 terms change no bit of a sum that starts at +0: the plain
    version on the row padded to KP neurons with no weights, input, state
    or cotangent equals it on the row itself, every output sliced to N
    (one batch row has zero cotangents, so its terms are +-0). The
    surrogates are the ones whose plain arithmetic is the same in every
    lane of a CPU vector: PyTorch's sigmoid may round an element one way
    in a vector lane and another in the scalar tail."""
    from repro_torch.kernels.alifrec.ref import (alifrec_scan_bwd_ref,
                                                 alifrec_scan_ref)
    from repro_torch.kernels.lifrec.ref import (lifrec_scan_bwd_ref,
                                                lifrec_scan_ref)
    rng = np.random.default_rng(28 + N)
    T, B, KP = 37, 3, 32 * -(-N // 32)

    def f32(*shape, lo=0.0, hi=1.0):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32))

    cur = f32(T, B, N, lo=-0.6, hi=1.4)
    w = f32(N, N, lo=-0.5, hi=0.5) / N ** 0.5
    tau, rho = f32(N, lo=0.7, hi=0.98), f32(N, lo=0.85, hi=0.99)
    v0, a0 = f32(B, N, lo=-0.3, hi=0.9), f32(B, N, hi=0.5)
    s0 = (f32(B, N) < 0.3).float()
    gs, gv, ga = f32(T, B, N, lo=-1), f32(B, N, lo=-1), f32(B, N, lo=-1)
    for g in (gs, gv, ga):
        g[..., 1, :] = 0.0
    kw = dict(v_th=V_TH, surrogate=surrogate, alpha=4.0)
    if op == "lifrec":
        s, _ = lifrec_scan_ref(cur, w, tau, v0, s0)
        args = [cur, w, tau, v0, s0, s, gs, gv]
        bwd = lifrec_scan_bwd_ref
    else:
        kw["beta"] = BETA
        s = alifrec_scan_ref(cur, w, tau, rho, v0, a0, s0, beta=BETA)[0]
        args = [cur, w, tau, rho, v0, a0, s0, s, gs, gv, ga]
        bwd = alifrec_scan_bwd_ref
    want = bwd(*args, **kw)
    got = bwd(*[_pad(a, KP, {a.dim() - 1} if a is not w else {0, 1})
                for a in args], **kw)
    assert len(got) == len(want)
    for g, r in zip(got, want):
        g = g[..., :N]
        assert torch.equal(g.view(torch.int32), r.view(torch.int32))


# ---------------------------------------------------------------------------
# the CUDA wrappers, against a stand-in library
# ---------------------------------------------------------------------------


@pytest.fixture
def stand_in_library(monkeypatch):
    """A recording stand-in for the kernel library (no card here): every
    C entry point returns 0; the wrappers' device checks are skipped."""
    from contextlib import nullcontext
    from unittest import mock
    from repro_torch.kernels import _build
    from repro_torch.kernels.alifrec import ops as alif_ops
    from repro_torch.kernels.lifrec import ops as lifrec_ops
    lib = mock.Mock(**{f"{k}.return_value": 0 for k in (
        "lifrec_bwd_f32", "alifrec_bwd_f32", "alif_bwd_f32")})
    for mod in (alif_ops, lifrec_ops):
        monkeypatch.setattr(mod, "check_scan", lambda *a: None)
        monkeypatch.setattr(mod, "check_planes", lambda *a: None)
    monkeypatch.setattr(alif_ops, "sm_count", lambda dev: 132)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    registry.reset_launches()
    yield lib
    registry.reset_launches()


def _ptrs(*ts):
    return tuple(t.data_ptr() for t in ts)


@pytest.mark.parametrize("N", (64, 130))
@pytest.mark.parametrize("surrogate", SURROGATES)
def test_lifrec_bwd_wrapper_passes_the_kernel_its_arguments(
        stand_in_library, surrogate, N):
    """`lifrec_bwd_cuda` hands `lifrec_bwd_f32` the inputs' pointers, W^T
    (a contiguous copy), the shape, the surrogate's index in sorted names,
    alpha and the route of `rec_route(N)`; a null pointer for g_s0 when
    not asked for; sums the per-lane g_tau partials over B; counts one
    launch on the registry and on the route's counter."""
    from repro_torch.kernels import common
    from repro_torch.kernels.lifrec import ops
    T, B = 200, 16
    cur, s, gs = (torch.zeros((T, B, N)) for _ in range(3))
    w = torch.randn((N, N))
    tau, v0, s0, gv = torch.ones(N), *(torch.zeros((B, N)) for _ in range(3))
    before = common.rec_route_launch_counts()["lifrec_bwd"]
    g_cur, g_tau, g_v0, g_s0 = ops.lifrec_bwd_cuda(
        cur, w, tau, v0, s0, s, gs, gv, 1.0, surrogate, 4.0, need_s0=False)
    (call,) = stand_in_library.lifrec_bwd_f32.call_args_list
    a = call.args
    assert a[:2] == _ptrs(cur, w) and a[3:9] == _ptrs(tau, v0, s0, s, gs, gv)
    assert a[2] not in (w.data_ptr(), None) and a[9] is not None
    assert a[10] == g_cur.data_ptr() and a[11] is not None
    assert a[12] == g_v0.data_ptr() and a[13] is None and g_s0 is None
    warp = int(common.rec_route(N) == common.REC_WARP)
    assert a[14:21] == (T, B, N, 1.0, SURROGATES.index(surrogate), 4.0, warp)
    assert g_tau.shape == (N,) and g_cur.shape == (T, B, N)
    assert registry.launch_counts()["lifrec_bwd"] == 1
    after = common.rec_route_launch_counts()["lifrec_bwd"]
    route = common.rec_route(N)
    assert after[route] == before[route] + 1


def test_alifrec_bwd_wrapper_passes_the_kernel_its_arguments(
        stand_in_library):
    """`alifrec_bwd_cuda` hands `alifrec_bwd_f32` rho, a0 and g_aT, two
    scratch planes, null pointers for the gradients not asked for, beta,
    the surrogate index and the route; sums g_tau and g_rho over B."""
    from repro_torch.kernels import common
    from repro_torch.kernels.alifrec import ops
    T, B, N = 200, 16, 64
    cur, s, gs = (torch.zeros((T, B, N)) for _ in range(3))
    w, tau, rho = torch.randn((N, N)), torch.ones(N), torch.ones(N)
    v0, a0, s0, gv, ga = (torch.zeros((B, N)) for _ in range(5))
    g_cur, g_tau, g_rho, g_v0, g_a0, g_s0 = ops.alifrec_bwd_cuda(
        cur, w, tau, rho, v0, a0, s0, s, gs, gv, ga, 1.0, 0.5, "sigmoid",
        4.0, need_v0=False, need_a0=False, need_s0=False)
    (call,) = stand_in_library.alifrec_bwd_f32.call_args_list
    a = call.args
    assert a[:2] == _ptrs(cur, w) and a[3:12] == _ptrs(
        tau, rho, v0, a0, s0, s, gs, gv, ga)
    assert a[12] is not None and a[13] is not None and a[12] != a[13]
    assert a[14] == g_cur.data_ptr()
    assert a[15] is not None and a[16] is not None
    assert a[17:20] == (None, None, None)
    assert a[20:28] == (T, B, N, 1.0, 0.5, SURROGATES.index("sigmoid"), 4.0,
                        int(common.rec_route(N) == common.REC_WARP))
    assert g_tau.shape == g_rho.shape == (N,)
    assert g_v0 is None and g_a0 is None and g_s0 is None
    assert registry.launch_counts()["alifrec_bwd"] == 1


def test_alif_bwd_wrapper_passes_the_kernel_its_arguments(stand_in_library):
    """`alif_bwd_cuda` hands `alif_bwd_f32` its planes, a checkpoint
    scratch of (segments, 2, B, N) for a call over one segment, a (2, B,
    N) scratch of partials and a zeroed counter for g_tau and g_rho (N,),
    which the kernel sums over B, the surrogate index and alpha; refuses a
    surrogate the kernel does not compute."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.alifrec import ops
    T, B, N = 250, 64, 64
    cur, s, gs = (torch.zeros((T, B, N)) for _ in range(3))
    tau, rho = torch.ones(N), torch.ones(N)
    v0, a0, gv, ga = (torch.zeros((B, N)) for _ in range(4))
    g_cur, g_tau, g_rho, g_v0, g_a0 = ops.alif_bwd_cuda(
        cur, tau, rho, v0, a0, s, gs, gv, ga, 1.0, 0.5, "triangle", 2.0,
        need_rho=False)
    (call,) = stand_in_library.alif_bwd_f32.call_args_list
    a = call.args
    assert a[:9] == _ptrs(cur, tau, rho, v0, a0, s, gs, gv, ga)
    assert T > _build.LANE_BWD_SEG and a[9] is not None
    assert a[10] is not None and a[11] is not None
    assert a[12] == g_cur.data_ptr() and a[13] == g_tau.data_ptr()
    assert a[14] is None
    assert a[15] == g_v0.data_ptr() and a[16] == g_a0.data_ptr()
    assert a[17:] == (T, B, N, 1.0, 0.5, SURROGATES.index("triangle"), 2.0,
                      0)
    assert g_tau.shape == (N,) and g_rho is None
    assert registry.launch_counts()["alif_bwd"] == 1
    with pytest.raises(ValueError, match="unknown surrogate"):
        ops.alif_bwd_cuda(cur, tau, rho, v0, a0, s, gs, gv, ga, 1.0, 0.5,
                          "nope")


@pytest.mark.parametrize("T", (1, 60, 64, 65, 200))
def test_alif_bwd_checkpoints_only_past_one_segment(stand_in_library, T):
    """The checkpoint scratch exists only for a call of more than one
    segment, and then holds a (v, a) pair a segment and lane; beside it
    only the (2, B, N) partials of g_tau and g_rho are allocated for the
    kernel (no (T, B, N) scratch plane)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.alifrec import ops
    B, N = 48, 64
    cur, s, gs = (torch.zeros((T, B, N)) for _ in range(3))
    tau, rho = torch.ones(N), torch.ones(N)
    v0, a0, gv, ga = (torch.zeros((B, N)) for _ in range(4))
    sizes = []
    real = torch.empty

    def empty(*shape, **kw):
        sizes.append(tuple(shape[0]) if len(shape) == 1 else shape)
        return real(*shape, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "empty", empty)
        ops.alif_bwd_cuda(cur, tau, rho, v0, a0, s, gs, gv, ga, 1.0, 0.5,
                          "sigmoid", 4.0)
    (call,) = stand_in_library.alif_bwd_f32.call_args_list
    segs = -(-T // _build.LANE_BWD_SEG)
    assert (call.args[9] is None) == (segs == 1)
    assert sizes == ([] if segs == 1 else [(segs, 2, B, N)]) + [(2, B, N)]


