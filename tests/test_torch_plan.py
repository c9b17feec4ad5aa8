"""The port's plan compiler and plan executor held against the JAX package.

* `describe()` strings equal the reference's (segment kinds, lowerings and
  TB2xx fallback codes) for the SHD DH-SNN and the ECG SRNN with their
  homogeneous ablations, a 3-node LIF/LI program with a delayed edge, an
  ALIF feed-forward program, and programs that fall back.
* `plan.run` agrees with the JAX `plan.run` on the same numpy inputs and
  the same weights (carried over with `weights.params_from_numpy`):
  outputs and final states within `CROSS_ENGINE_ATOL` (1e-5: the JAX
  reference folds the recurrences with an associative scan and sums
  s @ W_rec in its matmul's order, the port sequentially, and fp32
  addition is not associative), hidden spike trains exactly under the
  threshold-tie rule (`tests/_torch_parity.py`): a lane may differ only
  from a step where the reference's pre-reset membrane lies within 1e-5
  of its threshold, and the test computes that margin itself; for a
  self-recurrent hidden layer (the ECG SRNN) the rule is row-wise.
* The port's plan agrees with the port's stepper, chunked `run_stream`
  equals one-shot exactly (also where the recurrence crosses chunk
  boundaries through `state["out"]`), and `pack_states`/`unpack_state`
  round-trip exactly.
* The neuron IR: each built-in's FIRE step (`program_fire`) agrees with
  the JAX interpreter, and program validation and `register_neuron`
  refuse what the reference refuses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import events as jevents
from repro.core import neuron as jneuron
from repro.core import plan as jplan
from repro.core.neuron import ALIF as JALIF, DHLIF as JDHLIF, LI as JLI, \
    LIF as JLIF
from repro.core.snn_layers import ff_integrate as jff, \
    make_dhsnn_shd as jmake_dhsnn, make_srnn_ecg as jmake_srnn
from repro_torch.core import events, neuron, plan
from repro_torch.core.neuron import ALIF, DHLIF, LI, LIF
from repro_torch.core.snn_layers import ff_integrate, make_dhsnn_shd, \
    make_srnn_ecg
from repro_torch.data.spikes import gen_ecg_qtdb, gen_shd_spikes
from tests._torch_parity import hidden_membrane, is_recurrent, \
    max_err_before, tie_rule
from repro_torch.weights import params_from_numpy, params_to_numpy

ATOL = plan.CROSS_ENGINE_ATOL
# Final states are held to ATOL absolute *and* ATOL relative. The DH-LIF
# soma integrates its four dendrites with decays up to sigmoid(6) = 0.9975,
# so membranes reach |v| ~ 130 on the narrow model, where one fp32 spacing
# is 1.5e-5: there an absolute 1e-5 asks for better than one ulp. The JAX
# reference itself drifts 3.05e-5 on that state between its own plan and
# stepper on the same input.
STATE_RTOL = plan.CROSS_ENGINE_ATOL
# A spike-train comparison counts only where the hidden layer fires in at
# least this share of its (step, batch, neuron) lane-steps.
MIN_RATE = 0.01


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _dhsnn(dendritic, n_in, n_hidden, n_out, n_branches=4):
    """(JAX nodes, JAX params, port nodes, port params): same weights."""
    jn, jp = jmake_dhsnn(jax.random.PRNGKey(0), n_in=n_in, n_hidden=n_hidden,
                         n_out=n_out, n_branches=n_branches,
                         dendritic=dendritic)
    tn, _ = make_dhsnn_shd(torch.Generator().manual_seed(0), n_in=n_in,
                           n_hidden=n_hidden, n_out=n_out,
                           n_branches=n_branches, dendritic=dendritic,
                           device="cpu")
    return jn, jp, tn, params_from_numpy(_np_tree(jp), "cpu")


def _ecg(heterogeneous, n_hidden):
    """(JAX nodes, JAX params, port nodes, port params) of the ECG SRNN
    (4 -> n_hidden recurrent ALIF or LIF -> 6 LI): the same weights."""
    jn, jp = jmake_srnn(jax.random.PRNGKey(0), n_hidden=n_hidden,
                        heterogeneous=heterogeneous)
    tn, _ = make_srnn_ecg(torch.Generator().manual_seed(0),
                          n_hidden=n_hidden, heterogeneous=heterogeneous,
                          device="cpu")
    return jn, jp, tn, params_from_numpy(_np_tree(jp), "cpu")


def _ecg_input(T, B, seed=0):
    """(T, B, 4) level-crossing-coded ECG records."""
    x, _ = gen_ecg_qtdb(B, seed=seed, T=T)
    return np.ascontiguousarray(x.transpose(1, 0, 2))


def _alif_ff(n_in=700, n_hidden=64, n_out=20):
    """`benchmarks/bench_snn_engine.py`'s `shd_alif_ff` program: n_in ->
    n_hidden ALIF(beta=0.5) -> n_out LI(tau=0.97), in both packages, with
    shared numpy weights drawn as the bench draws them."""
    rng = np.random.default_rng(12)
    jneu = JALIF().param_init(jax.random.PRNGKey(3), (n_hidden,))
    w = {"hidden": {"w_input": rng.standard_normal((n_in, n_hidden))
                    / np.sqrt(n_in),
                    "neuron": _np_tree(jneu)},
         "readout": {"w_hidden": rng.standard_normal((n_hidden, n_out)) / 8}}
    w = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), w)

    def build(ev, alif, li, ff):
        return [ev.LayerNode("hidden", alif(beta=0.5), ff, ("input",),
                             n_hidden),
                ev.LayerNode("readout", li(tau=0.97), ff, ("hidden",),
                             n_out)]

    return (build(jevents, JALIF, JLI, jff),
            jax.tree_util.tree_map(jnp.asarray, w),
            build(events, ALIF, LI, ff_integrate),
            params_from_numpy(w, "cpu"))


def _delayed_program():
    """input -> h1 (LIF) -> h2 (subtract-reset LIF reading h1 and h1@2)
    -> readout (LI), in both packages, with shared numpy weights."""
    rng = np.random.default_rng(11)
    w = {"h1": {"w_input": 0.5 * rng.standard_normal((20, 12))},
         "h2": {"w_h1": 0.5 * rng.standard_normal((12, 10))},
         "readout": {"w_h2": 0.3 * rng.standard_normal((10, 4))}}
    w = jax.tree_util.tree_map(lambda a: a.astype(np.float32), w)

    def build(ev, lif, li, ff):
        return [ev.LayerNode("h1", lif(tau=0.8, v_th=0.5), ff,
                             inputs=("input",), out_dim=12),
                ev.LayerNode("h2", lif(tau=0.9, v_th=0.5, reset="subtract"),
                             ff, inputs=("h1", ev.Connection("h1", delay=2)),
                             out_dim=10),
                ev.LayerNode("readout", li(tau=0.95), ff, inputs=("h2",),
                             out_dim=4)]

    jn = build(jevents, JLIF, JLI, jff)
    tn = build(events, LIF, LI, ff_integrate)
    jp = jax.tree_util.tree_map(jnp.asarray, w)
    return jn, jp, tn, params_from_numpy(w, "cpu")


def _raster(T, B, n_in, rate, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((T, B, n_in)) < rate).astype(np.float32)


def _leaves(state):
    return {(n, k): v for n, d in state.items() for k, v in d.items()}


def _assert_matches_reference(jn, jp, tn, tp, x, hidden="hidden"):
    js, jo, jr = jplan.run(jn, jp, jnp.asarray(x), record=(hidden,))
    ts, to, tr = plan.run(tn, tp, torch.from_numpy(x), record=(hidden,),
                          device="cpu")
    s_ref = np.asarray(jr[hidden])
    s_port = tr[hidden].numpy()
    node = next(n for n in tn if n.name == hidden)
    u_ref, th_ref = hidden_membrane(node, _np_tree(jp)[hidden], x, s_ref)
    first_div, n_ties = tie_rule(s_ref, s_port, u_ref, th_ref,
                                 rowwise=is_recurrent(node))
    assert s_ref.mean() >= MIN_RATE, \
        f"hidden layer fires in {s_ref.mean():.2%}: vacuous comparison"
    assert max_err_before(np.asarray(jo), to.numpy(), first_div) <= ATOL
    clean = first_div == x.shape[0]       # rows with no tie flip
    jl, tl = _leaves(js), _leaves(ts)
    assert set(jl) == set(tl)
    for k in jl:
        np.testing.assert_allclose(
            tl[k].numpy()[clean] if k[1] != "ring" else tl[k].numpy(),
            np.asarray(jl[k])[clean] if k[1] != "ring" else np.asarray(jl[k]),
            rtol=STATE_RTOL, atol=ATOL, err_msg=str(k))
    return n_ties


# ---------------------------------------------------------------------------
# describe()
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dendritic", [True, False])
def test_describe_dhsnn_matches_reference(dendritic):
    jn, _, tn, _ = _dhsnn(dendritic, 40, 16, 5)
    got = plan.compile_program(tn).describe()
    assert got == jplan.compile_program(jn).describe()
    assert got == ("fused_ff[hidden]:dhlif -> fused_ff[readout]:li"
                   if dendritic else
                   "fused_ff[hidden]:lif -> fused_ff[readout]:li")


def test_describe_delayed_program_matches_reference():
    jn, _, tn, _ = _delayed_program()
    assert plan.compile_program(tn).describe() == \
        jplan.compile_program(jn).describe()


@pytest.mark.parametrize("heterogeneous", [True, False])
def test_describe_ecg_matches_reference(heterogeneous):
    jn, _, tn, _ = _ecg(heterogeneous, 16)
    got = plan.compile_program(tn).describe()
    assert got == jplan.compile_program(jn).describe()
    assert got == ("fused_rec[hidden]:alif -> fused_ff[readout]:li"
                   if heterogeneous else
                   "fused_rec[hidden]:lif -> fused_ff[readout]:li")


@pytest.mark.parametrize("heterogeneous", [True, False])
def test_ecg_params_carry_across(heterogeneous):
    """`params_from_numpy` carries the ECG tree over leaf for leaf, the
    homogeneous model's `neuron: None` included, and the port's own
    `make_srnn_ecg` draws a tree of the same structure and shapes."""
    jn, jp, tn, tp = _ecg(heterogeneous, 16)
    _, own = make_srnn_ecg(torch.Generator().manual_seed(0), n_hidden=16,
                           heterogeneous=heterogeneous, device="cpu")
    for tree in (tp, own):
        assert tree["hidden"].keys() == {"w_input", "w_self", "neuron"}
        assert (tree["hidden"]["neuron"] is None) != heterogeneous
    assert jax.tree_util.tree_structure(_np_tree(jp)) == \
        jax.tree_util.tree_structure(params_to_numpy(tp)) == \
        jax.tree_util.tree_structure(params_to_numpy(own))
    for a, b, c in zip(jax.tree_util.tree_leaves(_np_tree(jp)),
                       jax.tree_util.tree_leaves(params_to_numpy(tp)),
                       jax.tree_util.tree_leaves(params_to_numpy(own))):
        np.testing.assert_array_equal(a, b)
        assert b.shape == c.shape and b.dtype == c.dtype == np.float32


def test_alif_param_init_draws_like_the_reference():
    """Heterogeneous decays: logits of the defaults (tau 0.9, rho 0.97)
    plus 0.5 x a standard normal per neuron, in both packages."""
    n = 4096
    jp = _np_tree(JALIF().param_init(jax.random.PRNGKey(0), (n,)))
    g = torch.Generator().manual_seed(0)
    tp = ALIF().param_init(g, (n,))
    g.manual_seed(0)
    z_tau, z_rho = torch.randn((n,), generator=g), torch.randn((n,),
                                                                generator=g)
    for key, p, z in (("w_tau", 0.9, z_tau), ("w_rho", 0.97, z_rho)):
        logit = np.log(p / (1 - p))
        torch.testing.assert_close(tp[key], logit + 0.5 * z)
        for got in (tp[key].numpy(), jp[key]):
            assert got.shape == (n,)
            assert abs(got.mean() - logit) < 0.05
            assert abs(got.std() - 0.5) < 0.05


def test_describe_alif_ff_matches_reference():
    jn, _, tn, _ = _alif_ff(20, 8, 3)
    got = plan.compile_program(tn).describe()
    assert got == jplan.compile_program(jn).describe() == \
        "fused_ff[hidden]:alif -> fused_ff[readout]:li"


def _odd_programs(ev, lif, alif, dhlif, li, ff):
    def untagged(p, f):
        return f["input"] @ p["w_input"]
    return {
        "untagged": [ev.LayerNode("h", lif(), untagged, out_dim=8),
                     ev.LayerNode("o", li(), ff, inputs=("h",), out_dim=3)],
        "recurrent_lif": [ev.LayerNode("h", lif(), ff,
                                       inputs=("input", "self"), out_dim=8)],
        "alif": [ev.LayerNode("h", alif(), ff, out_dim=8)],
        "alif_rec": [ev.LayerNode("h", alif(), ff, inputs=("input", "self"),
                                  out_dim=8)],
        "dhlif_ff": [ev.LayerNode("h", dhlif(), ff, out_dim=8)],
        "subtract_rec": [ev.LayerNode("h", lif(reset="subtract"), ff,
                                      inputs=("input", "self"), out_dim=8)],
        "back_ref": [ev.LayerNode("a", lif(), ff, inputs=("input", "b"),
                                  out_dim=4),
                     ev.LayerNode("b", lif(), ff, inputs=("a",), out_dim=4)],
        "delayed_self": [ev.LayerNode("h", lif(), ff,
                                      inputs=("input", "self@1"), out_dim=4)],
    }


@pytest.mark.parametrize("name", ["untagged", "recurrent_lif", "alif",
                                  "alif_rec", "dhlif_ff", "subtract_rec",
                                  "back_ref", "delayed_self"])
def test_describe_fallbacks_and_lowerings_match_reference(name):
    jp = _odd_programs(jevents, JLIF, JALIF, JDHLIF, JLI, jff)[name]
    tp = _odd_programs(events, LIF, ALIF, DHLIF, LI, ff_integrate)[name]
    assert plan.compile_program(tp).describe() == \
        jplan.compile_program(jp).describe()


# ---------------------------------------------------------------------------
# plan.run against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dendritic", [True, False])
def test_plan_run_matches_reference_narrow(dendritic):
    jn, jp, tn, tp = _dhsnn(dendritic, 40, 16, 5)
    x = _raster(37, 3, 40, 0.2, seed=1)
    _assert_matches_reference(jn, jp, tn, tp, x)


@pytest.mark.parametrize("dendritic", [True, False])
def test_plan_run_matches_reference_published_widths(dendritic):
    """The SHD model at 700 -> 64 (x4 branches) -> 20, T=32, B=2. The
    DH-SNN reads SHD-like input; the homogeneous ablation barely fires on
    that (about 0.03 % of lane-steps), so it reads i.i.d. Bernoulli(0.1)
    spikes, on which it fires in about 3 %."""
    jn, jp, tn, tp = _dhsnn(dendritic, 700, 64, 20)
    if dendritic:
        x = np.ascontiguousarray(
            gen_shd_spikes(2, T=32, seed=4)[0].transpose(1, 0, 2))
    else:
        x = _raster(32, 2, 700, 0.1, seed=4)
    _assert_matches_reference(jn, jp, tn, tp, x)


@pytest.mark.parametrize("heterogeneous", [True, False])
def test_ecg_plan_run_matches_reference_narrow(heterogeneous):
    """The ECG SRNN at n_hidden=16, T=37, B=3. Its heterogeneous hidden
    layer fires in about 0.6 % of lane-steps on 37 steps of ECG records,
    so it reads i.i.d. Bernoulli(0.3) spikes, as `bench_snn_engine` feeds
    the SRNN."""
    jn, jp, tn, tp = _ecg(heterogeneous, 16)
    _assert_matches_reference(jn, jp, tn, tp, _raster(37, 3, 4, 0.3, 14))


@pytest.mark.parametrize("heterogeneous", [True, False])
def test_ecg_plan_run_matches_reference_published_widths(heterogeneous):
    """The ECG SRNN at 4 -> 64 -> 6, T=200, B=4, on ECG records."""
    jn, jp, tn, tp = _ecg(heterogeneous, 64)
    _assert_matches_reference(jn, jp, tn, tp, _ecg_input(200, 4, seed=1))


@pytest.mark.parametrize("n_in,n_hidden,n_out,T,B",
                         [(40, 16, 5, 37, 3), (700, 64, 20, 64, 4)])
def test_alif_ff_plan_run_matches_reference(n_in, n_hidden, n_out, T, B):
    """The ALIF feed-forward program (`alif` kernel) on Bernoulli(0.08)
    input, narrow and at the bench's widths."""
    jn, jp, tn, tp = _alif_ff(n_in, n_hidden, n_out)
    _assert_matches_reference(jn, jp, tn, tp, _raster(T, B, n_in, 0.08, 13))


def test_delayed_program_matches_reference():
    jn, jp, tn, tp = _delayed_program()
    x = _raster(37, 3, 20, 0.3, seed=2)
    _assert_matches_reference(jn, jp, tn, tp, x, hidden="h1")
    js, jo, jr = jplan.run(jn, jp, jnp.asarray(x), record=("h2",))
    ts, to, tr = plan.run(tn, tp, torch.from_numpy(x), record=("h2",),
                          device="cpu")
    np.testing.assert_array_equal(tr["h2"].numpy(), np.asarray(jr["h2"]))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=ATOL)


def test_fallback_segment_matches_reference():
    """An untagged integrate runs on the port's stepper, feeding a fused
    readout, and agrees with the JAX plan."""
    jn = _odd_programs(jevents, JLIF, JALIF, JDHLIF, JLI, jff)["untagged"]
    tn = _odd_programs(events, LIF, ALIF, DHLIF, LI, ff_integrate)["untagged"]
    rng = np.random.default_rng(9)
    w = {"h": {"w_input": rng.standard_normal((6, 8)).astype(np.float32)},
         "o": {"w_h": rng.standard_normal((8, 3)).astype(np.float32)}}
    x = _raster(29, 2, 6, 0.3, seed=3)
    js, jo, jr = jplan.run(jn, jax.tree_util.tree_map(jnp.asarray, w),
                           jnp.asarray(x), record=("h",))
    ts, to, tr = plan.run(tn, params_from_numpy(w, "cpu"),
                          torch.from_numpy(x), record=("h",), device="cpu")
    assert plan.compile_program(tn).segments[0].kind == plan.FALLBACK
    np.testing.assert_array_equal(tr["h"].numpy(), np.asarray(jr["h"]))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# the port against itself
# ---------------------------------------------------------------------------


def _port_model(name):
    """(port nodes, port params, (T, B, n_in) input) of a named model."""
    if name == "dhsnn":
        _, _, tn, tp = _dhsnn(True, 40, 16, 5)
        return tn, tp, _raster(61, 3, 40, 0.2, seed=6)
    if name in ("ecg", "ecg_homogeneous"):
        # Bernoulli(0.3), as in the narrow reference test: 61 steps of ECG
        # records barely reach the 1 % firing floor at n_hidden=16
        _, _, tn, tp = _ecg(name == "ecg", 16)
        return tn, tp, _raster(61, 3, 4, 0.3, seed=6)
    if name == "alif_ff":
        _, _, tn, tp = _alif_ff(40, 16, 5)
        return tn, tp, _raster(61, 3, 40, 0.08, seed=6)
    _, _, tn, tp = _delayed_program()
    return tn, tp, _raster(61, 3, 20, 0.3, seed=6)


def _assert_plan_matches_stepper(tn, tp, x):
    ps, po, pr = plan.run(tn, tp, x, record=("hidden",), device="cpu")
    ss, so, sr = events.run(tn, tp, x, record=("hidden",), device="cpu")
    assert sr["hidden"].mean() >= MIN_RATE
    u, th = hidden_membrane(tn[0], params_to_numpy(tp)["hidden"], x.numpy(),
                            sr["hidden"].numpy())
    first_div, _ = tie_rule(sr["hidden"].numpy(), pr["hidden"].numpy(), u,
                            th, rowwise=is_recurrent(tn[0]))
    assert max_err_before(so.numpy(), po.numpy(), first_div) <= ATOL


@pytest.mark.parametrize("dendritic", [True, False])
def test_plan_matches_port_stepper(dendritic):
    _, _, tn, tp = _dhsnn(dendritic, 40, 16, 5)
    _assert_plan_matches_stepper(
        tn, tp, torch.from_numpy(_raster(37, 3, 40, 0.2, seed=5)))


@pytest.mark.parametrize("name", ["ecg", "ecg_homogeneous", "alif_ff"])
def test_alif_and_recurrent_plan_matches_port_stepper(name):
    tn, tp, x = _port_model(name)
    _assert_plan_matches_stepper(tn, tp, torch.from_numpy(x))


@pytest.mark.parametrize("program", ["dhsnn", "delayed", "ecg",
                                     "ecg_homogeneous"])
def test_run_stream_chunked_equals_one_shot(program):
    """Concatenated chunk outputs and the final state equal the one-shot
    run exactly; for the ECG SRNN the recurrence crosses every chunk
    boundary through state["out"]."""
    tn, tp, x = _port_model(program)
    x = torch.from_numpy(x)
    s1, o1, _ = plan.run(tn, tp, x, device="cpu")
    cuts = [0, 1, 18, 41, 61]                 # includes a 1-step chunk
    chunks = [x[a:b] for a, b in zip(cuts, cuts[1:])]
    outs, state = [], None
    for state, o in plan.run_stream(tn, tp, chunks, device="cpu"):
        outs.append(o)
    assert torch.equal(torch.cat(outs), o1)
    for k, v in _leaves(s1).items():
        assert torch.equal(_leaves(state)[k], v), k


def test_pack_unpack_round_trip():
    _, _, tn, tp = _delayed_program()
    x = torch.from_numpy(_raster(9, 3, 20, 0.3, seed=7))
    state, _, _ = plan.run(tn, tp, x, device="cpu")
    singles = [plan.unpack_state(state, i) for i in range(3)]
    packed = plan.pack_states(singles, pad_to=5)
    assert packed["h1"]["ring"].shape == (2, 5, 12)
    for i in range(3):
        back = plan.unpack_state(packed, i)
        for k, v in _leaves(singles[i]).items():
            assert torch.equal(_leaves(back)[k], v), k
    assert plan.state_nbytes(singles[0]) * 3 == plan.state_nbytes(state)
    with pytest.raises(ValueError, match="exceed"):
        plan.pack_states(singles, pad_to=2)


# ---------------------------------------------------------------------------
# what the port refuses
# ---------------------------------------------------------------------------


def test_unported_hooks_raise(monkeypatch):
    _, _, tn, tp = _dhsnn(True, 8, 4, 2)
    x = torch.zeros(3, 1, 8)
    with pytest.raises(NotImplementedError, match="guardrails"):
        plan.run(tn, tp, x, guard="warn", device="cpu")
    monkeypatch.setenv("REPRO_FAULTS", "dead_rows:frac=0.1")
    with pytest.raises(NotImplementedError, match="fault injection"):
        plan.run(tn, tp, x, device="cpu")
    with pytest.raises(NotImplementedError, match="plasticity"):
        events.Connection("input", plastic=object())
    with pytest.raises(NotImplementedError, match="compressed topology"):
        events.Connection("input", topology="t")


def test_integer_rasters_cast_before_integ():
    _, _, tn, tp = _dhsnn(True, 40, 16, 5)
    x = _raster(12, 2, 40, 0.2, seed=8)
    _, of, _ = plan.run(tn, tp, torch.from_numpy(x), device="cpu")
    st, oi, _ = plan.run(tn, tp, torch.from_numpy(x.astype(np.int32)),
                         device="cpu")
    assert oi.dtype == torch.float32 and st["hidden"]["v"].dtype == \
        torch.float32
    assert torch.equal(oi, of)


# ---------------------------------------------------------------------------
# the neuron IR
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["lif", "plif", "alif", "dhlif", "li"])
def test_program_fire_matches_reference(name):
    """Eight FIRE steps of each built-in through both interpreters, from
    the same state, currents and (JAX-drawn) parameters."""
    B, N = 3, 16
    jspec = jneuron.make_neuron(name)
    tspec = neuron.make_neuron(name)
    assert repr(tspec.program) == repr(jspec.program)
    jp = jspec.param_init(jax.random.PRNGKey(1), (N,))
    tp = params_from_numpy(_np_tree(jp), "cpu")
    jst = jspec.init_state((B, N))
    tst = tspec.init_state((B, N), device="cpu")
    cur_shape = (B, jspec.program.n_branches, N) if name == "dhlif" \
        else (B, N)
    rng = np.random.default_rng(3)
    fired = 0.0
    for _ in range(8):
        cur = (0.8 * rng.standard_normal(cur_shape)).astype(np.float32)
        jst, jo = jspec.fire(jst, jnp.asarray(cur), jp)
        tst, to = tspec.fire(tst, torch.from_numpy(cur), tp)
        if name != "li":
            np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
            fired += float(to.sum())
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0,
                                   atol=ATOL)
        for k in jst:
            np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                       rtol=0, atol=ATOL, err_msg=k)
    assert name == "li" or fired > 0


def test_program_validation_and_registration():
    bad = neuron.NeuronProgram(
        states=(neuron.StateVar("v", neuron.Decay("const", 0.9)),),
        threshold=neuron.Threshold(on="u"))
    with pytest.raises(ValueError, match="unknown state"):
        neuron.ProgramNeuron(prog=bad)
    with pytest.raises(ValueError, match="unknown state"):
        jneuron.ProgramNeuron(prog=jneuron.NeuronProgram(
            states=(jneuron.StateVar("v", jneuron.Decay("const", 0.9)),),
            threshold=jneuron.Threshold(on="u")))
    with pytest.raises(ValueError, match="already registered"):
        neuron.register_neuron("lif", LIF)
    name = "test_torch_plan_custom"
    try:
        neuron.register_neuron(name, neuron.ProgramNeuron)
        assert isinstance(neuron.make_neuron(name), neuron.ProgramNeuron)
        neuron.register_neuron(name, LIF, override=True)
        assert neuron.make_neuron(name, tau=0.5).program.states[0].decay \
            .value == 0.5
    finally:
        neuron.NEURON_REGISTRY.pop(name, None)
    with pytest.raises(KeyError, match="unknown neuron"):
        neuron.make_neuron(name)
