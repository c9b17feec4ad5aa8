"""The port's Connection API and synapse-program plan lowering, held
against the JAX package on the CPU.

Mirrors `tests/test_synapse_plan.py`: the string -> Connection adapter,
the learning pass of plastic connections under `plan.run` (the fused
`stdp_seq` lowering against the per-step `synapse_run` reference, weights
AND traces), inter-layer, delayed and back-reference edges, the stepper
engine, `learn=False` with `apply_learned`, learned trace decays, custom
weight keys, a hypothesis property test over random valid programs (fused
against the per-step interpreter), the TB210 refusal and `describe()`.
Every learned state is also held to the JAX package's `plan.run` on the
same numpy inputs with the same weights (`weights.params_from_numpy`),
within 1e-5 absolute and relative, the reference tests' own tolerance.

Left out, because they test JAX machinery the port does not have: the
STBP-gradient check (the port is forward-only until the training slice)
and `jax.jit` of a plastic run.

Also here: the aliasing rules of a torch port (learning never writes into
params or the entry state; `run_stream` learns from the carried weight
while its forward reads params), the synapse state a plastic model's
params seed in both packages, `pack_states`' refusal of synapse state, and
the serve engine's frozen-weight (`learn=False`) serving of a plastic
program.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import events as jevents
from repro.core import plan as jplan
from repro.core import plasticity as jpl
from repro.core.neuron import Decay as JDecay
from repro.core.neuron import LI as JLI, LIF as JLIF
from repro.core.snn_layers import ff_integrate as jff
from repro.core.snn_layers import make_plastic_ff as jmake_plastic_ff
from repro_torch.core import events, plan, plasticity
from repro_torch.core.events import Connection
from repro_torch.core.neuron import LI, LIF, Decay
from repro_torch.core.plasticity import (SynapseProgram, TraceVar,
                                         UpdateTerm, pair_stdp, synapse_run,
                                         triplet_stdp)
from repro_torch.core.snn_layers import ff_integrate, make_plastic_ff
from repro_torch.serve import EngineConfig, make_engine
from repro_torch.weights import params_from_numpy

TOL = dict(atol=1e-5, rtol=1e-5)
RULES = ["pair_stdp", "triplet_stdp", "reward_stdp", "accumulated_spike"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _w(rng, n_in, n_out, scale=0.6):
    return (scale * rng.standard_normal((n_in, n_out))).astype(np.float32)


def _spikes(rng, shape, rate=0.35):
    return (rng.random(shape) < rate).astype(np.float32)


def _close(got, ref, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), err_msg=msg,
                               **TOL)


def _plastic_ff(seed, rule_name=None, jrule=None, rule=None, **kw):
    """(JAX nodes, JAX params, port nodes, port params) of `make_plastic_ff`
    with the JAX package's weights in both."""
    if rule_name is not None:
        jrule, rule = jpl.make_synapse(rule_name), \
            plasticity.make_synapse(rule_name)
    jn, jp = jmake_plastic_ff(jax.random.PRNGKey(seed), rule=jrule, **kw)
    tn, _ = make_plastic_ff(torch.Generator().manual_seed(seed), rule=rule,
                            device="cpu", **kw)
    return jn, jp, tn, params_from_numpy(_np(jp), "cpu")


def _mod(rule_name, rng, T, B, N):
    if rule_name == "reward_stdp":
        return rng.random(T).astype(np.float32)
    if rule_name == "accumulated_spike":
        m = np.zeros((T, B, N), np.float32)
        m[-1] = rng.standard_normal((B, N))
        return m
    return None


def _run_both(jn, jp, tn, tp, x, mod=None, **kw):
    """The port's and the JAX package's plan.run on the same input."""
    jst, jo, _ = jplan.run(jn, jp, jnp.asarray(x),
                           mod=None if mod is None else jnp.asarray(mod),
                           **kw)
    tst, to, _ = plan.run(tn, tp, torch.from_numpy(x),
                          mod=None if mod is None else torch.from_numpy(mod),
                          device="cpu", **kw)
    return jst, jo, tst, to


def _assert_syn(tsyn, jsyn):
    assert set(tsyn) == set(jsyn)
    for k in jsyn:
        _close(tsyn[k], jsyn[k], msg=k)


def _to_torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# the back-compat adapter: strings are a thin spelling of Connections
# ---------------------------------------------------------------------------


def test_connection_parse_equals_explicit():
    assert Connection.parse("x@2") == Connection("x", delay=2)
    assert Connection.parse("self") == Connection("self")
    assert Connection.parse("input") == Connection("input")
    c = Connection("a", delay=3)
    assert Connection.parse(c) is c
    assert Connection("x", 2).key == "x@2"
    assert Connection("self").key == "self"
    assert Connection("hidden").key == "hidden"
    assert Connection("hidden").weight_key == "w_hidden"
    assert Connection("self").weight_key == "w_self"
    assert Connection("x", weight="w_shared").weight_key == "w_shared"


def test_connection_validation():
    with pytest.raises(ValueError, match="source"):
        Connection("")
    with pytest.raises(ValueError, match="delay"):
        Connection("x", delay=-1)
    with pytest.raises(ValueError, match="at least one update term"):
        Connection("x", plastic=SynapseProgram(traces=(), terms=()))
    # a valid program builds: plastic connections are ported
    assert Connection("x", plastic=pair_stdp()).plastic == pair_stdp()


def test_layernode_normalizes_mixed_inputs():
    node = events.LayerNode("h", LIF(), ff_integrate,
                            ("x@2", Connection("y", delay=1), "self"), 8)
    assert node.connections == (Connection("x", 2), Connection("y", 1),
                                Connection("self"))
    assert node.inputs == ("x@2", "y@1", "self")
    with pytest.raises(ValueError, match="duplicate"):
        events.LayerNode("h", LIF(), ff_integrate,
                         ("x@2", Connection("x", delay=2)), 8)


def test_mixed_string_and_connection_programs_run_bit_identically():
    """The same topology spelled as strings or Connection objects gives
    identical plans, outputs and state under both port engines, and the
    plan's `describe()` equals the reference's."""
    rng = np.random.default_rng(0)
    old = [
        events.LayerNode("a", LIF(tau=0.5, v_th=0.6), ff_integrate,
                         ("input",), 12),
        events.LayerNode("b", LIF(tau=0.7), ff_integrate, ("a@2", "self"),
                         10),
        events.LayerNode("ro", LI(), ff_integrate, ("b", "a@1"), 4),
    ]
    new = [
        events.LayerNode("a", LIF(tau=0.5, v_th=0.6), ff_integrate,
                         (Connection("input"),), 12),
        events.LayerNode("b", LIF(tau=0.7), ff_integrate,
                         (Connection("a", delay=2), Connection("self")), 10),
        events.LayerNode("ro", LI(), ff_integrate,
                         (Connection("b"), Connection("a", delay=1)), 4),
    ]
    jold = [jevents.LayerNode("a", JLIF(tau=0.5, v_th=0.6), jff, ("input",),
                              12),
            jevents.LayerNode("b", JLIF(tau=0.7), jff, ("a@2", "self"), 10),
            jevents.LayerNode("ro", JLI(), jff, ("b", "a@1"), 4)]
    params = {"a": {"w_input": _w(rng, 6, 12)},
              "b": {"w_a": _w(rng, 12, 10), "w_self": _w(rng, 10, 10, 0.3)},
              "ro": {"w_b": _w(rng, 10, 4), "w_a": _w(rng, 12, 4)}}
    tp = params_from_numpy(params, "cpu")
    x = torch.from_numpy(_spikes(rng, (13, 2, 6), rate=0.5))
    assert (plan.compile_program(old).describe()
            == plan.compile_program(new).describe()
            == jplan.compile_program(jold).describe())
    for run_fn in (events.run, plan.run):
        st1, o1, r1 = run_fn(old, tp, x, record=("a", "b"), device="cpu")
        st2, o2, r2 = run_fn(new, tp, x, record=("a", "b"), device="cpu")
        assert torch.equal(o1, o2)
        for r in r1:
            assert torch.equal(r1[r], r2[r])
        for name in st1:
            for k in st1[name]:
                assert torch.equal(st1[name][k], st2[name][k])


# ---------------------------------------------------------------------------
# plastic connections under plan.run
# ---------------------------------------------------------------------------


def _reference_syn(nodes, params, x, conn_node, rule, mod=None,
                   pre_src=None):
    """Per-step reference in the port: realized spike trains through the
    port's stepper, then `synapse_run` (a loop of `synapse_step`)."""
    record = tuple({conn_node} | ({pre_src} if pre_src else set()))
    _, _, recs = events.run(nodes, params, x, record=record, device="cpu")
    pre = x if pre_src is None else recs[pre_src]
    return synapse_run(rule, params[conn_node]["w_input"], pre,
                       recs[conn_node], mod=mod)


def _force_step(compiled):
    """Force every plastic lowering through the per-step interpreter."""
    return dataclasses.replace(compiled, plastic=tuple(
        dataclasses.replace(p, lower=plan.SYN_STEP, reason="forced")
        for p in compiled.plastic))


@pytest.mark.parametrize("rule_name", RULES)
def test_builtin_rules_plan_lowered_match_reference(rule_name):
    """All four built-in rules lower to `stdp_seq` with no fallback
    segment, and the learned weight and traces equal the port's per-step
    reference and the JAX package's plan.run; `describe()` equals the
    reference's."""
    jn, jp, tn, tp = _plastic_ff(3, rule_name, n_in=9, n_hidden=14)
    rng = np.random.default_rng(4)
    x = _spikes(rng, (11, 3, 9))
    T, B = x.shape[:2]
    compiled = plan.compile_program(tn)
    assert not any(s.kind == plan.FALLBACK for s in compiled.segments), \
        compiled.describe()
    assert compiled.plastic == (plan.PlasticLower("hidden", "input",
                                                  plan.SYN_SEQ),)
    assert compiled.describe() == jplan.compile_program(jn).describe()
    mod = _mod(rule_name, rng, T, B, 14)
    jst, jo, tst, to = _run_both(jn, jp, tn, tp, x, mod=mod)
    syn = tst["hidden"]["syn:input"]
    _assert_syn(syn, jst["hidden"]["syn:input"])
    _close(to, jo)
    ref = _reference_syn(tn, tp, torch.from_numpy(x), "hidden",
                         plasticity.make_synapse(rule_name),
                         mod=None if mod is None else torch.from_numpy(mod))
    assert set(syn) == set(ref)
    for k in ref:
        torch.testing.assert_close(syn[k], ref[k], **TOL)
    assert float(torch.linalg.norm(syn["w"] - tp["hidden"]["w_input"])) \
        > 1e-3                                    # actually learned


def test_plastic_on_inter_layer_and_delayed_connection():
    """Plasticity on a node-to-node delayed edge: the pre train the rule
    sees is the delay-shifted feed the stepper delivered."""
    rng = np.random.default_rng(1)
    nodes = [
        events.LayerNode("a", LIF(tau=0.6, v_th=0.6), ff_integrate,
                         ("input",), 10),
        events.LayerNode("h", LIF(tau=0.8, v_th=0.7), ff_integrate,
                         (Connection("a", delay=2, plastic=pair_stdp()),), 8),
        events.LayerNode("ro", LI(), ff_integrate, ("h",), 3),
    ]
    jnodes = [
        jevents.LayerNode("a", JLIF(tau=0.6, v_th=0.6), jff, ("input",), 10),
        jevents.LayerNode("h", JLIF(tau=0.8, v_th=0.7), jff,
                          (jevents.Connection("a", delay=2,
                                              plastic=jpl.pair_stdp()),), 8),
        jevents.LayerNode("ro", JLI(), jff, ("h",), 3),
    ]
    params = {"a": {"w_input": _w(rng, 5, 10)}, "h": {"w_a": _w(rng, 10, 8)},
              "ro": {"w_h": _w(rng, 8, 3)}}
    tp = params_from_numpy(params, "cpu")
    x = _spikes(rng, (12, 2, 5), rate=0.5)
    compiled = plan.compile_program(nodes)
    assert compiled.plastic == (plan.PlasticLower("h", "a@2", plan.SYN_SEQ),)
    jst, _, tst, _ = _run_both(jnodes, _to_jax(params), nodes, tp, x)
    _assert_syn(tst["h"]["syn:a@2"], jst["h"]["syn:a@2"])
    _, _, recs = events.run(nodes, tp, torch.from_numpy(x),
                            record=("a", "h"), device="cpu")
    pre = torch.cat([torch.zeros((2,) + recs["a"].shape[1:]),
                     recs["a"][:-2]], dim=0)
    ref = synapse_run(pair_stdp(), tp["h"]["w_a"], pre, recs["h"])
    for k in ref:
        torch.testing.assert_close(tst["h"]["syn:a@2"][k], ref[k], **TOL)


def _to_jax(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


def test_plastic_learning_identical_under_stepper_engine(monkeypatch):
    """REPRO_SNN_ENGINE=stepper still learns: the same trajectories as the
    plan engine, and the JAX package's under its stepper."""
    jn, jp, tn, tp = _plastic_ff(7, "pair_stdp", n_in=6, n_hidden=10)
    x = _spikes(np.random.default_rng(0), (9, 2, 6))
    st_plan, o_plan, _ = plan.run(tn, tp, torch.from_numpy(x), device="cpu")
    monkeypatch.setenv("REPRO_SNN_ENGINE", "stepper")
    jst, jo, st_step, o_step = _run_both(jn, jp, tn, tp, x)
    torch.testing.assert_close(o_plan, o_step, atol=1e-5, rtol=0)
    for k in st_plan["hidden"]["syn:input"]:
        torch.testing.assert_close(st_plan["hidden"]["syn:input"][k],
                                   st_step["hidden"]["syn:input"][k], **TOL)
    _assert_syn(st_step["hidden"]["syn:input"], jst["hidden"]["syn:input"])
    _close(o_step, jo)


def test_learn_false_freezes_and_apply_learned_merges():
    _, _, tn, tp = _plastic_ff(8, "pair_stdp", n_in=6, n_hidden=10)
    x = torch.from_numpy(_spikes(np.random.default_rng(0), (9, 2, 6)))
    st_frozen, _, _ = plan.run(tn, tp, x, learn=False, device="cpu")
    assert torch.equal(st_frozen["hidden"]["syn:input"]["w"],
                       tp["hidden"]["w_input"])
    st, _, _ = plan.run(tn, tp, x, device="cpu")
    learned = plasticity.apply_learned(tn, tp, st)
    assert torch.equal(learned["hidden"]["w_input"],
                       st["hidden"]["syn:input"]["w"])
    # untouched entries survive the merge
    assert learned["readout"]["w_hidden"] is tp["readout"]["w_hidden"]
    # chunked-online: the next window's forward sees the learned weight
    o1 = plan.run(tn, learned, x, learn=False, device="cpu")[1]
    o0 = plan.run(tn, tp, x, learn=False, device="cpu")[1]
    assert float((o1 - o0).abs().max()) > 0


def test_learned_decay_rule_hoists_fused_and_matches_interpreter():
    """Learned per-synapse trace decays stay on the fused path (a
    sigmoid-resolved decay plane hoists through linrec like a constant),
    and the fused trajectory equals the per-step interpreter, the forced
    per-step lowering and the reference."""
    rule = SynapseProgram(
        traces=(TraceVar("x", "pre", Decay("learned", 0.9, "tau_x")),),
        terms=(UpdateTerm(0.02, pre=("x",), post=("spikes",)),))
    jrule = jpl.SynapseProgram(
        traces=(jpl.TraceVar("x", "pre", JDecay("learned", 0.9, "tau_x")),),
        terms=(jpl.UpdateTerm(0.02, pre=("x",), post=("spikes",)),))
    jn, jp, tn, tp = _plastic_ff(11, jrule=jrule, rule=rule, n_in=6,
                                 n_hidden=10)
    tau_x = np.linspace(-1.5, 2.0, 6, dtype=np.float32)
    jp["hidden"]["syn:input"] = {"tau_x": jnp.asarray(tau_x)}
    tp["hidden"]["syn:input"] = {"tau_x": torch.from_numpy(tau_x)}
    compiled = plan.compile_program(tn)
    assert compiled.plastic[0].lower == plan.SYN_SEQ
    x = _spikes(np.random.default_rng(2), (9, 2, 6))
    jst, _, st, _ = _run_both(jn, jp, tn, tp, x)
    _assert_syn(st["hidden"]["syn:input"], jst["hidden"]["syn:input"])
    xt = torch.from_numpy(x)
    _, _, recs = events.run(tn, tp, xt, record=("hidden",), device="cpu")
    ref = plasticity.synapse_run(rule, tp["hidden"]["w_input"], xt,
                                 recs["hidden"],
                                 params=tp["hidden"]["syn:input"])
    st2, _, _ = plan.run(tn, tp, xt, plan=_force_step(compiled),
                         device="cpu")
    for k in ref:
        torch.testing.assert_close(st["hidden"]["syn:input"][k], ref[k],
                                   **TOL)
        torch.testing.assert_close(st["hidden"]["syn:input"][k],
                                   st2["hidden"]["syn:input"][k], **TOL)


def test_custom_weight_key_honored_by_both_engines():
    """Connection(weight=...) overrides: both port engines read the same
    tensor, the learning pass reads and writes the override, and
    `apply_learned` round-trips through it."""
    rng = np.random.default_rng(3)
    nodes = [
        events.LayerNode("h", LIF(tau=0.8, v_th=0.6), ff_integrate,
                         (Connection("input", weight="w_shared",
                                     plastic=pair_stdp()),), 10),
        events.LayerNode("ro", LI(tau=0.9), ff_integrate, ("h",), 3),
    ]
    jnodes = [
        jevents.LayerNode("h", JLIF(tau=0.8, v_th=0.6), jff,
                          (jevents.Connection("input", weight="w_shared",
                                              plastic=jpl.pair_stdp()),), 10),
        jevents.LayerNode("ro", JLI(tau=0.9), jff, ("h",), 3),
    ]
    params = {"h": {"w_shared": _w(rng, 6, 10)}, "ro": {"w_h": _w(rng, 10, 3)}}
    tp = params_from_numpy(params, "cpu")
    x = _spikes(rng, (11, 2, 6))
    st1, o1, _ = events.run(nodes, tp, torch.from_numpy(x), device="cpu")
    jst, _, st2, o2 = _run_both(jnodes, _to_jax(params), nodes, tp, x)
    torch.testing.assert_close(o1, o2, atol=1e-5, rtol=0)
    _assert_syn(st2["h"]["syn:input"], jst["h"]["syn:input"])
    learned = plasticity.apply_learned(nodes, tp, st2)
    assert torch.equal(learned["h"]["w_shared"], st2["h"]["syn:input"]["w"])
    assert float(torch.linalg.norm(learned["h"]["w_shared"]
                                   - tp["h"]["w_shared"])) > 1e-3
    with pytest.raises(ValueError, match="conflicting weight"):
        events.LayerNode("h", LIF(), ff_integrate,
                         (Connection("a", weight="w_one"),
                          Connection("a", delay=1, weight="w_two")), 4)


def test_plastic_backref_learns_from_delivered_train():
    """A plastic back-reference (source ordered after the node, read at
    t-1 by the stepper) learns from the delivered, one-step-shifted pre
    train, as in the reference."""
    rng = np.random.default_rng(4)
    nodes = [
        events.LayerNode("a", LIF(tau=0.6, v_th=0.6), ff_integrate,
                         ("input", Connection("b", plastic=pair_stdp())), 10),
        events.LayerNode("b", LIF(tau=0.8, v_th=0.7), ff_integrate,
                         ("a",), 8),
    ]
    jnodes = [
        jevents.LayerNode("a", JLIF(tau=0.6, v_th=0.6), jff,
                          ("input", jevents.Connection(
                              "b", plastic=jpl.pair_stdp())), 10),
        jevents.LayerNode("b", JLIF(tau=0.8, v_th=0.7), jff, ("a",), 8),
    ]
    params = {"a": {"w_input": _w(rng, 5, 10), "w_b": _w(rng, 8, 10)},
              "b": {"w_a": _w(rng, 10, 8)}}
    tp = params_from_numpy(params, "cpu")
    x = _spikes(rng, (12, 2, 5), rate=0.5)
    compiled = plan.compile_program(nodes)
    assert compiled.fully_fallback          # backref -> whole-program stepper
    jst, _, st, _ = _run_both(jnodes, _to_jax(params), nodes, tp, x)
    _assert_syn(st["a"]["syn:b"], jst["a"]["syn:b"])
    _, _, recs = events.run(nodes, tp, torch.from_numpy(x),
                            record=("a", "b"), device="cpu")
    pre = torch.cat([torch.zeros((1,) + recs["b"].shape[1:]),
                     recs["b"][:-1]], dim=0)             # delivered: t-1
    ref = synapse_run(pair_stdp(), tp["a"]["w_b"], pre, recs["a"])
    for k in ref:
        torch.testing.assert_close(st["a"]["syn:b"][k], ref[k], **TOL)


# ---------------------------------------------------------------------------
# property test: random valid SynapsePrograms, fused == per-step
# ---------------------------------------------------------------------------


def _random_rule(mod, D, n_traces, n_terms, tau_a, tau_b, amp, variant):
    """Structurally diverse valid programs, built in package `mod`:
    pre/post traces with mixed before/after reads, multi-factor terms,
    optional mod gating."""
    sources = ["pre", "post"]
    traces = tuple(
        mod.TraceVar(f"t{i}", sources[(i + variant) % 2],
                     D("const", tau_a if i % 2 == 0 else tau_b),
                     scale=1.0 if i % 2 == 0 else 0.7,
                     update="before" if (i + variant) % 3 else "after")
        for i in range(n_traces))
    pre_traces = [t.name for t in traces if t.source == "pre"]
    post_traces = [t.name for t in traces if t.source == "post"]
    terms = []
    for j in range(n_terms):
        pre = ("spikes",) if not pre_traces or j % 2 == 0 else \
            (pre_traces[j % len(pre_traces)],)
        post = ("spikes",) if not post_traces else \
            ("spikes", post_traces[j % len(post_traces)]) if j % 3 == 2 \
            else (post_traces[j % len(post_traces)],)
        if variant == 2 and j == 0:
            post = post + ("mod",)
        terms.append(mod.UpdateTerm(amp * (-1.0 if j % 2 else 1.0),
                                    pre=pre, post=post))
    return mod.validate_synapse_program(mod.SynapseProgram(
        traces=traces, terms=tuple(terms), w_min=-0.8, w_max=0.8))


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 3), st.integers(1, 4), st.floats(0.3, 0.95),
       st.floats(0.5, 0.99), st.floats(0.005, 0.05), st.integers(0, 2))
def test_random_synapse_programs_fused_matches_fallback(
        n_traces, n_terms, tau_a, tau_b, amp, variant):
    """For any valid SynapseProgram the fused `stdp_seq` lowering, the
    per-step lowering and the JAX package's fused lowering give the same
    learned weight and final traces."""
    args = (n_traces, n_terms, tau_a, tau_b, amp, variant)
    rule = _random_rule(plasticity, Decay, *args)
    jrule = _random_rule(jpl, JDecay, *args)
    jn, jp, tn, tp = _plastic_ff(n_traces * 7 + n_terms, jrule=jrule,
                                 rule=rule, n_in=7, n_hidden=9)
    rng = np.random.default_rng(variant + n_terms)
    x = _spikes(rng, (10, 2, 7))
    mod = rng.random(10).astype(np.float32) if variant == 2 else None
    compiled = plan.compile_program(tn)
    assert compiled.plastic[0].lower == plan.SYN_SEQ, compiled.describe()
    jst, _, st_seq, _ = _run_both(jn, jp, tn, tp, x, mod=mod)
    st_step, _, _ = plan.run(tn, tp, torch.from_numpy(x),
                             plan=_force_step(compiled),
                             mod=None if mod is None else torch.from_numpy(mod),
                             device="cpu")
    a, b = st_seq["hidden"]["syn:input"], st_step["hidden"]["syn:input"]
    assert set(a) == set(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], **TOL)
    _assert_syn(a, jst["hidden"]["syn:input"])


def test_oversized_program_refused_by_matcher():
    rule = _random_rule(plasticity, Decay, 4, 4, 0.9, 0.8, 0.01, 0)
    big = dataclasses.replace(rule, terms=rule.terms + (
        UpdateTerm(0.001, pre=("spikes",), post=("spikes",)),))
    lower, code, why = plan._match_synapse_pattern(big)
    assert lower == plan.SYN_STEP and "update terms" in why
    assert code == "TB210"
    jrule = _random_rule(jpl, JDecay, 4, 4, 0.9, 0.8, 0.01, 0)
    jbig = dataclasses.replace(jrule, terms=jrule.terms + (
        jpl.UpdateTerm(0.001, pre=("spikes",), post=("spikes",)),))
    assert (lower, code, why) == jplan._match_synapse_pattern(jbig)
    # the refused rule still learns, through the per-step interpreter
    jn, jp, tn, tp = _plastic_ff(5, jrule=jbig, rule=big, n_in=7, n_hidden=9)
    compiled = plan.compile_program(tn)
    assert compiled.describe() == jplan.compile_program(jn).describe()
    assert "(TB210: 5 update terms)" in compiled.describe()
    x = _spikes(np.random.default_rng(6), (8, 2, 7))
    jst, _, st, _ = _run_both(jn, jp, tn, tp, x)
    _assert_syn(st["hidden"]["syn:input"], jst["hidden"]["syn:input"])


def test_describe_names_plastic_lowerings():
    jn, _, tn, _ = _plastic_ff(12, jrule=jpl.triplet_stdp(),
                               rule=triplet_stdp())
    desc = plan.compile_program(tn).describe()
    assert "learn hidden.input:stdp_seq" in desc
    assert desc == jplan.compile_program(jn).describe()


# ---------------------------------------------------------------------------
# aliasing, carried state, weights, packing and serving
# ---------------------------------------------------------------------------


def test_learning_writes_no_params_and_no_entry_state():
    """The learned weight is a new tensor: params and the entry state keep
    their values, so the next forward sees the update only after
    `apply_learned` — on the fused lowering, the per-step one and the
    stepper engine alike."""
    _, _, tn, tp = _plastic_ff(13, "pair_stdp", n_in=8, n_hidden=12)
    w0 = tp["hidden"]["w_input"].clone()
    x = torch.from_numpy(_spikes(np.random.default_rng(7), (10, 2, 8)))
    compiled = plan.compile_program(tn)
    for p in (compiled, _force_step(compiled)):
        st0 = events.init_state(tn, 2, params=tp, device="cpu")
        assert st0["hidden"]["syn:input"]["w"] is tp["hidden"]["w_input"]
        st, _, _ = plan.run(tn, tp, x, state=st0, plan=p, device="cpu")
        assert not torch.equal(st["hidden"]["syn:input"]["w"], w0)
        assert torch.equal(tp["hidden"]["w_input"], w0)
        assert st0["hidden"]["syn:input"]["w"] is tp["hidden"]["w_input"]
        assert torch.equal(st0["hidden"]["syn:input"]["x_pre"],
                           torch.zeros(2, 8))
    o_same = plan.run(tn, tp, x, learn=False, device="cpu")[1]
    o_first = plan.run(tn, tp, x, device="cpu")[1]
    assert torch.equal(o_same, o_first)       # the forward read params only


def test_run_stream_carries_synapse_state_and_matches_reference():
    """`run_stream` carries the synapse state across chunks: learning
    continues from the carried weight while the forward reads params, so
    the streamed learned state equals one-shot `plan.run` learning over the
    whole stream, and equals the JAX package's `run_stream` (with a reward
    modulator per chunk)."""
    jn, jp, tn, tp = _plastic_ff(14, "reward_stdp", n_in=8, n_hidden=12)
    rng = np.random.default_rng(8)
    x = _spikes(rng, (24, 2, 8))
    mod = rng.random(24).astype(np.float32)
    chunks = [x[i:i + 8] for i in range(0, 24, 8)]
    mods = [mod[i:i + 8] for i in range(0, 24, 8)]
    res = list(plan.run_stream(tn, tp, [torch.from_numpy(c) for c in chunks],
                               mod=[torch.from_numpy(m) for m in mods],
                               device="cpu"))
    jres = list(jplan.run_stream(jn, jp, [jnp.asarray(c) for c in chunks],
                                 mod=[jnp.asarray(m) for m in mods]))
    st_one, o_one, _ = plan.run(tn, tp, torch.from_numpy(x),
                                mod=torch.from_numpy(mod), device="cpu")
    streamed = torch.cat([o for _, o in res])
    assert torch.equal(streamed, o_one)
    syn = res[-1][0]["hidden"]["syn:input"]
    for k in syn:
        torch.testing.assert_close(syn[k], st_one["hidden"]["syn:input"][k],
                                   **TOL)
    _assert_syn(syn, jres[-1][0]["hidden"]["syn:input"])
    assert not torch.equal(syn["w"], tp["hidden"]["w_input"])


def test_plastic_params_seed_the_same_synapse_state():
    """A plastic model's params carried from the JAX package seed the same
    `syn:` state in both packages' `init_state`, and both refuse a plastic
    program without params."""
    jn, jp, tn, tp = _plastic_ff(15, "triplet_stdp", n_in=5, n_hidden=6)
    jst = jevents.init_state(jn, 3, jnp.float32, jp)
    tst = events.init_state(tn, 3, torch.float32, tp, device="cpu")
    for node in jst:
        assert set(tst[node]) == set(jst[node])
    _assert_syn(tst["hidden"]["syn:input"], jst["hidden"]["syn:input"])
    with pytest.raises(ValueError, match="needs params"):
        events.init_state(tn, 3, device="cpu")
    with pytest.raises(ValueError, match="needs params"):
        jevents.init_state(jn, 3)


def test_pack_states_refuses_synapse_state():
    _, _, tn, tp = _plastic_ff(16, "pair_stdp", n_in=5, n_hidden=6)
    st = events.init_state(tn, 1, params=tp, device="cpu")
    with pytest.raises(ValueError, match="no batch axis"):
        plan.pack_states([st, st])


@pytest.mark.parametrize("kind", ["batched", "naive"])
def test_engine_serves_plastic_program_with_frozen_weights(kind):
    """`EngineConfig(learn=False)` serves a plastic program as the
    reference does: the syn entries stay per session and unchanged, and
    each session's outputs equal a one-shot `plan.run(learn=False)`; with
    learn=True every session's weight learns."""
    _, _, tn, tp = _plastic_ff(17, "pair_stdp", n_in=8, n_hidden=12)
    rng = np.random.default_rng(9)
    streams = {f"s{i}": _spikes(rng, (11 + 3 * i, 8)) for i in range(3)}
    eng = make_engine(tn, tp, EngineConfig(window=4, capacity=2), kind=kind,
                      device="cpu")
    for sid, v in streams.items():
        eng.open(sid)
        eng.submit(sid, v)
        eng.close(sid)
    eng.drain()
    for sid, v in streams.items():
        _, o, _ = plan.run(tn, tp, torch.from_numpy(v[:, None]), learn=False,
                           device="cpu")
        np.testing.assert_array_equal(eng.outputs(sid), o[:, 0].numpy())
        syn = eng.state_of(sid)["hidden"]["syn:input"]
        assert syn["w"] is tp["hidden"]["w_input"]
        assert torch.equal(syn["x_pre"], torch.zeros(1, 8))
    # learn=True is the session axis (tests/test_torch_serve.py): the
    # same streams learn, each session on its own weight
    eng = make_engine(tn, tp, EngineConfig(window=4, capacity=2, learn=True),
                      kind=kind, device="cpu")
    for sid, v in streams.items():
        eng.open(sid)
        eng.submit(sid, v)
        eng.close(sid)
    eng.drain()
    learned = [eng.state_of(sid)["hidden"]["syn:input"]["w"]
               for sid in streams]
    assert all(w.shape == tp["hidden"]["w_input"].shape
               and not torch.equal(w, tp["hidden"]["w_input"])
               for w in learned)
