"""The port's compile-time verifier (`repro_torch.analysis`) held against the
JAX package's (`repro.analysis`), on the CPU at small sizes.

* Every TB1xx, TB2xx, TB4xx, TB5xx and TB6xx defect of the reference's
  tests (`tests/test_analysis.py`, the TB5xx serve checks of
  `tests/test_serve_engine.py`, the topology encodings of
  `tests/test_topology.py`) is built the same way in both packages, the
  weights carried across with `weights.params_from_numpy`, and both must
  report the same sorted (code, severity, site) findings; the messages may
  differ only for TB230 and TB3xx, whose budget here is a CTA's shared
  memory on the card, not a TPU's VMEM.
* The hypothesis property tests inject program and graph defects into
  valid random artifacts and compare both packages.
* The shipped models, mappings, serve deployments and encodings check
  clean in both, with equal findings; the CLI gate
  (`python -m repro_torch.analysis --all --fail-on warning`) is green and
  `--kernels --json` prints no finding.
* TB3xx: the reference's fake-spec tests on the port's `TileModel` (CTA
  tiles, the shared-memory budget patched), and for each of the 12
  registered families: `check_kernel` is clean at every candidate route,
  and `resolve_blocks` returns what the wrapper's own plan function
  returns.
* The REPRO_CHECK hook runs once a `compile_program`, never inside
  `plan.run` with a compiled plan or a served window.
"""

import contextlib
import dataclasses
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import analysis as janalysis
from repro.core import events as jevents
from repro.core import mapping as jmp
from repro.core import neuron as jneuron
from repro.core import plasticity as jplasticity
from repro.core import snn_layers as jlayers
from repro.core import topology as jtopo
from repro.serve.engine import EngineConfig as JEngineConfig
from repro_torch import analysis
from repro_torch.core import events, neuron, plasticity, snn_layers
from repro_torch.core import mapping as mp
from repro_torch.core import plan as plan_mod
from repro_torch.core import topology as topo
from repro_torch.kernels import _build, registry
from repro_torch.kernels.common import lane_plan, plan_sms, rec_plan, \
    smem_budget
from repro_torch.serve import EngineConfig, make_engine
from repro_torch.weights import params_from_numpy

KEY = jax.random.PRNGKey(0)


def keys(diags):
    """The findings as sorted (code, severity, site)."""
    return sorted((d.code, d.severity, d.site) for d in diags)


def codes_of(diags):
    return {d.code for d in diags}


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# Each package's IR, so that one builder makes the same artifact in both.
J = SimpleNamespace(
    an=janalysis, LayerNode=jevents.LayerNode, Connection=jevents.Connection,
    NeuronProgram=jneuron.NeuronProgram, StateVar=jneuron.StateVar,
    Decay=jneuron.Decay, Threshold=jneuron.Threshold, LIF=jneuron.LIF,
    LI=jneuron.LI, NeuronSpec=jneuron.NeuronSpec,
    SynapseProgram=jplasticity.SynapseProgram, TraceVar=jplasticity.TraceVar,
    UpdateTerm=jplasticity.UpdateTerm, pair_stdp=jplasticity.pair_stdp,
    ff=jlayers.ff_integrate, branch=jlayers.branch_integrate,
    zeros=jnp.zeros, mp=jmp, topo=jtopo,
    plastic_ff=lambda **kw: jlayers.make_plastic_ff(KEY, **kw),
    srnn_ecg=lambda **kw: jlayers.make_srnn_ecg(KEY, **kw))
P = SimpleNamespace(
    an=analysis, LayerNode=events.LayerNode, Connection=events.Connection,
    NeuronProgram=neuron.NeuronProgram, StateVar=neuron.StateVar,
    Decay=neuron.Decay, Threshold=neuron.Threshold, LIF=neuron.LIF,
    LI=neuron.LI, NeuronSpec=neuron.NeuronSpec,
    SynapseProgram=plasticity.SynapseProgram, TraceVar=plasticity.TraceVar,
    UpdateTerm=plasticity.UpdateTerm, pair_stdp=plasticity.pair_stdp,
    ff=snn_layers.ff_integrate, branch=snn_layers.branch_integrate,
    zeros=torch.zeros, mp=mp, topo=topo,
    plastic_ff=lambda **kw: snn_layers.make_plastic_ff(_gen(), device="cpu",
                                                       **kw),
    srnn_ecg=lambda **kw: snn_layers.make_srnn_ecg(_gen(), device="cpu",
                                                   **kw))


def _lif(m, name, srcs, out_dim=8, neuron_=None):
    return m.LayerNode(name, neuron_ or m.LIF(), m.ff, inputs=tuple(srcs),
                       out_dim=out_dim)


def _chain(m, depth, width=8):
    nodes = [_lif(m, "n0", (m.Connection("input"),), width)]
    for i in range(1, depth):
        nodes.append(_lif(m, f"n{i}", (m.Connection(f"n{i - 1}"),), width))
    return nodes


def both(build):
    """(reference findings, port findings) of `build(m)` -> findings."""
    return build(J), build(P)


# ---------------------------------------------------------------------------
# diagnostics plumbing
# ---------------------------------------------------------------------------


def test_codes_and_severities_match_the_reference():
    """Every code keeps its default severity and its title, but for the
    four whose budget is now a CTA's shared memory."""
    assert analysis.CODES.keys() == janalysis.CODES.keys()
    assert analysis.SEVERITIES == janalysis.SEVERITIES
    changed = {"TB230", "TB304", "TB305", "TB306"}
    for code, (sev, title) in analysis.CODES.items():
        jsev, jtitle = janalysis.CODES[code]
        assert sev == jsev, code
        assert (title != jtitle) == (code in changed), code
        assert sev in analysis.SEVERITIES and title, code


def test_make_rejects_unknown_code():
    with pytest.raises(KeyError):
        analysis.make("TB999", "x", "nope")


def test_severity_ordering_and_worst():
    ds = [analysis.make("TB201", "a", "info thing"),
          analysis.make("TB105", "b", "warn thing"),
          analysis.make("TB110", "c", "err thing")]
    assert analysis.worst(ds) == "error"
    ranked = analysis.at_least(ds, "warning")
    assert [d.code for d in ranked] == ["TB110", "TB105"]
    assert analysis.at_least(ds, "info") and not analysis.at_least([], "info")


def test_raise_if_carries_diagnostics():
    d = analysis.make("TB110", "site", "boom")
    with pytest.raises(analysis.DiagnosticError) as ei:
        analysis.raise_if([d])
    assert ei.value.diagnostics == (d,)
    analysis.raise_if([analysis.make("TB105", "s", "warn")])  # below floor


def test_render_mentions_code_site_and_hint():
    txt = analysis.render([analysis.make("TB103", "hid", "cycle",
                                         hint="add delay=1")])
    assert "TB103" in txt and "hid" in txt and "add delay=1" in txt
    assert txt == janalysis.render([janalysis.make(
        "TB103", "hid", "cycle", hint="add delay=1")])


def test_polymorphic_check_dispatch():
    assert analysis.check("lif") == analysis.check_kernel("lif")
    prog = neuron.LIF().program
    assert analysis.check(prog) == analysis.check_program(prog)
    nodes = _chain(P, 2)
    assert codes_of(analysis.check(nodes)) == codes_of(
        analysis.check_nodes(nodes))
    enc = topo.encode(np.eye(4, dtype=np.float32), kind="sparse")
    assert analysis.check(enc) == analysis.check_topology(enc)
    with pytest.raises(TypeError):
        analysis.check(42)


# ---------------------------------------------------------------------------
# the shipped registry / models / mappings / CLI (the gate)
# ---------------------------------------------------------------------------


def test_registry_checks_clean():
    diags = analysis.check_kernels()
    assert not analysis.at_least(diags, "warning"), analysis.render(diags)


def _shipped():
    """(name, JAX nodes, JAX params, port nodes, port params) of the
    shipped models at small widths, the port's weights the reference's."""
    out = []
    for name, jf, tf in (
            ("srnn_ecg", lambda: jlayers.make_srnn_ecg(KEY, n_hidden=12),
             lambda: snn_layers.make_srnn_ecg(_gen(), n_hidden=12,
                                              device="cpu")),
            ("dhsnn_shd",
             lambda: jlayers.make_dhsnn_shd(KEY, n_in=32, n_hidden=24,
                                            n_out=8),
             lambda: snn_layers.make_dhsnn_shd(_gen(), n_in=32, n_hidden=24,
                                               n_out=8, device="cpu")),
            ("plastic_ff", lambda: jlayers.make_plastic_ff(KEY),
             lambda: snn_layers.make_plastic_ff(_gen(), device="cpu"))):
        jn, jp = jf()
        tn, _ = tf()
        out.append((name, jn, jp, tn, params_from_numpy(_np_tree(jp),
                                                        "cpu")))
    return out


@pytest.mark.parametrize("idx", range(3))
def test_builtin_models_check_clean_and_equal(idx):
    name, jn, jp, tn, tp = _shipped()[idx]
    ref = janalysis.check_nodes(jn, params=jp, T=64, B=4)
    got = analysis.check_nodes(tn, params=tp, T=64, B=4)
    assert not analysis.at_least(got, "warning"), \
        f"{name}:\n{analysis.render(got)}"
    assert keys(got) == keys(ref)


def test_builtin_mapping_checks_clean():
    from repro_torch.configs.snn_models import MODELS, to_ops
    specs, _ = MODELS["plif_net"]()
    ops = to_ops(specs)
    ir = mp.fuse_ops([dataclasses.replace(o) for o in ops])
    cores = mp.partition(ir)
    got = analysis.check_cores(cores, ir)
    assert not analysis.at_least(got, "error"), analysis.render(got)
    from repro.configs.snn_models import MODELS as JMODELS, to_ops as jto_ops
    jops = jto_ops(JMODELS["plif_net"]()[0])
    jir = jmp.fuse_ops([dataclasses.replace(o) for o in jops])
    assert keys(got) == keys(janalysis.check_cores(jmp.partition(jir), jir))


def test_cli_kernels_json(capsys):
    from repro_torch.analysis.__main__ import main
    assert main(["--kernels", "--fail-on", "warning", "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == []


def test_cli_all_gate_is_green(capsys):
    from repro_torch.analysis.__main__ import main
    assert main(["--all", "--fail-on", "warning"]) == 0
    out = capsys.readouterr().out
    assert "0 error(s), 0 warning(s)" in out


# ---------------------------------------------------------------------------
# TB1xx / TB2xx: the same injected defects in both packages
# ---------------------------------------------------------------------------


def _tb100(m):
    return m.an.check_program(m.NeuronProgram(
        states=(m.StateVar("v", m.Decay("const", 0.9)),),
        threshold=m.Threshold(on="ghost")))


def _tb102(m):
    return m.an.check_program(m.NeuronProgram(
        states=(m.StateVar("v", m.Decay("learned", 0.9, param="tau")),
                m.StateVar("u", m.Decay("learned", 0.8, param="tau"),
                           drive="spikes")),
        threshold=m.Threshold(on="v", adapt="u", scale=0.5)))


def _tb105(m):
    return m.an.check_program(m.NeuronProgram(
        states=(m.StateVar("v", m.Decay("const", 0.9)),
                m.StateVar("shadow", m.Decay("const", 0.5))),
        threshold=m.Threshold()))


def _tb108(m):
    return m.an.check_program(m.NeuronProgram(
        states=(m.StateVar("v", m.Decay("const", 1.5)),),
        threshold=m.Threshold()))


def _tb109_flat(m):
    return m.an.check_program(m.NeuronProgram(
        states=(m.StateVar("v", m.Decay("const", 0.9)),),
        threshold=m.Threshold(base=-1.0)))


def _tb109_noop_adapt(m):
    return m.an.check_program(m.NeuronProgram(
        states=(m.StateVar("v", m.Decay("const", 0.9)),
                m.StateVar("a", m.Decay("const", 0.7), drive="spikes")),
        threshold=m.Threshold(base=1.0, adapt="a", scale=0.0)))


def _tb106_tb108_trace(m):
    return m.an.check_synapse(m.SynapseProgram(
        traces=(m.TraceVar("x", "pre", m.Decay("const", 1.5)),),
        terms=(m.UpdateTerm(0.01),)))


def _tb101(m):
    nodes = _chain(m, 2)[:-1] + [_lif(m, "n1", (m.Connection("hiden"),))]
    return m.an.check_nodes(nodes)


def _tb103(m):
    return m.an.check_nodes([
        _lif(m, "a", (m.Connection("input"), m.Connection("b"))),
        _lif(m, "b", (m.Connection("a"),))])


def _tb104_orphan(m):
    return m.an.check_nodes(
        _chain(m, 2) + [_lif(m, "orphan", (m.Connection("self"),))])


def _tb104_dead(m):
    return m.an.check_nodes([
        _lif(m, "n0", (m.Connection("input"),)),
        _lif(m, "stub", (m.Connection("n0"),)),
        _lif(m, "n1", (m.Connection("n0"),))])


def _tb107(m):
    nodes, params = m.plastic_ff(n_in=8, n_hidden=8, n_out=4)
    del params["hidden"]["w_input"]
    return m.an.check_nodes(nodes, params=params)


def _tb110(m):
    nodes = [_lif(m, "h", (m.Connection("input"),)),
             m.LayerNode("o", m.LI(), m.ff, inputs=(m.Connection("h"),),
                         out_dim=4)]
    bad = {"h": {"w_input": m.zeros((16, 8))}, "o": {"w_h": m.zeros((8, 5))}}
    good = {"h": {"w_input": m.zeros((16, 8))}, "o": {"w_h": m.zeros((8, 4))}}
    return (m.an.check_nodes(nodes, params=bad)
            + m.an.check_nodes(nodes, params=good))


def _tb111(m):
    return m.an.check_nodes([m.LayerNode("z", m.LIF(), m.ff,
                                         inputs=(m.Connection("input"),))])


def _shared_weight_nodes(m, plastic_both):
    rule = m.pair_stdp()
    pre = _lif(m, "pre", (m.Connection("input"),))
    second = (m.Connection("pre", plastic=rule, weight="w_shared")
              if plastic_both else m.Connection("pre", weight="w_shared"))
    h = m.LayerNode("h", m.LIF(), m.ff,
                    inputs=(m.Connection("input", plastic=rule,
                                         weight="w_shared"), second),
                    out_dim=8)
    return [pre, h]


def _tb231(m):
    return m.an.check_nodes(_shared_weight_nodes(m, True))


def _tb232(m):
    return m.an.check_nodes(_shared_weight_nodes(m, False))


def _tb201(m):
    nodes = [_lif(m, "a", (m.Connection("input"), m.Connection("b"))),
             _lif(m, "b", (m.Connection("input"),))]
    return m.an.check_plan(nodes, plan=m.an.compile_quiet(nodes))


def _opaque(params, feeds):
    return sum(feeds.values())


def _tb202(m):
    return m.an.check_plan([m.LayerNode("a", m.LIF(), _opaque,
                                        inputs=(m.Connection("input"),),
                                        out_dim=8)])


def _tb203(m):
    return m.an.check_plan([_lif(m, "a", (m.Connection("input"),
                                          m.Connection("self", delay=1)))])


def _tb206(m):
    return m.an.check_plan([_lif(m, "a", (m.Connection("input"),),
                                 neuron_=m.LIF(reset="none"))])


def _tb207(m):
    return m.an.check_plan([m.LayerNode("a", m.LIF(), m.branch,
                                        inputs=(m.Connection("input"),),
                                        out_dim=8)])


def _tb205(m):
    return m.an.check_plan([m.LayerNode("a", m.NeuronSpec(), m.ff,
                                        inputs=(m.Connection("input"),),
                                        out_dim=8)])


def _tb210(m):
    rule = m.pair_stdp()
    big = dataclasses.replace(rule, terms=rule.terms + tuple(
        m.UpdateTerm(0.001) for _ in range(3)))
    nodes, _ = m.plastic_ff(n_in=8, n_hidden=8, rule=big)
    return m.an.check_plan(nodes, plan=m.an.compile_quiet(nodes))


def _mixed_fallbacks(m):
    return m.an.check_plan([
        m.LayerNode("a", m.LIF(), _opaque, inputs=(m.Connection("input"),),
                    out_dim=8),
        _lif(m, "b", (m.Connection("a"), m.Connection("self", delay=2))),
        _lif(m, "c", (m.Connection("b"),), 4)])


DEFECTS = {
    "TB100": _tb100, "TB102": _tb102, "TB105": _tb105, "TB108": _tb108,
    "TB109:flat": _tb109_flat, "TB109:noop_adapt": _tb109_noop_adapt,
    "TB106+TB108:trace": _tb106_tb108_trace, "TB101": _tb101,
    "TB103": _tb103, "TB104:orphan": _tb104_orphan,
    "TB104:dead": _tb104_dead, "TB107": _tb107, "TB110": _tb110,
    "TB111": _tb111, "TB231": _tb231, "TB232": _tb232, "TB201": _tb201,
    "TB202": _tb202, "TB203": _tb203, "TB206": _tb206, "TB207": _tb207,
    "TB205": _tb205, "TB210": _tb210, "TB202+TB203": _mixed_fallbacks,
}


@pytest.mark.parametrize("label", sorted(DEFECTS))
def test_injected_defect_matches_the_reference(label):
    ref, got = both(DEFECTS[label])
    assert set(label.split(":")[0].split("+")) <= codes_of(got), \
        analysis.render(got)
    assert keys(got) == keys(ref)
    # no TB230 or TB3xx among these: the messages are the reference's too
    assert sorted(map(str, got)) == sorted(map(str, ref))


def test_fallback_segments_all_carry_codes():
    nodes = [events.LayerNode("a", neuron.LIF(), _opaque,
                              inputs=(events.Connection("input"),),
                              out_dim=8),
             _lif(P, "b", (events.Connection("a"),
                           events.Connection("self", delay=2))),
             _lif(P, "c", (events.Connection("b"),), 4)]
    compiled = analysis.compile_quiet(nodes)
    for seg in compiled.segments:
        if seg.kind == plan_mod.FALLBACK:
            assert seg.codes and len(seg.codes) == len(seg.names)
            assert all(code in analysis.CODES for code in seg.codes)
            assert all(code in seg.reason for code in seg.codes)
    desc = compiled.describe()
    assert "TB202" in desc and "TB203" in desc


def test_tb230_predicted_smem_over_budget(monkeypatch):
    """TB230 flags the ECG SRNN's kernels when a CTA's budget is cut to
    50 KB (the reference flags its VMEM at 0.05 MiB), and nothing at the
    card's budget; the sites the port flags are sites of the program."""
    nodes, params = P.srnn_ecg()
    jnodes, jparams = J.srnn_ecg()
    from repro_torch.analysis import plans
    monkeypatch.setattr(plans, "smem_budget", lambda: 50 * 1024)
    monkeypatch.setenv("REPRO_VMEM_LIMIT_MB", "0.05")
    hits = [d for d in analysis.check_plan(nodes, T=256, B=8, params=params)
            if d.code == "TB230"]
    jhits = [d for d in janalysis.check_plan(jnodes, T=256, B=8,
                                             params=jparams)
             if d.code == "TB230"]
    assert hits and jhits and "B of shared memory" in hits[0].message
    sites = {n.name for n in nodes} | {f"{n.name}.{c.key}" for n in nodes
                                       for c in n.connections}
    assert {d.site for d in hits} <= sites
    monkeypatch.undo()
    assert "TB230" not in codes_of(
        analysis.check_plan(nodes, T=256, B=8, params=params))


# ---------------------------------------------------------------------------
# TB4xx: mapping defects
# ---------------------------------------------------------------------------


def _tb401(m):
    ops = [m.mp.Op("a", "fc", n_neurons=40, fan_in=16, inputs=("input",))]
    return (m.an.check_cores([m.mp.CoreAssignment("a", 0, 40)], ops,
                             core_neurons=32)
            + m.an.check_cores([m.mp.CoreAssignment("a", 8, 4)], ops,
                               core_neurons=64))


def _tb402(m):
    ops = [m.mp.Op("a", "fc", 8, 4, inputs=("input",)),
           m.mp.Op("b", "fc", 12, 4, inputs=("a",))]
    holey = [m.mp.CoreAssignment("a", 0, 8), m.mp.CoreAssignment("b", 0, 4),
             m.mp.CoreAssignment("b", 8, 12)]
    return (m.an.check_cores([m.mp.CoreAssignment("a", 0, 8)], ops)
            + m.an.check_cores(holey, ops))


def _tb403(m):
    ops = [m.mp.Op("a", "fc", 4, 4, inputs=("input",))]
    off = m.mp.Mapping(cores=[m.mp.CoreAssignment("a", 0, 4)],
                       positions=np.array([[99, 0]]), cost=0.0)
    short = m.mp.Mapping(cores=[m.mp.CoreAssignment("a", 0, 4)],
                         positions=np.zeros((0, 2), int), cost=0.0)
    return m.an.check_mapping(off, ops) + m.an.check_mapping(short, ops)


def _tb404(m):
    ops = [m.mp.Op("wide", "fc", 4,
                   fan_in=m.mp.CORE_FANIN * (m.mp.CORE_NEURONS + 1),
                   inputs=("input",))]
    return m.an.check_cores([m.mp.CoreAssignment("wide", 0, 4)], ops)


def _tb405(m):
    ops = [m.mp.Op("s", "fc", 2, 0), m.mp.Op("c", "fc", 10, 4, inputs=("s",))]
    mapping = m.mp.Mapping(cores=[m.mp.CoreAssignment("s", 0, 2),
                                  m.mp.CoreAssignment("c", 0, 10)],
                           positions=np.array([[0, 0], [0, 1]]), cost=0.0)
    return (m.an.check_mapping(mapping, ops, link_fanout=10)
            + m.an.check_mapping(mapping, ops, link_fanout=100))


@pytest.mark.parametrize("code,build", [
    ("TB401", _tb401), ("TB402", _tb402), ("TB403", _tb403),
    ("TB404", _tb404), ("TB405", _tb405)])
def test_mapping_defect_matches_the_reference(code, build):
    ref, got = both(build)
    assert code in codes_of(got)
    assert keys(got) == keys(ref)
    assert sorted(map(str, got)) == sorted(map(str, ref))


# ---------------------------------------------------------------------------
# TB5xx: serve deployments
# ---------------------------------------------------------------------------

W, C = 8, 4


def _serve_model():
    jn, jp = jlayers.make_dhsnn_shd(KEY, n_in=12, n_hidden=16, n_out=5,
                                    dendritic=False)
    tn, _ = snn_layers.make_dhsnn_shd(_gen(), n_in=12, n_hidden=16, n_out=5,
                                      dendritic=False, device="cpu")
    return jn, jp, tn, params_from_numpy(_np_tree(jp), "cpu")


def test_session_footprint_matches_the_reference():
    jn, jp, tn, tp = _serve_model()
    assert analysis.session_footprint(tn, tp) == \
        janalysis.session_footprint(jn, jp)
    jn, jp = jlayers.make_plastic_ff(KEY, n_in=10, n_hidden=12, n_out=3)
    tn, _ = snn_layers.make_plastic_ff(_gen(), n_in=10, n_hidden=12, n_out=3,
                                       device="cpu")
    tp = params_from_numpy(_np_tree(jp), "cpu")
    assert analysis.session_footprint(tn, tp) == \
        janalysis.session_footprint(jn, jp)


def _cfgs(fp):
    return {
        "clean": (EngineConfig(window=W, capacity=C, queue_limit=32,
                               cache_bytes=C * fp),
                  JEngineConfig(window=W, capacity=C, queue_limit=32,
                                cache_bytes=C * fp)),
        "budget_and_queue": (SimpleNamespace(window=W, capacity=C,
                                             queue_limit=C - 1,
                                             cache_bytes=fp - 1),) * 2,
        "thrash": (SimpleNamespace(window=W, capacity=C, queue_limit=None,
                                   cache_bytes=C * fp - 1),) * 2,
        "invalid": (SimpleNamespace(window=0, capacity=-1, queue_limit=0,
                                    cache_bytes=0),) * 2,
    }


@pytest.mark.parametrize("case,want", [
    ("clean", set()), ("budget_and_queue", {"TB501", "TB504"}),
    ("thrash", {"TB502"}), ("invalid", {"TB505"})])
def test_check_serve_matches_the_reference(case, want):
    jn, jp, tn, tp = _serve_model()
    fp = analysis.session_footprint(tn, tp)
    cfg, jcfg = _cfgs(fp)[case]
    got = analysis.check_serve(tn, tp, cfg)
    ref = janalysis.check_serve(jn, jp, jcfg)
    assert codes_of(got) == want
    assert keys(got) == keys(ref)
    assert sorted(map(str, got)) == sorted(map(str, ref))
    if case == "invalid":
        assert len(got) == 4 and all(d.severity == "error" for d in got)


def test_check_serve_flags_fallback_plan():
    """TB503: a plan with a stepper segment inside the window step."""
    def build(m):
        nodes = [_lif(m, "a", (m.Connection("input"),
                               m.Connection("self", delay=1))),
                 m.LayerNode("o", m.LI(), m.ff, inputs=(m.Connection("a"),),
                             out_dim=3)]
        params = {"a": {"w_input": m.zeros((6, 8)), "w_self": m.zeros((8, 8))},
                  "o": {"w_a": m.zeros((8, 3))}}
        return m.an.check_serve(nodes, params, SimpleNamespace(
            window=W, capacity=C, queue_limit=None, cache_bytes=None))
    ref, got = both(build)
    assert codes_of(got) == {"TB503"} and keys(got) == keys(ref)


# ---------------------------------------------------------------------------
# TB6xx: compressed-topology encodings
# ---------------------------------------------------------------------------


def _encodings(m):
    rng = np.random.default_rng(0)
    dense = rng.normal(size=(40, 30)).astype(np.float32)
    sparse = dense * (rng.random((40, 30)) < 0.1)
    filt = rng.normal(size=(4, 3, 3, 3)).astype(np.float32)
    tp = m.topo
    return {
        "fc": tp.encode(dense, kind="fc", n_cores=4),
        "sparse_t0": tp.encode(sparse, kind="sparse", ie_type=0),
        "sparse_t1": tp.encode(sparse, kind="sparse", ie_type=1),
        "conv": tp.encode(filt, kind="conv", h=8, w=8),
        "pool": tp.encode(None, kind="pool", h=8, w=8, c=3, k=2),
        "skip": tp.encode(tp.encode(sparse, kind="sparse"), kind="skip",
                          delay=3),
    }


def _miscount(m, name):
    enc = _encodings(m)[name]
    enc.meta["n_connections"] = int(enc.meta["n_connections"]) + 1
    return enc


def _long_delay(m):
    enc = _encodings(m)["skip"]
    enc.meta["delay"] = 1 << m.topo.BITS["delay"]
    return enc


def _duplicates(m):
    pre, post = np.array([0, 1, 1, 2]), np.array([2, 0, 0, 1])
    w = np.ones(4, np.float32)
    return m.topo.encode((pre, post, w), kind="sparse_coo", n_pre=3,
                         n_post=3)


def _holey_fc(m):
    enc = _encodings(m)["fc"]
    de = enc.fan_in[0]
    enc.fan_in[0] = dataclasses.replace(de, ies=de.ies[1:])
    return enc


TOPOLOGY_CASES = {
    **{f"clean:{k}": (lambda k: lambda m: _encodings(m)[k])(k)
       for k in ("fc", "sparse_t0", "sparse_t1", "conv", "pool", "skip")},
    "TB604:fc": lambda m: _miscount(m, "fc"),
    "TB604:sparse": lambda m: _miscount(m, "sparse_t1"),
    "TB605": _long_delay,
    "TB602": _duplicates,
    "TB603": _holey_fc,
}


@pytest.mark.parametrize("label", sorted(TOPOLOGY_CASES))
def test_topology_matches_the_reference(label):
    ref, got = both(lambda m: m.an.check_topology(TOPOLOGY_CASES[label](m)))
    want = set() if label.startswith("clean") else \
        set(label.split(":")[0].split("+"))
    assert want <= codes_of(got), analysis.render(got)
    if label.startswith("clean"):
        assert got == []
    assert keys(got) == keys(ref)
    assert sorted(map(str, got)) == sorted(map(str, ref))


# ---------------------------------------------------------------------------
# property tests: mutate valid random artifacts per defect class
# ---------------------------------------------------------------------------


def _program_defect(m, n, code):
    base = m.NeuronProgram(states=(m.StateVar("v", m.Decay("const", 0.9)),),
                           threshold=m.Threshold())
    if code == "TB102":
        extra = tuple(m.StateVar(f"s{i}", m.Decay("learned", 0.9,
                                                  param="tau"))
                      for i in range(n + 1))
        prog = dataclasses.replace(base, states=base.states + extra)
    elif code == "TB105":
        extra = tuple(m.StateVar(f"s{i}", m.Decay("const", 0.5))
                      for i in range(n))
        prog = dataclasses.replace(base, states=base.states + extra)
    else:
        prog = dataclasses.replace(
            base, states=(m.StateVar("v", m.Decay("const", 1.0 + n)),))
    return m.an.check_program(base), m.an.check_program(prog)


@settings(max_examples=12, deadline=None)
@given(st.integers(min_value=1, max_value=3),
       st.sampled_from(["TB102", "TB105", "TB108"]))
def test_property_injected_program_defects(n, code):
    (jbase, jbad), (base, bad) = both(lambda m: _program_defect(m, n, code))
    assert base == [] and jbase == []
    assert code in codes_of(bad)
    assert keys(bad) == keys(jbad)


def _graph_defect(m, depth, code):
    nodes = _chain(m, depth)
    last = f"n{depth - 1}"
    if code == "TB101":
        bad = nodes[:-1] + [_lif(m, last, (m.Connection("nope"),))]
    elif code == "TB103":
        bad = [_lif(m, "n0", (m.Connection("input"), m.Connection(last)))]
        bad += nodes[1:]
    elif code == "TB104":
        bad = nodes + [_lif(m, "orphan", (m.Connection("self"),))]
    else:
        bad = nodes[:-1] + [m.LayerNode(
            last, m.LIF(), m.ff, inputs=(m.Connection(f"n{depth - 2}"),))]
    return m.an.check_nodes(nodes), m.an.check_nodes(bad)


@settings(max_examples=12, deadline=None)
@given(st.integers(min_value=2, max_value=5),
       st.sampled_from(["TB101", "TB103", "TB104", "TB111"]))
def test_property_injected_graph_defects(depth, code):
    (jclean, jbad), (clean, bad) = both(
        lambda m: _graph_defect(m, depth, code))
    assert not analysis.at_least(clean, "warning")
    assert keys(clean) == keys(jclean)
    assert code in codes_of(bad)
    assert keys(bad) == keys(jbad)


# ---------------------------------------------------------------------------
# TB3xx: kernel-spec defects via a throwaway registered spec (CTA tiles)
# ---------------------------------------------------------------------------


def _noop(*args, **kw):
    return None


@contextlib.contextmanager
def fake_spec(name="_tb_test", preferred=8, align=4, coverage=None,
              smem=None, candidates=(), tile_model="default"):
    """A family of one CTA tile of `bm` rows over M = 32, its plan the
    reference's `fit_block`; `smem(dims, blocks)` its launch's dynamic
    shared memory (default: exactly its declared buffer)."""
    def plan(dims, n_sm, overrides):
        pref = int(overrides.get("bm", preferred))
        return {"bm": pref if dims["M"] > pref else
                max(align, -(-dims["M"] // align) * align)}

    def launches(dims, blocks):
        size = (smem or (lambda d, b: 4 * b["bm"]))(dims, blocks)
        return (registry.Launch("fake_kernel", (-(-dims["M"] // blocks["bm"]),
                                                1, 1), 32, size),)
    if tile_model == "default":
        tile_model = registry.TileModel(
            out=(("M", "bm"),),
            tiles=lambda dims, blocks: {"x": (blocks["bm"],)},
            launches=launches, coverage=coverage)
    spec = registry.KernelSpec(
        name=name, plain=_noop, cuda=_noop,
        block_axes=(registry.BlockAxis("bm", "M", preferred, align),),
        dims_of=lambda: {"M": 32}, plan=plan,
        make_inputs=lambda generator: (),
        candidates=tuple(candidates), tile_model=tile_model)
    registry.register(spec)
    try:
        yield spec
    finally:
        registry._REGISTRY.pop(name, None)


def test_tb301_coverage_gap():
    with fake_spec(coverage=lambda dims, blocks: [((0, 16),)]) as spec:
        hits = [d for d in analysis.check_kernel(spec.name)
                if d.code == "TB301"]
    assert hits and "never written" in hits[0].message


def test_tb302_coverage_overlap():
    with fake_spec(coverage=lambda dims, blocks:
                   [((0, 32),), ((8, 16),)]) as spec:
        hits = [d for d in analysis.check_kernel(spec.name)
                if d.code == "TB302"]
    assert hits and "more than once" in hits[0].message


def test_tb303_misaligned_preferred_block():
    with fake_spec(preferred=6, align=4) as spec:
        assert "TB303" in codes_of(analysis.check_kernel(spec.name))


def test_tb304_smem_model_underestimates():
    # declared buffer: 8 floats = 32 B; the launch asks for 8 B
    with fake_spec(smem=lambda dims, blocks: 8) as spec:
        assert "TB304" in codes_of(analysis.check_kernel(spec.name))


def test_tb305_tb306_smem_model_too_loose_and_over_budget(monkeypatch):
    from repro_torch.analysis import kernels as akernels
    monkeypatch.setattr(akernels, "smem_budget", lambda: 48 * 1024)
    with fake_spec(smem=lambda dims, blocks: 64 * 1024) as spec:
        got = codes_of(analysis.check_kernel(spec.name))
    assert {"TB305", "TB306"} <= got


def test_tb306_budget_is_the_cards_shared_memory(monkeypatch):
    """The budget is an sm_90 CTA's opt-in shared memory off the card:
    a tile of 227 KB passes, one byte more does not."""
    assert smem_budget() == _build.SM90_SMEM_OPTIN == 232448
    for size, flagged in ((232448, False), (232449, True)):
        with fake_spec(smem=lambda dims, blocks: size) as spec:
            got = codes_of(analysis.check_kernel(spec.name))
        assert ("TB306" in got) == flagged


def test_tb308_candidate_names_unknown_axis():
    with fake_spec(candidates=({"bogus": 8},)) as spec:
        hits = [d for d in analysis.check_kernel(spec.name)
                if d.code == "TB308"]
    assert hits and "bogus" in hits[0].message


def test_tb309_spec_without_tile_model():
    with fake_spec(tile_model=None) as spec:
        assert "TB309" in codes_of(analysis.check_kernel(spec.name))


def test_honest_fake_spec_checks_clean():
    with fake_spec(candidates=({"bm": 16}, {"M": 37})) as spec:
        diags = analysis.check_kernel(spec.name)
    assert not diags, analysis.render(diags)


def test_tb307_block_table_violations():
    flags = np.array([[1, 1], [1, 0]], np.int32)
    ok = analysis.check_block_table(
        flags, ii=[0, 0, 1], kk=[0, 1, 0], active=[1, 1, 1])
    assert ok == []
    dup = analysis.check_block_table(
        flags, ii=[0, 0, 0, 1], kk=[0, 1, 1, 0], active=[1, 1, 1, 1])
    assert any("twice" in p for p in dup)
    missed = analysis.check_block_table(
        flags, ii=[0, 0], kk=[0, 1], active=[1, 1])
    assert any("never visited" in p for p in missed)
    assert any("absent" in p for p in missed)        # row 1 unrepresented
    ghost = analysis.check_block_table(
        flags, ii=[0, 0, 1, 1], kk=[0, 1, 0, 1], active=[1, 1, 1, 1])
    assert any("silent block" in p for p in ghost)
    unsorted_rows = analysis.check_block_table(
        flags, ii=[1, 0, 0], kk=[0, 0, 1], active=[1, 1, 1])
    assert any("non-decreasing" in p for p in unsorted_rows)
    for args in ((flags, [0, 0, 1], [0, 1, 0], [1, 1, 1]),
                 (flags, [0, 0, 0, 1], [0, 1, 1, 0], [1, 1, 1, 1])):
        assert analysis.check_block_table(*args) == \
            janalysis.check_block_table(*args)


def test_tb307_compact_blocks_is_faithful():
    """The port's `compact_blocks` passes TB307 on the occupancy patterns
    of the sparse channel's check and on random bitmaps, and gives the
    reference's table (tensors on the host, as the card's flags come)."""
    from repro.kernels.spikemm import sparse as jsparse
    from repro_torch.kernels.spikemm.sparse import compact_blocks
    rng = np.random.default_rng(3)
    for shape, p in (((5, 7), 0.3), ((1, 1), 1.0), ((4, 2), 0.0),
                     ((9, 3), 0.6)):
        flags = (rng.random(shape) < p).astype(np.int32)
        assert analysis.check_flags("t", flags) == []
        got = [t.numpy() for t in compact_blocks(torch.from_numpy(flags))]
        ref = [np.asarray(t) for t in jsparse.compact_blocks(
            jnp.asarray(flags))]
        n = len(got[0])          # the reference pads its table to a fixed
        for g, r in zip(got, ref):   # length with trailing sentinels
            np.testing.assert_array_equal(g, r[:n])
    assert not analysis.check_kernel("spikemm")


def test_coverage_problems_ragged_tail_is_exact():
    tm = registry.TileModel(out=(("M", "bm"),),
                            tiles=lambda dims, blocks: {})
    assert analysis.coverage_problems(tm, {"M": 10}, {"bm": 4}) == []


# ---------------------------------------------------------------------------
# the 12 registered families: clean at every route, the wrappers' own plan
# ---------------------------------------------------------------------------


def _spikemm_plan(d, n_sm):
    from repro_torch.kernels.spikemm.ops import col_tile, rows_per_cta
    return {"bm": rows_per_cta(d["M"], d["N"], n_sm), "cw": col_tile(d["N"])}


def _sessions_plan(d, n_sm):
    from repro_torch.kernels.spikemm.ops import session_tile
    bm, cw = session_tile(d["T"], d["N"], n_sm, d["S"])
    return {"sb": 1, "bm": bm, "cw": cw}


def _gather_plan(d, n_sm):
    from repro_torch.kernels.spikemm.gather import gather_plan
    p = gather_plan(d["M"], d["BN"], d["JB"], n_sm)
    return {"rows": p.rows, "cols": p.cols, "units": p.units,
            "groups": p.groups}


def _lane(d, n_sm):
    warps, _, stages = lane_plan(d["L"], d["T"], n_sm)
    return {"lb": 32 * warps, "bt": d["T"], "stages": stages}


def _rec(d, n_sm):
    p = rec_plan(d["N"], d["B"], smem_budget())
    return {"rows": -(-d["B"] // p.grid), "bt": d["T"], "unit": p.unit,
            "warp": int(p.route == "warp"), "w_smem": int(p.w_smem)}


def _stdp_seq_plan(d, n_sm):
    from repro_torch.kernels.stdp.ops import stdp_seq_plan
    tm, tn, *_ = stdp_seq_plan(d["M"], d["N"])
    return {"tm": tm, "tn": tn}


def _stdp_sessions_plan(d, n_sm):
    from repro_torch.kernels.stdp.ops import stdp_session_tile
    tm, tn, _, _ = stdp_session_tile(d["S"], d["M"], d["N"], n_sm)
    return {"sb": 1, "tm": tm, "tn": tn}


def _stdp_plan(d, n_sm):
    from repro_torch.kernels.stdp.ops import stdp_pair_plan
    return {"pb": stdp_pair_plan(d["M"], d["N"])[1]}


def _attention_plan(d, n_sm):
    from repro_torch.kernels.attention import ops
    dtype = torch.bfloat16 if d["bf16"] else torch.float32
    p = ops.plan_call(d["BH"], d["T"], d["S"], d["d"], dtype, n_sm)
    if p.route == ops.TENSOR_CORES:
        return {"bq": ops.TC_BLOCK_Q, "dt": d["d"], "nsplit": p.nsplit,
                "tc": 1}
    return {"bq": ops.CC_BLOCK_Q, "dt": ops.head_tile(d["d"]), "nsplit": 1,
            "tc": 0}


WRAPPER_PLANS = {
    "alif": _lane, "alifrec": _rec, "attention": _attention_plan,
    "lif": _lane, "lifrec": _rec, "linrec": _lane, "spikemm": _spikemm_plan,
    "spikemm_gather": _gather_plan, "spikemm_sessions": _sessions_plan,
    "stdp": _stdp_plan, "stdp_seq": _stdp_seq_plan,
    "stdp_seq_sessions": _stdp_sessions_plan,
}


def test_twelve_families_declare_tiles():
    assert set(registry.names()) == set(WRAPPER_PLANS)
    for name in WRAPPER_PLANS:
        spec = registry.get(name)
        assert spec.tile_model is not None and spec.plan is not None, name
        assert spec.candidates, name


@pytest.mark.parametrize("name", sorted(WRAPPER_PLANS))
def test_family_checks_clean_with_the_wrappers_plan(name):
    spec = registry.get(name)
    assert analysis.check_kernel(name) == []
    dims = spec.dims_of(*spec.make_inputs(_gen()), **spec.static)
    n_sm = plan_sms()
    shapes = analysis.route_shapes(spec, dims, n_sm=n_sm)
    assert len(shapes) == 1 + len(spec.candidates)
    for label, d, blocks in shapes:
        cand = dict(spec.candidates[int(label[11:-1])]) \
            if label != "default" else {}
        pins = {k: v for k, v in cand.items() if k not in d}
        if pins:         # a pinned route: the pinned axes are its plan's
            assert {k: blocks[k] for k in pins} == pins, label
        else:
            assert blocks == WRAPPER_PLANS[name](d, n_sm), label
        launches = spec.launches(d, blocks)
        assert launches and all(x.smem <= smem_budget() for x in launches)
        assert all(min(x.grid) >= 1 and 1 <= x.threads <= 1024
                   for x in launches), launches
    # the routes the candidates reach are distinct launches
    assert len({spec.launches(d, b) for _, d, b in shapes}) > 1 \
        or name == "stdp"


def _lane_bwd(d, n_sm):
    from repro_torch.kernels.common import lane_bwd_plan
    return {"lb": 32, "bt": d["T"],
            "segments": lane_bwd_plan(d["L"], d["T"])[2]}


def _rec_bwd(d, n_sm):
    p = rec_plan(d["N"], d["B"], smem_budget(), backward=True)
    return {"rows": 1, "bt": d["T"], "unit": p.unit,
            "warp": int(p.route == "warp"), "w_smem": int(p.w_smem)}


def _linrec_bwd(d, n_sm):
    from repro_torch.kernels.linrec.ops import linrec_bwd_plan
    p = linrec_bwd_plan(d["T"], d["B"], d["N"], d["P"] == 2, d["GA"],
                        bool(d["V"]))
    return {"lb": 32, "bt": d["T"], "tma": int(p.tma), "rows": p.rows}


def _wgrad(d, n_sm):
    from repro_torch.kernels.spikemm.wgrad import wgrad_chunk, wgrad_tile
    bm, cw, cluster = wgrad_tile(d["K"], d["N"])
    return {"bm": bm, "cw": cw, "cluster": cluster,
            "chunk": wgrad_chunk(d["R"], d["K"], d["N"])}


def _gather_bwd(d, n_sm):
    from repro_torch.kernels.spikemm.gather import gather_bwd_plan
    return {"rows": gather_bwd_plan(d["M"], d["BK"], -(-d["K"] // d["BK"]),
                                    n_sm).rows}


BWD_PLANS = {"lif": ("lif_bwd", _lane_bwd), "alif": ("alif_bwd", _lane_bwd),
             "lifrec": ("lifrec_bwd", _rec_bwd),
             "alifrec": ("alifrec_bwd", _rec_bwd),
             "linrec": ("linrec_bwd", _linrec_bwd),
             "spikemm": ("spikemm_wgrad", _wgrad),
             "spikemm_gather": ("spikemm_gather_bwd", _gather_bwd)}


@pytest.mark.parametrize("family", sorted(BWD_PLANS))
def test_backward_kernel_checks_clean_with_the_wrappers_plan(family):
    """Each hand backward kernel (B1-B6 and the recurrent ones) declares
    its tiles on `bwd_tiles`, named as its launch counter; it checks clean
    at every route and its plan is the one its wrapper launches with."""
    name, want = BWD_PLANS[family]
    spec = registry.get(family).bwd_tiles
    assert spec is not None and spec.name == name
    assert registry.get(family).wrappers()[name] is spec.cuda
    assert analysis.check_spec(spec) == []
    dims = spec.dims_of(*spec.make_inputs(_gen()), **spec.static)
    n_sm = plan_sms()
    shapes = analysis.route_shapes(spec, dims, n_sm=n_sm)
    for label, d, blocks in shapes:
        assert blocks == want(d, n_sm), label
        launches = spec.launches(d, blocks)
        assert len(launches) == 1 and launches[0].smem <= smem_budget()
    assert len({spec.launches(d, b) for _, d, b in shapes}) > 1


def test_rec_bwd_plan_routes():
    """The backward's routes: KP chain threads (a multiple of 32 covering
    the row) up to 128 neurons; W_rec in shared memory beside two masks
    and two Gu rows up to 240 neurons at 227 KB."""
    budget = _build.SM90_SMEM_OPTIN
    assert rec_plan(70, 5, budget, backward=True)[:2] == ("warp", 96)
    assert rec_plan(128, 5, budget, backward=True).threads == 256
    assert rec_plan(240, 5, budget, backward=True).w_smem
    assert not rec_plan(241, 5, budget, backward=True).w_smem
    assert rec_plan(241, 5, budget).w_smem        # the forward's edge


def test_linrec_bwd_plan_routes():
    """One tensor copy a plane for a call of at most 256 steps with no
    decay plane and copyable rows; cp.async segments, a ring of at most
    8, otherwise."""
    from repro_torch.kernels.linrec.ops import GA_NONE, GA_SUM, \
        linrec_bwd_plan
    p = linrec_bwd_plan(32, 64, 256, False, GA_SUM, True)
    assert p.tma and p.rows == 32 and p.planes == 2
    assert p.smem == 4 * (32 + 32) * 2 * 32 + 128 and p.grid == 512
    assert not linrec_bwd_plan(32, 64, 256, True, GA_NONE, True).tma
    assert not linrec_bwd_plan(32, 64, 256, False, GA_NONE, False).tma
    p = linrec_bwd_plan(300, 8, 256, False, GA_NONE, True)
    assert not p.tma and p.rows == 256 and p.planes == 1


def test_pinned_routes_are_the_wrappers_own():
    """A pinned route is one the wrapper's plan takes: the sparse tile at
    each of `SPARSE_TILES` (`sparse_tile` picks one of them) and the
    gather's column instantiation (`gather_plan(cols=)`)."""
    from repro_torch.kernels.spikemm.gather import gather_plan
    from repro_torch.kernels.spikemm.sparse import SPARSE_TILES, sparse_tile
    spec = registry.get("spikemm")
    for M, N in ((2048, 512), (2048, 20)):
        st = sparse_tile(M, N, plan_sms())
        assert st in SPARSE_TILES
        assert spec.resolve_blocks({"M": M, "K": 700, "N": N},
                                   {"st": st}) == {"st": st}
    g = registry.get("spikemm_gather")
    d = {"M": 64, "K": 512, "N": 512, "BK": 128, "BN": 128, "JB": 4}
    for cols in (1, 4):
        p = gather_plan(64, 128, 4, plan_sms(), cols=cols)
        assert g.resolve_blocks(d, {"cols": cols}) == {
            "rows": p.rows, "cols": cols, "units": p.units,
            "groups": p.groups}


def test_rec_plan_routes_and_budget():
    """The recurrent scan's plan: the warp route up to 128 neurons, the
    block route with W_rec in shared memory while it fits the budget (241
    neurons at 227 KB), through L2 above, two neurons a thread past
    1024."""
    budget = _build.SM90_SMEM_OPTIN
    assert rec_plan(128, 64, budget).route == "warp"
    assert rec_plan(129, 64, budget)[:3] == ("block", 1, True)
    assert rec_plan(241, 64, budget).w_smem
    assert not rec_plan(242, 64, budget).w_smem
    assert rec_plan(1025, 3, budget)[:2] == ("block", 2)
    assert rec_plan(64, 64, budget).smem <= budget
    assert not rec_plan(200, 1, 100 * 1024).w_smem


# ---------------------------------------------------------------------------
# the REPRO_CHECK hook: once a compile, never a window
# ---------------------------------------------------------------------------


def test_hook_runs_once_a_compile_and_never_a_window(monkeypatch):
    tn, tp = snn_layers.make_dhsnn_shd(_gen(), n_in=12, n_hidden=8, n_out=3,
                                       device="cpu")
    calls = []
    real = analysis.check_nodes

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(analysis, "check_nodes", spy)
    monkeypatch.setenv("REPRO_CHECK", "raise")
    compiled = plan_mod.compile_program(tn)
    assert len(calls) == 1
    x = torch.zeros(4, 2, 12)
    plan_mod.run(tn, tp, x, plan=compiled, device="cpu")
    assert len(calls) == 1
    eng = make_engine(tn, tp, EngineConfig(window=4, capacity=2),
                      plan=compiled, device="cpu")
    sid = eng.open()
    eng.submit(sid, np.zeros((12, 12), np.float32))
    eng.close(sid)
    eng.drain()
    assert len(calls) == 1
    make_engine(tn, tp, EngineConfig(window=4, capacity=2), device="cpu")
    assert len(calls) == 2          # an engine without a plan compiles one
    analysis.compile_quiet(tn)
    assert len(calls) == 2          # the analyzer's own compile is latched
