"""The port's streaming serve engine, on the CPU.

* The JAX `BatchedEngine` and the port's (`device="cpu"`) replay the same
  small ragged arrival trace with the same weights; per-session outputs
  agree within `CROSS_ENGINE_ATOL`, on a trace where the hidden layer
  fires in at least 1 % of its lane-steps.
* Isolation: a session's outputs and final state are bit-identical
  (`torch.equal`) solo, interleaved with strangers, and under a 1-byte
  cache that evicts and restores it every window — for both engines.
  Fixed cases, no time deadline.
* The ECG SRNN (self-recurrent ALIF, and its LIF ablation) served by
  both engines equals a one-shot `plan.run` of each session exactly: the
  recurrence carries across windows through state["out"]. The isolation
  property holds on it, and a packed cohort state carries the ALIF trace
  `a` and the recurrent `out` per slot, with zero free slots.
* `queue_limit` backpressure accepts and rejects the same chunks as the
  JAX engine and records each rejection on the incident log.
* The engine's window step routes spikemm as the JAX package's jitted
  step does: dense under `auto` whatever the occupancy (no occupancy is
  measured), sparse only where `REPRO_SPIKEMM_SPARSE=always` pins it.
* `EngineConfig(learn=True)` on a plastic program (a weight a session:
  the session-batched spikemm and stdp_seq) against the JAX engine's
  per-session `vmap`, both engines: outputs and every session's learned
  synapses; each session's synapses stay its own (solo == interleaved ==
  evicted and restored, bit for bit), and learn=True on a program without
  plasticity serves the flat path.
* Entry points called without a device on a machine with no card raise.
* A program whose input edge is a compressed topology serves: the engine
  reads the input width from the topology.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.snn_layers import make_dhsnn_shd as jmake_dhsnn
from repro.core.snn_layers import make_plastic_ff as jmake_plastic_ff
from repro.core.snn_layers import make_srnn_ecg as jmake_srnn
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import make_engine as jmake_engine
from repro_torch.core import events, plan
from repro_torch.core.snn_layers import (make_dhsnn_shd, make_plastic_ff,
                                         make_srnn_ecg)
from repro_torch.kernels import registry
from repro_torch.kernels.incidents import clear, incidents
from repro_torch.serve import EngineConfig, make_engine
from repro_torch.weights import params_from_numpy

W, C, N_IN = 8, 4, 12


def _models(dendritic):
    jn, jp = jmake_dhsnn(jax.random.PRNGKey(0), n_in=N_IN, n_hidden=16,
                         n_out=5, dendritic=dendritic)
    tn, _ = make_dhsnn_shd(torch.Generator().manual_seed(0), n_in=N_IN,
                           n_hidden=16, n_out=5, dendritic=dendritic,
                           device="cpu")
    return (jn, jp), (tn, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu"))


def _trace(n_sessions, seed=0):
    """[(round, sid, chunk)]: session i arrives at round i % 3, streams
    20 + 4 * (i % 6) steps in chunks cycling 5/7/9/11 (like
    `bench_serving._trace`, at a small size)."""
    rng = np.random.default_rng(seed)
    sizes = (5, 7, 9, 11)
    ev = []
    for i in range(n_sessions):
        total = 20 + 4 * (i % 6)
        x = (rng.random((total, N_IN)) < 0.25).astype(np.float32)
        off, r = 0, i % 3
        while off < total:
            n = min(sizes[(i + r) % len(sizes)], total - off)
            ev.append((r, f"s{i}", x[off:off + n]))
            off += n
            r += 1
    ev.sort(key=lambda e: e[0])
    return ev


def _hidden_rate(model, trace):
    """Share of hidden lane-steps that fire when the trace's sessions run
    side by side through the port's `plan.run`."""
    nodes, params = model
    streams = {}
    for _, sid, chunk in trace:
        streams.setdefault(sid, []).append(chunk)
    xs = [np.concatenate(v) for v in streams.values()]
    x = np.zeros((max(len(v) for v in xs), len(xs), N_IN), np.float32)
    for b, v in enumerate(xs):
        x[:len(v), b] = v
    _, _, rec = plan.run(nodes, params, torch.from_numpy(x),
                         record=("hidden",), device="cpu")
    return float(rec["hidden"].mean())


def _replay(eng, trace):
    last = {}
    for r, sid, _ in trace:
        last[sid] = max(last.get(sid, -1), r)
    cur = 0
    for r, sid, chunk in trace:
        while r > cur:
            eng.step()
            cur += 1
        if sid not in eng.scheduler.sessions:
            eng.open(sid)
        assert eng.submit(sid, chunk)
        if last[sid] == r:
            eng.close(sid)
    eng.drain()
    return eng


@pytest.mark.parametrize("kind", ["batched", "naive"])
@pytest.mark.parametrize("dendritic", [True, False])
def test_engine_matches_reference(dendritic, kind):
    (jn, jp), (tn, tp) = _models(dendritic)
    trace = _trace(7)
    assert _hidden_rate((tn, tp), trace) >= 0.01
    jeng = _replay(jmake_engine(jn, jp, JEngineConfig(
        window=W, capacity=C, queue_limit=None), kind=kind), trace)
    teng = _replay(make_engine(tn, tp, EngineConfig(
        window=W, capacity=C, queue_limit=None), kind=kind, device="cpu"),
        trace)
    assert teng.stats()["windows_run"] == jeng.stats()["windows_run"]
    for sid in jeng.scheduler.sessions:
        ref, got = jeng.outputs(sid), teng.outputs(sid)
        assert got.shape == ref.shape and got.shape[0] >= 20
        assert teng.finished(sid)
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=plan.CROSS_ENGINE_ATOL, err_msg=sid)


def _streams(n, T, seed, n_in=N_IN, rate=0.25):
    rng = np.random.default_rng(seed)
    return {f"s{i}": (rng.random((T, n_in)) < rate).astype(np.float32)
            for i in range(n)}


def _run(kind, data, model, cache_bytes=None):
    nodes, params = model
    eng = make_engine(nodes, params, EngineConfig(
        window=W, capacity=C, cache_bytes=cache_bytes), kind=kind,
        device="cpu")
    for sid in data:
        eng.open(sid)
    for sid, x in data.items():
        assert eng.submit(sid, x)
        eng.close(sid)
    eng.drain()
    return eng


def _leaves(state):
    return [state[n][k] for n in sorted(state) for k in sorted(state[n])]


@pytest.mark.parametrize("kind", ["batched", "naive"])
def test_a_learning_session_owns_its_synapse_storage(kind):
    """Each session's learned synapse state is a tensor of its own, not a
    view of the window's stacked (S, n_pre, n_post) weight or traces: a
    retired cohort's stack is freed, and the bytes the cache counts for a
    session are the bytes it keeps alive."""
    _, model = _plastic_models()
    data = _streams(3, 20, 3, n_in=10)
    eng = _learn_run(kind, data, model, device="cpu")
    for sid in data:
        syn = _syn(eng.state_of(sid))
        assert syn
        for k, v in syn.items():
            assert v.untyped_storage().nbytes() == (
                v.numel() * v.element_size()), (sid, k)


@pytest.mark.parametrize("kind", ["batched", "naive"])
@pytest.mark.parametrize("n_extra,T,seed", [(1, 3, 0), (2, 17, 1),
                                            (3, 40, 2), (3, 9, 3)])
def test_isolation_solo_interleaved_evict_restore(n_extra, T, seed, kind):
    """Session s0: solo == interleaved with strangers == interleaved under
    a 1-byte cache (every window evicts and restores) — exact."""
    _, model = _models(True)
    data = _streams(1 + n_extra, T, seed)
    solo = _run(kind, {"s0": data["s0"]}, model)
    inter = _run(kind, data, model)
    evict = _run(kind, data, model, cache_bytes=1)
    assert evict.metrics.cache_evictions > 0
    assert evict.metrics.cache_restores > 0
    for other in (inter, evict):
        assert torch.equal(torch.from_numpy(solo.outputs("s0")),
                           torch.from_numpy(other.outputs("s0")))
        for a, b in zip(_leaves(solo.state_of("s0")),
                        _leaves(other.state_of("s0"))):
            assert torch.equal(a, b)


def _ecg_model(heterogeneous):
    """The ECG SRNN at n_hidden=16 with the JAX package's seed-0 weights
    (4 inputs: the streams below are Bernoulli(0.3), on which it fires in
    a few % of its hidden lane-steps)."""
    _, jp = jmake_srnn(jax.random.PRNGKey(0), n_hidden=16,
                       heterogeneous=heterogeneous)
    tn, _ = make_srnn_ecg(torch.Generator().manual_seed(0), n_hidden=16,
                          heterogeneous=heterogeneous, device="cpu")
    return tn, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 "cpu")


@pytest.mark.parametrize("kind", ["batched", "naive"])
@pytest.mark.parametrize("heterogeneous", [True, False])
def test_ecg_engine_equals_one_shot_plan_run(heterogeneous, kind):
    """Ragged sessions served over many windows (W=8) equal one plan.run
    of all of them side by side, bit for bit."""
    model = _ecg_model(heterogeneous)
    lengths = (29, 8, 40, 17, 33)
    data = {f"s{i}": (np.random.default_rng(20 + i).random((n, 4)) < 0.3)
            .astype(np.float32) for i, n in enumerate(lengths)}
    eng = _run(kind, data, model)
    x = np.zeros((max(lengths), len(data), 4), np.float32)
    for b, v in enumerate(data.values()):
        x[:len(v), b] = v
    _, out, rec = plan.run(*model, torch.from_numpy(x), record=("hidden",),
                           device="cpu")
    assert float(rec["hidden"].mean()) >= 0.01
    for b, (sid, v) in enumerate(data.items()):
        assert eng.finished(sid)
        np.testing.assert_array_equal(eng.outputs(sid),
                                      out[:len(v), b].numpy(), err_msg=sid)


@pytest.mark.parametrize("kind", ["batched", "naive"])
@pytest.mark.parametrize("heterogeneous", [True, False])
def test_ecg_isolation_solo_interleaved_evict_restore(heterogeneous, kind):
    """The isolation property on the recurrent model: exact."""
    model = _ecg_model(heterogeneous)
    data = _streams(4, 37, 5, n_in=4, rate=0.3)
    solo = _run(kind, {"s0": data["s0"]}, model)
    inter = _run(kind, data, model)
    evict = _run(kind, data, model, cache_bytes=1)
    assert evict.metrics.cache_evictions > 0
    for other in (inter, evict):
        assert torch.equal(torch.from_numpy(solo.outputs("s0")),
                           torch.from_numpy(other.outputs("s0")))
        for a, b in zip(_leaves(solo.state_of("s0")),
                        _leaves(other.state_of("s0"))):
            assert torch.equal(a, b)


def test_ecg_packed_state_carries_adaptation_and_recurrent_out():
    """pack_states/unpack_state move the ALIF trace `a` and the recurrent
    `out` with their session, and the free slots of a cohort stay zero."""
    nodes, params = _ecg_model(True)
    states = []
    for seed in (1, 2, 3):
        x = torch.from_numpy(_streams(1, 23, seed, n_in=4, rate=0.3)["s0"])
        st, _, _ = plan.run(nodes, params, x[:, None], device="cpu")
        assert st["hidden"]["a"].abs().sum() > 0
        states.append(st)
    assert any(st["hidden"]["out"].sum() > 0 for st in states)
    assert set(states[0]["hidden"]) == {"v", "a", "out"}
    packed = plan.pack_states(states, pad_to=5)
    for k, v in packed["hidden"].items():
        assert v.shape[0] == 5 and torch.count_nonzero(v[3:]) == 0, k
    for i, st in enumerate(states):
        back = plan.unpack_state(packed, i)
        for a, b in zip(_leaves(back), _leaves(st)):
            assert torch.equal(a, b)


def test_spilled_state_lives_on_host():
    _, model = _models(True)
    eng = _run("batched", _streams(3, 11, 4), model, cache_bytes=1)
    assert eng.cache.spilled
    sid = eng.cache.spilled[0]
    host = eng.cache._entries[sid][0]
    assert all(v.device.type == "cpu" for v in _leaves(host))
    assert all(v.device == eng.device for v in _leaves(eng.state_of(sid)))


def test_backpressure_matches_reference():
    (jn, jp), (tn, tp) = _models(False)
    jeng = jmake_engine(jn, jp, JEngineConfig(window=W, capacity=C,
                                              queue_limit=3))
    teng = make_engine(tn, tp, EngineConfig(window=W, capacity=C,
                                            queue_limit=3), device="cpu")
    rng = np.random.default_rng(5)
    chunks = [(f"s{i % 3}", (rng.random((n, N_IN)) < 0.25).astype(
        np.float32)) for i, n in enumerate((5, 9, 8, 13, 3, 20, 7, 1))]
    for eng in (jeng, teng):
        for sid in ("s0", "s1", "s2"):
            eng.open(sid)
    clear()
    verdicts = []
    for i, (sid, x) in enumerate(chunks):
        pair = (jeng.submit(sid, x), teng.submit(sid, x))
        verdicts.append(pair)
        if i == 4:
            jeng.step()
            teng.step()
    assert [j for j, _ in verdicts] == [t for _, t in verdicts]
    n_rejected = sum(not t for _, t in verdicts)
    assert 0 < n_rejected < len(chunks)
    assert teng.metrics.chunks_rejected == n_rejected
    assert len(incidents(kind="serve")) == n_rejected


def _plastic_models():
    """`tests/test_serve_engine.py`'s `_plastic_model` (make_plastic_ff, 10
    -> 12 LIF with pair STDP on its input -> 3 LI, JAX seed 1) in both
    packages, the JAX weights copied into the port's."""
    jn, jp = jmake_plastic_ff(jax.random.PRNGKey(1), n_in=10, n_hidden=12,
                              n_out=3)
    tn, _ = make_plastic_ff(torch.Generator().manual_seed(1), n_in=10,
                            n_hidden=12, n_out=3, device="cpu")
    return (jn, jp), (tn, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu"))


def _learn_run(kind, data, model, make=make_engine, cache_bytes=None,
               **kw):
    """`tests/test_serve_engine.py`'s `_run` with learning on: open every
    session, submit its whole stream, close it, drain."""
    nodes, params = model
    cfg = (JEngineConfig if make is jmake_engine else EngineConfig)(
        window=W, capacity=C, cache_bytes=cache_bytes, learn=True)
    eng = make(nodes, params, cfg, kind=kind, **kw)
    for sid in data:
        eng.open(sid)
    for sid, x in data.items():
        assert eng.submit(sid, x)
        eng.close(sid)
    eng.drain()
    return eng


def _syn(state):
    """{(node, key, entry): tensor} of a session's synapse state."""
    return {(n, k, e): v for n, d in state.items() for k, syn in d.items()
            if k.startswith("syn:") for e, v in syn.items()}


@pytest.mark.parametrize("kind", ["batched", "naive"])
def test_learn_engine_matches_reference(kind):
    """`EngineConfig(learn=True)` on a plastic program: the port's engine
    against the JAX engine (its per-session `vmap` of a learning
    `plan.run`) on the same ragged streams, W, C = 8, 4. Every session's
    outputs agree within CROSS_ENGINE_ATOL (no hidden lane of these
    streams sits at a threshold tie: a flip would move the readout past
    it), and its learned `syn:` weight and traces within the tolerance
    `tests/test_torch_synapse_plan.py` holds `plan.run(learn=True)` to;
    the weights learned away from the seed, differently per session."""
    (jn, jp), (tn, tp) = _plastic_models()
    data = {f"s{i}": v for i, v in enumerate(
        _streams(6, 30, 1, n_in=10).values())}
    for i, n in enumerate((20, 13, 30, 8, 27, 17)):
        data[f"s{i}"] = data[f"s{i}"][:n]
    assert _hidden_rate_learning(tn, tp, data) >= 0.01
    jeng = _learn_run(kind, data, (jn, jp), make=jmake_engine)
    teng = _learn_run(kind, data, (tn, tp), device="cpu")
    assert teng.stats()["windows_run"] == jeng.stats()["windows_run"]
    w0 = tp["hidden"]["w_input"]
    learned = []
    for sid in data:
        assert teng.finished(sid)
        np.testing.assert_allclose(teng.outputs(sid), jeng.outputs(sid),
                                   rtol=0, atol=plan.CROSS_ENGINE_ATOL,
                                   err_msg=sid)
        got, ref = _syn(teng.state_of(sid)), _syn(jeng.state_of(sid))
        assert set(got) == set(ref) and got
        for k, v in ref.items():
            torch.testing.assert_close(got[k], torch.from_numpy(
                np.array(v)), atol=1e-5, rtol=1e-5, msg=str(k))
        w = got[("hidden", "syn:input", "w")]
        assert w.shape == w0.shape and not torch.equal(w, w0)
        learned.append(w)
    assert not torch.equal(learned[0], learned[1])


def _hidden_rate_learning(nodes, params, data):
    """Share of hidden lane-steps that fire when the sessions' streams run
    side by side through one `plan.run` from the seed weights."""
    x = np.zeros((max(len(v) for v in data.values()), len(data), 10),
                 np.float32)
    for b, v in enumerate(data.values()):
        x[:len(v), b] = v
    with torch.no_grad():
        _, _, rec = plan.run(nodes, params, torch.from_numpy(x),
                             record=("hidden",), learn=False, device="cpu")
    return float(rec["hidden"].mean())


@pytest.mark.parametrize("kind", ["batched", "naive"])
def test_learned_weights_stay_per_session(kind):
    """The twin of `tests/test_serve_engine.py`'s: with learn=True each
    session owns its synapse weights: s0's learned tensors are
    bit-identical solo and interleaved, and differ from a stranger fed
    other spikes (no batch-summed contamination); s0's outputs too."""
    _, model = _plastic_models()
    data = _streams(3, 20, 3, n_in=10)
    solo = _learn_run(kind, {"s0": data["s0"]}, model, device="cpu")
    inter = _learn_run(kind, data, model, device="cpu")
    ws, wi = _syn(solo.state_of("s0")), _syn(inter.state_of("s0"))
    assert ws, "plastic model produced no syn entries"
    for k in ws:
        assert torch.equal(ws[k], wi[k]), k
    k = ("hidden", "syn:input", "w")
    assert not torch.equal(_syn(inter.state_of("s1"))[k], wi[k])
    assert torch.equal(torch.from_numpy(solo.outputs("s0")),
                       torch.from_numpy(inter.outputs("s0")))


@pytest.mark.parametrize("kind", ["batched", "naive"])
def test_a_learning_session_owns_its_synapse_storage(kind):
    """Each session's learned synapse state is a tensor of its own, not a
    view of the window's stacked (S, n_pre, n_post) weight or traces: a
    retired cohort's stack is freed, and the bytes the cache counts for a
    session are the bytes it keeps alive."""
    _, model = _plastic_models()
    data = _streams(3, 20, 3, n_in=10)
    eng = _learn_run(kind, data, model, device="cpu")
    for sid in data:
        syn = _syn(eng.state_of(sid))
        assert syn
        for k, v in syn.items():
            assert v.untyped_storage().nbytes() == (
                v.numel() * v.element_size()), (sid, k)


@pytest.mark.parametrize("kind", ["batched", "naive"])
@pytest.mark.parametrize("n_extra,T,seed", [(1, 3, 0), (2, 17, 1),
                                            (3, 40, 2)])
def test_learn_isolation_solo_interleaved_evict_restore(n_extra, T, seed,
                                                        kind):
    """The isolation property with learning on: session s0's outputs and
    whole final state, its learned synapses included, are identical solo,
    interleaved with strangers, and under a 1-byte cache that evicts and
    restores every session every window."""
    _, model = _plastic_models()
    data = _streams(1 + n_extra, T, seed, n_in=10)
    solo = _learn_run(kind, {"s0": data["s0"]}, model, device="cpu")
    inter = _learn_run(kind, data, model, device="cpu")
    evict = _learn_run(kind, data, model, cache_bytes=1, device="cpu")
    assert evict.metrics.cache_evictions > 0
    for other in (inter, evict):
        assert torch.equal(torch.from_numpy(solo.outputs("s0")),
                           torch.from_numpy(other.outputs("s0")))
        a, b = solo.state_of("s0"), other.state_of("s0")
        assert set(a) == set(b)
        for node in a:
            assert set(a[node]) == set(b[node])
            for k, v in a[node].items():
                if isinstance(v, dict):
                    for e in v:
                        assert torch.equal(v[e], b[node][k][e]), (node, k, e)
                else:
                    assert torch.equal(v, b[node][k]), (node, k)


def test_learn_on_a_program_without_plasticity_serves_flat():
    """learn=True on a program with no plastic connection serves on the
    flat path, as the reference's engine does: the same outputs as
    learn=False."""
    _, (tn, tp) = _models(True)
    data = _streams(3, 19, 8)
    outs = []
    for learn in (False, True):
        eng = make_engine(tn, tp, EngineConfig(window=W, capacity=C,
                                               learn=learn), device="cpu")
        for sid, x in data.items():
            eng.open(sid)
            assert eng.submit(sid, x)
            eng.close(sid)
        eng.drain()
        outs.append([eng.outputs(sid) for sid in data])
    for a, b in zip(*outs):
        assert torch.equal(torch.from_numpy(a), torch.from_numpy(b))


def test_entry_points_without_device_raise_when_no_card(monkeypatch):
    """With no CUDA device, every entry point called without device="cpu"
    raises instead of quietly running on the CPU."""
    _, (tn, tp) = _models(True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_engine(tn, tp, EngineConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan.run(tn, tp, torch.zeros(4, 1, N_IN))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        events.init_state(tn, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_dhsnn_shd(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_srnn_ecg(torch.Generator().manual_seed(0))


def test_engine_rejects_params_on_another_device():
    _, (tn, tp) = _models(True)
    with pytest.raises(ValueError, match="lies on"):
        make_engine(tn, tp, EngineConfig(), device="meta")


@pytest.mark.parametrize("kind", ["batched", "naive"])
def test_engine_window_routes_like_a_traced_step(kind, monkeypatch):
    """Every spikemm of a served window reaches the router as a traced
    raster: `auto` stays dense on a nearly silent input (which `plan.run`
    itself would route sparse) and `always` still pins sparse; the
    outputs are the same either way."""
    spec = registry.get("spikemm")
    seen = []

    def router(*args, traced=False):
        seen.append(traced)
        return spec.select_channel(*args, traced=traced)

    monkeypatch.setitem(registry._REGISTRY, "spikemm", dataclasses.replace(
        spec, select_channel=router))
    model = _models(False)[1]
    data = _streams(3, 24, seed=4, rate=0.002)
    monkeypatch.delenv("REPRO_SPIKEMM_SPARSE", raising=False)
    x = torch.from_numpy(np.stack(list(data.values()), 1))
    assert spec.select_channel(x.reshape(-1, N_IN), model[1]["hidden"][
        "w_input"])[0] == "sparse"
    outs = {}
    for mode in ("auto", "always"):
        monkeypatch.setenv("REPRO_SPIKEMM_SPARSE", mode)
        seen.clear()
        eng = _run(kind, data, model)
        assert seen and all(seen)
        outs[mode] = [eng.outputs(sid) for sid in data]
    for a, b in zip(outs["auto"], outs["always"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=plan.CROSS_ENGINE_ATOL)


@pytest.mark.parametrize("kind", ["batched", "naive"])
def test_engine_takes_a_topology_input_edge(kind):
    """The engine infers n_in from a `Connection(topology=)` input edge (it
    read a dense weight key such an edge does not have) and serves the
    program as one `plan.run` computes it."""
    from repro_torch.core import topology as topo
    from repro_torch.core.neuron import LI, LIF
    from repro_torch.core.snn_layers import ff_integrate
    rng = np.random.default_rng(0)
    dense = (rng.standard_normal((N_IN, 10))
             * (rng.random((N_IN, 10)) < 0.4)).astype(np.float32)
    nodes = [events.LayerNode("h", LIF(tau=0.8, v_th=0.3), ff_integrate,
                              (events.Connection("input", topology=topo.encode(
                                  dense, kind="sparse", ie_type=1)),), 10),
             events.LayerNode("ro", LI(tau=0.9), ff_integrate, ("h",), 3)]
    params = {"h": {}, "ro": {"w_h": torch.from_numpy(
        rng.standard_normal((10, 3)).astype(np.float32))}}
    eng = make_engine(nodes, params, EngineConfig(window=4, capacity=2),
                      kind=kind, device="cpu")
    assert eng.n_in == N_IN
    x = (rng.random((9, N_IN)) < 0.4).astype(np.float32)
    sid = eng.open()
    eng.submit(sid, x)
    eng.close(sid)
    eng.drain()
    _, o, r = plan.run(nodes, params, torch.from_numpy(x[:, None]),
                       record=("h",), device="cpu")
    assert float(r["h"].mean()) > 0.01
    torch.testing.assert_close(torch.from_numpy(eng.outputs(sid)), o[:, 0],
                               rtol=0, atol=plan.CROSS_ENGINE_ATOL)
