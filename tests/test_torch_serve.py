"""The port's streaming serve engine, on the CPU.

* The JAX `BatchedEngine` and the port's (`device="cpu"`) replay the same
  small ragged arrival trace with the same weights; per-session outputs
  agree within `CROSS_ENGINE_ATOL`, on a trace where the hidden layer
  fires in at least 1 % of its lane-steps.
* Isolation: a session's outputs and final state are bit-identical
  (`torch.equal`) solo, interleaved with strangers, and under a 1-byte
  cache that evicts and restores it every window — for both engines.
  Fixed cases, no time deadline.
* `queue_limit` backpressure accepts and rejects the same chunks as the
  JAX engine and records each rejection on the incident log.
* `learn=True` and entry points called without a device on a machine with
  no card raise.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core.snn_layers import make_dhsnn_shd as jmake_dhsnn
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import make_engine as jmake_engine
from repro_torch.core import events, plan
from repro_torch.core.snn_layers import make_dhsnn_shd
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


def _streams(n, T, seed):
    rng = np.random.default_rng(seed)
    return {f"s{i}": (rng.random((T, N_IN)) < 0.25).astype(np.float32)
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


def test_learn_raises():
    _, (tn, tp) = _models(True)
    with pytest.raises(NotImplementedError, match="plasticity"):
        make_engine(tn, tp, EngineConfig(learn=True), device="cpu")


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


def test_engine_rejects_params_on_another_device():
    _, (tn, tp) = _models(True)
    with pytest.raises(ValueError, match="lies on"):
        make_engine(tn, tp, EngineConfig(), device="meta")
