"""The port's `StreamClient` (`repro_torch.serve.client`), on the CPU: twins
of the six tests of `tests/test_serve_client.py` on the port's engine
(`device="cpu"`), with the same model sizes, data and chunking. The client
owns no execution semantics, so the property re-asserted through it is the
engine's: a session's output stream is bit-identical whether its generator
runs alone or interleaved with strangers on a shared engine; and the
client's solo stream equals the JAX client's within `CROSS_ENGINE_ATOL`,
on the JAX test model's weights."""

import functools

import jax
import numpy as np
import torch

from repro.core.snn_layers import make_dhsnn_shd as jmake_dhsnn
from repro.serve import EngineConfig as JEngineConfig
from repro.serve import StreamClient as JStreamClient
from repro.serve import make_engine as jmake_engine
from repro_torch.core import plan
from repro_torch.core.snn_layers import make_dhsnn_shd
from repro_torch.serve import EngineConfig, StreamClient, make_engine
from repro_torch.weights import params_from_numpy

W, C = 8, 4


@functools.lru_cache(maxsize=None)
def _jax_model():
    return jmake_dhsnn(jax.random.PRNGKey(0), n_in=12, n_hidden=16, n_out=5,
                       dendritic=False)


def _model():
    """The JAX test's model (seed 0, 12 -> 16 LIF -> 5 LI), its weights
    copied into the port's nodes."""
    _, jp = _jax_model()
    tn, _ = make_dhsnn_shd(torch.Generator().manual_seed(0), n_in=12,
                           n_hidden=16, n_out=5, dendritic=False,
                           device="cpu")
    return tn, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 "cpu")


def _engine(**kw):
    nodes, params = _model()
    return make_engine(nodes, params,
                       EngineConfig(window=W, capacity=C, **kw),
                       device="cpu")


def _stream_data(seed, T=50):
    rng = np.random.default_rng(seed)
    return (rng.random((T, 12)) < 0.25).astype(np.float32)


def _chunked(x, size):
    return [x[i:i + size] for i in range(0, len(x), size)]


def _solo_reference(x):
    eng = _engine()
    sid = eng.open()
    assert eng.submit(sid, x)
    eng.close(sid)
    eng.drain()
    return eng.outputs(sid)


def test_client_run_matches_hand_driven_engine():
    x = _stream_data(0)
    out = StreamClient(_engine()).run(_chunked(x, 7))
    np.testing.assert_array_equal(_solo_reference(x), out)
    jn, jp = _jax_model()
    ref = JStreamClient(jmake_engine(jn, jp, JEngineConfig(
        window=W, capacity=C))).run(_chunked(x, 7))
    np.testing.assert_allclose(out, ref, rtol=0, atol=plan.CROSS_ENGINE_ATOL)


def test_client_stream_yields_incrementally_and_in_order():
    x = _stream_data(1, T=64)
    windows = list(StreamClient(_engine()).stream(None, _chunked(x, 9)))
    assert len(windows) > 1                       # actually streaming
    assert sum(w.shape[0] for w in windows) == 64
    np.testing.assert_array_equal(_solo_reference(x),
                                  np.concatenate(windows, axis=0))


def test_client_adopted_session_not_retired():
    x = _stream_data(2)
    eng = _engine()
    client = StreamClient(eng)
    eng.open("mine")
    out = np.concatenate(list(client.stream("mine", _chunked(x, 13))),
                         axis=0)
    np.testing.assert_array_equal(_solo_reference(x), out)
    assert "mine" in eng.scheduler.sessions      # caller still owns it
    np.testing.assert_array_equal(eng.retire("mine"), out)


def test_interleaved_client_streams_equal_solo():
    """Two generators round-robin on ONE engine: continuous batching puts
    both sessions in shared cohorts, yet each output stream must equal
    its solo run exactly."""
    xa, xb = _stream_data(3, T=60), _stream_data(4, T=60)
    eng = _engine()
    client = StreamClient(eng)
    ga = client.stream(None, _chunked(xa, 7))
    gb = client.stream(None, _chunked(xb, 11))
    outs = {"a": [], "b": []}
    live = {"a": ga, "b": gb}
    while live:
        for k, g in list(live.items()):
            try:
                outs[k].append(next(g))
            except StopIteration:
                del live[k]
    np.testing.assert_array_equal(_solo_reference(xa),
                                  np.concatenate(outs["a"], axis=0))
    np.testing.assert_array_equal(_solo_reference(xb),
                                  np.concatenate(outs["b"], axis=0))


def test_client_backpressure_does_not_drop_steps():
    """A tiny admission queue forces submit() rejections; the client must
    absorb them by stepping the engine, never by losing input."""
    x = _stream_data(5, T=96)
    eng = _engine(queue_limit=W)     # one window of buffer, max pushback
    out = StreamClient(eng).run(_chunked(x, 5))
    np.testing.assert_array_equal(_solo_reference(x), out)


def test_client_stats_passthrough():
    client = StreamClient(_engine())
    client.run(_chunked(_stream_data(6, T=16), 8))
    stats = client.stats()
    assert stats["windows_run"] >= 1 and stats["engine"] == "batched"
