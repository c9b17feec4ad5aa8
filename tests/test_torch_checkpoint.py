"""The port's checkpoints (`repro_torch.train.checkpoint`) held against the
JAX package's (`repro.train.checkpoint`): the twin of
`tests/test_fault_tolerance.py`'s checkpoint and stream tests.

* Round trip, integrity (a corrupt latest step falls back one step),
  keep-last-k and the async writer, as in the reference.
* A chunked-online stream of the plastic net interrupted after 3 of 6
  windows, restored from the `StreamCheckpointer` into fresh templates and
  finished, ends with the uninterrupted run's weights, neuron states and
  synapse traces bit for bit (the input stream's torch.Generator state
  rides in the snapshot as its `rng`).
* The format is the reference's: a checkpoint the JAX `StreamCheckpointer`
  writes restores in the port bit for bit, and the reverse, and a
  bfloat16 leaf crosses both ways as its raw 16 bits.

The LM-training, reshard and token-stream tests of that file belong to
the LM shelf (ROADMAP.md, item 11) and have no twin here.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import events as jevents
from repro.core import faults as jfaults
from repro.core import plan as jplan
from repro.core import plasticity as jplasticity
from repro.train import checkpoint as jcheckpoint
from repro_torch.core import events, faults, plan, plasticity
from repro_torch.core.snn_layers import make_plastic_ff
from repro_torch.train.checkpoint import (CheckpointManager,
                                          StreamCheckpointer, latest_step,
                                          restore_checkpoint, save_checkpoint)
from tests import _faults as jnets


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_IMPL", "ref")
    with jfaults.inject(""), faults.inject(""):
        yield


def _leaves(tree, prefix=""):
    """{path: leaf} of a nested dict/list tree (None: no leaf)."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _leaves(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree)
                for k, v in _leaves(t, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _raw(x):
    """A leaf's bytes as a numpy array (bit patterns, bfloat16 included)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        x = x.numpy()
    x = np.asarray(x)
    return x.reshape(-1).view(np.uint8), x.shape


def _assert_bit_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        (ra, sa), (rb, sb) = _raw(la[k]), _raw(lb[k])
        assert sa == sb, k
        np.testing.assert_array_equal(ra, rb, err_msg=k)


def _tree():
    return {"w": torch.arange(12.0).reshape(3, 4),
            "nested": {"b": torch.ones(5, dtype=torch.bfloat16) * 1.5,
                       "step": torch.tensor(7, dtype=torch.int32)},
            "l": [torch.zeros(2), None]}


def _zeros_like(tree):
    return {k: (_zeros_like(v) if isinstance(v, dict) else
                [None if t is None else torch.zeros_like(t) for t in v]
                if isinstance(v, list) else torch.zeros_like(v))
            for k, v in tree.items()}


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 3, tree)
    assert latest_step(str(tmp_path)) == 3
    out = restore_checkpoint(str(tmp_path), 3, _zeros_like(tree))
    _assert_bit_equal(tree, out)
    assert out["nested"]["b"].dtype == torch.bfloat16
    with open(tmp_path / "step_0000000003" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["shards"][0]["dtypes"]["nested/b"] == "bfloat16"


def test_corrupt_checkpoint_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    tree = {"w": torch.ones(4)}
    mgr.save_sync(1, tree)
    mgr.save_sync(2, {"w": 2 * torch.ones(4)})
    p = tmp_path / "step_0000000002" / "shard_00000.npz"
    with open(p, "r+b") as f:
        f.seek(10)
        f.write(b"\x00\x00garbage\x00")
    step, out = mgr.restore_latest({"w": torch.zeros(4)})
    assert step == 1                      # fell back past the corrupt one
    _assert_bit_equal(out, tree)
    with pytest.raises(IOError, match="checksum"):
        restore_checkpoint(str(tmp_path), 2, {"w": torch.zeros(4)})


def test_restore_refuses_a_shape_mismatch(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.ones(4)})
    with pytest.raises(ValueError, match="w"):
        restore_checkpoint(str(tmp_path), 1, {"w": torch.zeros(5)})


def test_keep_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_sync(s, {"w": torch.full((3,), float(s))})
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
    assert steps == [3, 4]


def test_async_save_equivalent(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3)
    w = torch.arange(5.0)
    mgr.save_async(7, {"w": w})
    w += 100.0                 # the host copy was taken at the call
    mgr.wait()
    assert latest_step(str(tmp_path)) == 7
    out = restore_checkpoint(str(tmp_path), 7, {"w": torch.zeros(5)})
    assert torch.equal(out["w"], torch.arange(5.0))


# ---------------------------------------------------------------------------
# chunked-online stream snapshots
# ---------------------------------------------------------------------------


def _plastic():
    return make_plastic_ff(torch.Generator().manual_seed(0), n_in=24,
                           n_hidden=16, n_out=4, device="cpu")


def _stream_windows(nodes, params, state, gen, start, stop, ckpt=None):
    """Run chunked-online windows [start, stop), each input drawn from
    `gen`; optionally snapshot each (the generator's state as `rng`)."""
    for w in range(start, stop):
        x = (torch.rand(12, 4, 24, generator=gen) < 0.3).float()
        state, _, _ = plan.run(nodes, params, x, state=state, device="cpu")
        params = plasticity.apply_learned(nodes, params, state)
        if ckpt is not None:
            ckpt.save(w, state, params=params, rng=gen.get_state())
    return params, state


def test_stream_checkpoint_resume_bit_identical(tmp_path):
    nodes, params0 = _plastic()
    state0 = events.init_state(nodes, 4, torch.float32, params0,
                               device="cpu")
    p_ref, s_ref = _stream_windows(nodes, dict(params0), state0,
                                   torch.Generator().manual_seed(7), 0, 6)
    ck = StreamCheckpointer(str(tmp_path), keep=2)
    _stream_windows(nodes, dict(params0), state0,
                    torch.Generator().manual_seed(7), 0, 3, ckpt=ck)

    # "restart": fresh templates, restore, resume from window + 1
    nodes2, params2 = make_plastic_ff(torch.Generator().manual_seed(1),
                                      n_in=24, n_hidden=16, n_out=4,
                                      device="cpu")
    state2 = events.init_state(nodes2, 4, torch.float32, params2,
                               device="cpu")
    gen = torch.Generator()
    window, state2, params2, rng = StreamCheckpointer(
        str(tmp_path), keep=2).restore_latest(state2, params=params2,
                                              rng=gen.get_state())
    assert window == 2                       # windows 0..2 completed
    gen.set_state(rng)
    p_res, s_res = _stream_windows(nodes2, params2, state2, gen,
                                   window + 1, 6)
    _assert_bit_equal(p_ref, p_res)
    _assert_bit_equal(s_ref, s_res)


def test_stream_checkpoint_cold_start_passthrough(tmp_path):
    nodes, params = _plastic()
    state = events.init_state(nodes, 4, torch.float32, params, device="cpu")
    ck = StreamCheckpointer(str(tmp_path / "empty"))
    window, s, p, r = ck.restore_latest(state, params=params, rng=None)
    assert window is None
    assert s is state and p is params and r is None


def test_stream_checkpoint_keeps_last_k(tmp_path):
    nodes, params = _plastic()
    state = events.init_state(nodes, 4, torch.float32, params, device="cpu")
    ck = StreamCheckpointer(str(tmp_path), keep=2)
    for w in range(4):
        ck.save(w, state, params=params, sync=w % 2 == 0)
    ck.wait()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
    assert steps == [2, 3]


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------


def _jax_stream(tmp_path, windows=3):
    """The JAX test's stream (`test_fault_tolerance.py::_stream_windows`):
    the plastic net, windows [0, windows) snapshotted by the JAX
    StreamCheckpointer. Returns (JAX nodes, params, state, rng key)."""
    key = jax.random.PRNGKey(7)
    nodes, params = jnets.plastic_net()
    state = jevents.init_state(nodes, 4, jnp.float32, params)
    ck = jcheckpoint.StreamCheckpointer(str(tmp_path), keep=2)
    for w in range(windows):
        x = jnets.spikes(jax.random.fold_in(key, w), n=24)
        state, _, _ = jplan.run(nodes, params, x, state=state)
        params = jplasticity.apply_learned(nodes, params, state)
        ck.save(w, state, params=params, rng=jax.random.key_data(key))
    return nodes, params, state, key


def _port_templates():
    nodes, params = _plastic()
    state = events.init_state(nodes, 4, torch.float32, params, device="cpu")
    return nodes, params, state


def test_jax_stream_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    jn, jp, js, key = _jax_stream(tmp_path)
    tn, tp, ts = _port_templates()
    window, st, pt, rng = StreamCheckpointer(str(tmp_path)).restore_latest(
        ts, params=tp, rng=np.zeros(2, np.uint32))
    assert window == 2
    np.testing.assert_array_equal(rng, np.asarray(jax.random.key_data(key)))
    _assert_bit_equal(st, jax.tree_util.tree_map(np.asarray, js))
    _assert_bit_equal(pt, jax.tree_util.tree_map(np.asarray, jp))
    # and the port resumes the JAX stream as the JAX package does: one more
    # window on the same input gives the reference's next state
    x = np.array(jnets.spikes(jax.random.fold_in(key, 3), n=24))
    js4, jo, _ = jplan.run(jn, jp, jnp.asarray(x), state=js)
    ts4, to, _ = plan.run(tn, pt, torch.from_numpy(x), state=st,
                          device="cpu")
    np.testing.assert_allclose(to.numpy(), np.asarray(jo),
                               rtol=plan.CROSS_ENGINE_ATOL,
                               atol=plan.CROSS_ENGINE_ATOL)


def test_port_stream_checkpoint_restores_in_jax_bit_for_bit(tmp_path):
    nodes, params0, state0 = _port_templates()
    ck = StreamCheckpointer(str(tmp_path))
    params, state = _stream_windows(nodes, dict(params0), state0,
                                    torch.Generator().manual_seed(3), 0, 3,
                                    ckpt=ck)
    jn, jp = jnets.plastic_net()
    js = jevents.init_state(jn, 4, jnp.float32, jp)
    window, st, pt, rng = jcheckpoint.StreamCheckpointer(
        str(tmp_path)).restore_latest(
            js, params=jp,
            rng=jnp.zeros(tuple(torch.Generator().get_state().shape),
                          jnp.uint8))
    assert window == 2
    _assert_bit_equal(state, jax.tree_util.tree_map(np.asarray, st))
    _assert_bit_equal(params, jax.tree_util.tree_map(np.asarray, pt))
    gen = torch.Generator().manual_seed(3)
    for _ in range(3):
        torch.rand(12, 4, 24, generator=gen)
    np.testing.assert_array_equal(np.asarray(rng), gen.get_state().numpy())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bfloat16_leaf_crosses_both_ways(tmp_path, writer):
    vals = np.array([1.5, -0.0, 3.140625, -65280.0, 1e-3], np.float32)
    jtree = {"b": jnp.asarray(vals, jnp.bfloat16), "f": jnp.asarray(vals)}
    ttree = {"b": torch.from_numpy(vals).to(torch.bfloat16),
             "f": torch.from_numpy(vals)}
    if writer == "jax":
        jcheckpoint.save_checkpoint(str(tmp_path), 1, jtree)
    else:
        save_checkpoint(str(tmp_path), 1, ttree)
    got_t = restore_checkpoint(str(tmp_path), 1, _zeros_like(ttree))
    got_j = jcheckpoint.restore_checkpoint(
        str(tmp_path), 1, jax.tree_util.tree_map(jnp.zeros_like, jtree))
    assert got_t["b"].dtype == torch.bfloat16
    assert got_j["b"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        got_t["b"].view(torch.int16).numpy(),
        np.asarray(got_j["b"]).view(np.int16))
    np.testing.assert_array_equal(
        got_t["b"].view(torch.int16).numpy(),
        ttree["b"].view(torch.int16).numpy())
    _assert_bit_equal(got_t["f"], ttree["f"])
