"""The port's numerical guardrails (`repro_torch.core.guards`) held against
the JAX package's (`repro.core.guards`): the twin of
`tests/test_resilience.py`'s guard tests, its chunked-online test and the
dispatch-failure tests of it and of `tests/test_serve_engine.py`.

* Policies and REPRO_GUARD resolve as in the reference; sanitize repairs,
  warn records, raise raises naming the first violation, off does nothing
  (no op, and no read of a flag).
* `guard_learned` rolls a diverged window back, alone, per session, and
  inside `plan.run`, with the reference's learned weights.
* A chunked-online stream under guarded faults keeps its weights finite
  and equal to the reference's window after window.
* The serve engine records the reference engine's incidents on the same
  streams, for the flat and the learning cohort. The reference's window
  step is jitted, and XLA runs its unordered debug callbacks in an order
  of its own; the test pins that, per window, the jitted reference's
  incidents are the same multiset as its eager run's, whose order is the
  program's, and holds the port to the eager order exactly (the eager
  reference routes spikemm dense, REPRO_SPIKEMM_SPARSE=never, as its
  jitted step does). Raise degrades to warn in the engine, as in the
  jitted reference.
* `compile_fail` raises `FaultInjectedError` in `plan.run` and out of the
  engine's `step()`, where the reference falls back to its XLA twins.

Each test runs inside both packages' `faults.inject(...)`; the JAX
package runs its reference kernels (REPRO_KERNEL_IMPL=ref).
"""

import collections
import contextlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import faults as jfaults
from repro.core import guards as jguards
from repro.core import plan as jplan
from repro.core import plasticity as jplasticity
from repro.kernels.incidents import clear as jclear
from repro.kernels.incidents import incidents as jincidents
from repro.serve.engine import EngineConfig as JEngineConfig
from repro.serve.engine import make_engine as jmake_engine
from repro_torch.core import faults, guards, plan, plasticity
from repro_torch.core.snn_layers import make_dhsnn_shd, make_plastic_ff
from repro_torch.kernels.incidents import clear, incidents
from repro_torch.serve import EngineConfig, make_engine
from repro_torch.weights import params_from_numpy
from tests import _faults as jnets

ATOL = plan.CROSS_ENGINE_ATOL


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_IMPL", "ref")
    monkeypatch.delenv("REPRO_GUARD", raising=False)
    clear()
    jclear()
    with jfaults.inject(""), faults.inject(""):
        yield
    clear()


@contextlib.contextmanager
def _same(spec):
    with jfaults.inject(spec), faults.inject(spec):
        yield


@contextlib.contextmanager
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        yield


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _dh_net():
    jn, jp = jnets.dh_net()
    tn, _ = make_dhsnn_shd(torch.Generator().manual_seed(0), n_in=32,
                           n_hidden=24, n_out=8, device="cpu")
    return jn, jp, tn, params_from_numpy(_np_tree(jp), "cpu")


def _plastic_net():
    jn, jp = jnets.plastic_net()
    tn, _ = make_plastic_ff(torch.Generator().manual_seed(0), n_in=24,
                            n_hidden=16, n_out=4, device="cpu")
    return jn, jp, tn, params_from_numpy(_np_tree(jp), "cpu")


def _raster(T, B, n, rate, seed):
    return (np.random.default_rng(seed).random((T, B, n)) < rate).astype(
        np.float32)


def _events(evs):
    return [(e.kind, e.family, e.stage, e.error) for e in evs]


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------


def test_guard_off_by_default_and_env_resolution(monkeypatch):
    assert not guards.config(None).active
    monkeypatch.setenv("REPRO_GUARD", "warn")
    assert guards.config(None).policy == "warn"
    with pytest.raises(ValueError, match="REPRO_GUARD"):
        guards.config("shrug")
    assert guards.POLICIES == jguards.POLICIES
    assert guards.GuardConfig() == guards.GuardConfig(
        **{f: getattr(jguards.GuardConfig(), f) for f in
           ("policy", "finite", "rate_silence", "rate_saturation",
            "w_ratio_max")})


def test_guard_sanitize_repairs_nonfinite_input():
    jn, jp, tn, tp = _dh_net()
    x = _raster(12, 4, 32, 0.3, 1)
    x[0, 0, 0] = np.nan
    _, jo, _ = jplan.run(jn, jp, jnp.asarray(x), guard="sanitize")
    _, to, _ = plan.run(tn, tp, torch.from_numpy(x), guard="sanitize",
                        device="cpu")
    assert bool(torch.isfinite(to).all())
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=ATOL,
                               atol=ATOL)
    assert incidents(kind="guard") == ()


def _poisoned(jp, tp):
    bad_j = {k: dict(v) for k, v in jp.items()}
    bad_j["hidden"]["w_input"] = bad_j["hidden"]["w_input"].at[0, 0, 0].set(
        jnp.nan)
    bad_t = {k: dict(v) for k, v in tp.items()}
    bad_t["hidden"]["w_input"] = tp["hidden"]["w_input"].clone()
    bad_t["hidden"]["w_input"][0, 0, 0] = float("nan")
    return bad_j, bad_t


def test_guard_warn_records_the_references_incidents_and_raise_raises():
    jn, jp, tn, tp = _dh_net()
    x = _raster(12, 4, 32, 0.3, 1)
    bad_j, bad_t = _poisoned(jp, tp)
    with _quiet():
        jplan.run(jn, bad_j, jnp.asarray(x), guard="warn")
    with pytest.warns(RuntimeWarning, match="REPRO_GUARD"):
        plan.run(tn, bad_t, torch.from_numpy(x), guard="warn", device="cpu")
    assert incidents(kind="guard")
    assert _events(incidents(kind="guard")) == \
        _events(jincidents(kind="guard"))
    with pytest.raises(guards.GuardViolation, match="nonfinite"):
        plan.run(tn, bad_t, torch.from_numpy(x), guard="raise",
                 device="cpu")


def test_guard_raise_names_the_first_violation():
    """The flags are read once at the end of the run; raise still names
    (and records) the violation the reference's eager run stops at, here
    the input's, before the weight's."""
    jn, jp, tn, tp = _dh_net()
    x = _raster(12, 4, 32, 0.3, 1)
    x[3, 1, 2] = np.inf
    bad_j, bad_t = _poisoned(jp, tp)
    with pytest.raises(jguards.GuardViolation) as jexc:
        jplan.run(jn, bad_j, jnp.asarray(x), guard="raise")
    clear()
    with pytest.raises(guards.GuardViolation) as texc:
        plan.run(tn, bad_t, torch.from_numpy(x), guard="raise",
                 device="cpu")
    assert str(texc.value) == str(jexc.value)
    assert "input" in str(texc.value)
    assert _events(incidents(kind="guard")) == \
        _events(jincidents(kind="guard"))


def test_guard_flags_silent_population():
    jn, jp, tn, tp = _dh_net()
    x = np.zeros((12, 4, 32), np.float32)        # no input -> no spikes
    with _quiet():
        jplan.run(jn, jp, jnp.asarray(x), guard="warn")
        plan.run(tn, tp, torch.from_numpy(x), guard="warn", device="cpu")
    assert any(e.error.startswith("population silent")
               for e in incidents(kind="guard"))
    assert _events(incidents(kind="guard")) == \
        _events(jincidents(kind="guard"))


def test_guard_off_inserts_no_op_and_warn_reads_once(monkeypatch):
    """guard=off dispatches the clean run's ops exactly (no check, no
    read of a flag); warn queues its flags and reads them in one copy."""
    from torch.utils._python_dispatch import TorchDispatchMode

    _, _, tn, tp = _dh_net()
    x = torch.from_numpy(_raster(12, 4, 32, 0.3, 1))

    def ops(**kw):
        seen = []

        class Record(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                seen.append(str(func))
                return func(*args, **(kwargs or {}))

        with Record():
            plan.run(tn, tp, x, device="cpu", **kw)
        return seen

    flushes = []
    real = guards._Pending.flush

    def counting(self):
        flushes.append(len(self.flags))
        return real(self)

    monkeypatch.setattr(guards._Pending, "flush", counting)
    clean = ops()
    assert ops(guard="off") == clean
    assert flushes == [0, 0]                  # nothing queued, nothing read
    warned = ops(guard="warn")
    assert len(warned) > len(clean)
    # input, 2 segments x (out, spikes x 2 for the hidden layer, states)
    assert flushes == [0, 0, 1 + (1 + 2 + 2) + (1 + 1)]
    assert incidents(kind="guard") == ()


# ---------------------------------------------------------------------------
# learned-weight divergence
# ---------------------------------------------------------------------------


def test_guard_learned_rolls_back_diverged_window():
    w0 = torch.ones(8, 8)
    cfg = guards.GuardConfig(policy="sanitize")
    w1 = w0.clone()
    w1[0, 0] = float("nan")
    assert torch.equal(guards.guard_learned("t", w0, w1, cfg), w0)
    assert torch.equal(guards.guard_learned("t", w0, 1e6 * w0, cfg), w0)
    assert torch.equal(guards.guard_learned("t", w0, 1.5 * w0, cfg),
                       1.5 * w0)


def test_guard_learned_acts_per_session():
    """A session axis: one session's explosion rolls that session back
    alone, and warn flags it alone, as the reference's vmap does."""
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((4, 6, 5)).astype(np.float32)
    w1 = w0 * 1.25
    w1[2] *= 1e4
    w1[1, 0, 0] = np.nan
    w0[3, 1, 1] = np.nan
    cfg = guards.GuardConfig(policy="sanitize")
    jcfg = jguards.GuardConfig(policy="sanitize")
    ref = jax.vmap(lambda a, b: jguards.guard_learned("t", a, b, jcfg))(
        jnp.asarray(w0), jnp.asarray(w1))
    got = guards.guard_learned("t", torch.from_numpy(w0),
                               torch.from_numpy(w1), cfg, axis=0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    safe0 = np.nan_to_num(w0, nan=0.0)
    np.testing.assert_array_equal(got[2].numpy(), safe0[2])
    np.testing.assert_array_equal(got[0].numpy(), w1[0])
    warn = guards.GuardConfig(policy="warn")
    with _quiet():
        jax.vmap(lambda a, b: jguards.guard_learned(
            "t", a, b, jguards.GuardConfig(policy="warn")))(
                jnp.asarray(w0), jnp.asarray(w1))
        guards.guard_learned("t", torch.from_numpy(w0),
                             torch.from_numpy(w1), warn, axis=0)
    assert [e.error for e in incidents(kind="guard")] == \
        ["nonfinite learned weights",
         "learned-weight norm explosion (> 16.0x entry)"]
    assert _events(incidents(kind="guard")) == \
        _events(jincidents(kind="guard"))


@pytest.mark.parametrize("policy", ["sanitize", "warn"])
def test_guard_learned_in_plan_run(policy):
    """A plasticity rule driven into NaN territory publishes the entry
    weights under sanitize instead of a poisoned window, as the
    reference's does."""
    jn, jp, tn, tp = _plastic_net()
    jp = {k: dict(v) for k, v in jp.items()}
    jp["hidden"]["w_input"] = jp["hidden"]["w_input"].at[0, 0].set(jnp.nan)
    tp = {k: dict(v) for k, v in tp.items()}
    tp["hidden"]["w_input"] = tp["hidden"]["w_input"].clone()
    tp["hidden"]["w_input"][0, 0] = float("nan")
    x = _raster(12, 4, 24, 0.3, 2)
    with _quiet():
        js, _, _ = jplan.run(jn, jp, jnp.asarray(x),
                             guard=jguards.GuardConfig(policy=policy))
        ts, _, _ = plan.run(tn, tp, torch.from_numpy(x),
                            guard=guards.GuardConfig(policy=policy),
                            device="cpu")
    w1 = ts["hidden"]["syn:input"]["w"]
    if policy == "sanitize":
        assert bool(torch.isfinite(w1).all())
    np.testing.assert_allclose(w1.numpy(),
                               np.asarray(js["hidden"]["syn:input"]["w"]),
                               rtol=ATOL, atol=ATOL)
    assert _events(incidents(kind="guard")) == \
        _events(jincidents(kind="guard"))


def test_chunked_online_survives_guarded_faults():
    """A plastic stream under packet loss + dead rows + guards keeps
    producing finite weights every window, the reference's."""
    jn, jp, tn, tp = _plastic_net()
    with _same("drop_blocks:p=0.2,seed=1;dead_rows:frac=0.1,seed=2"):
        for w in range(3):
            x = _raster(12, 4, 24, 0.3, 10 + w)
            jst, _, _ = jplan.run(jn, jp, jnp.asarray(x), guard="sanitize")
            jp = jplasticity.apply_learned(jn, jp, jst)
            tst, _, _ = plan.run(tn, tp, torch.from_numpy(x),
                                 guard="sanitize", device="cpu")
            tp = plasticity.apply_learned(tn, tp, tst)
            assert bool(torch.isfinite(tp["hidden"]["w_input"]).all())
            np.testing.assert_allclose(tp["hidden"]["w_input"].numpy(),
                                       np.asarray(jp["hidden"]["w_input"]),
                                       rtol=ATOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the serve engine
# ---------------------------------------------------------------------------


def _streams(n=3, W=8, silent=1):
    rng = np.random.default_rng(0)
    return {f"s{i}": (rng.random((2 * W + 3 * i, 24))
                      < (0.0 if i == silent else 0.3)).astype(np.float32)
            for i in range(n)}


def _serve(eng, data, eager=False):
    """Drive `eng` window by window: [the window's guard incidents]."""
    for sid, x in data.items():
        eng.open(sid)
        eng.submit(sid, x)
        eng.close(sid)
    inc = jincidents if isinstance(eng.cfg, JEngineConfig) else incidents
    wins = []
    while True:
        jclear()
        clear()
        with jax.disable_jit() if eager else contextlib.nullcontext():
            if not eng.step():
                return wins
        wins.append(_events(inc(kind="guard")))


@pytest.mark.parametrize("learn", [False, True])
@pytest.mark.parametrize("spec", [
    "", "nan_weights:frac=0.2,seed=3",
    "drop_blocks:p=0.3,seed=3;dead_rows:frac=0.3,seed=5;"
    "bitflip:frac=0.05,seed=7"])
def test_engine_incidents_equal_reference(learn, spec, monkeypatch):
    monkeypatch.setenv("REPRO_SPIKEMM_SPARSE", "never")
    jn, jp, tn, tp = _plastic_net()
    data = _streams()
    kw = dict(window=8, capacity=4, learn=learn, guard="warn")
    with _same(spec), _quiet():
        jitted = _serve(jmake_engine(jn, jp, JEngineConfig(**kw)), data)
        eager_eng = jmake_engine(jn, jp, JEngineConfig(**kw))
        eager = _serve(eager_eng, data, eager=True)
        eng = make_engine(tn, tp, EngineConfig(**kw), device="cpu")
        got = _serve(eng, data)
    assert [collections.Counter(w) for w in jitted] == \
        [collections.Counter(w) for w in eager]
    assert got == eager
    if learn or spec.startswith("nan"):
        assert any(got)
    for sid in data:
        np.testing.assert_allclose(eng.outputs(sid),
                                   eager_eng.outputs(sid), rtol=ATOL,
                                   atol=ATOL)


def test_engine_raise_degrades_to_warn():
    """The window step records and warns where plan.run would raise, as
    the reference's jitted step does."""
    jn, jp, tn, tp = _plastic_net()
    data = _streams()
    kw = dict(window=8, capacity=4, learn=True, guard="raise")
    with _same("nan_weights:frac=0.2,seed=3"), _quiet():
        jitted = _serve(jmake_engine(jn, jp, JEngineConfig(**kw)), data)
        got = _serve(make_engine(tn, tp, EngineConfig(**kw), device="cpu"),
                     data)
    assert [collections.Counter(w) for w in got] == \
        [collections.Counter(w) for w in jitted]
    assert {e[2] for w in got for e in w} == {"warn"}
    with _same("nan_weights:frac=0.2,seed=3"):
        with pytest.raises(guards.GuardViolation):
            plan.run(tn, tp, torch.from_numpy(_raster(8, 1, 24, 0.3, 1)),
                     guard="raise", device="cpu")


def test_engine_guard_sanitize_keeps_sessions_finite():
    """A learning window under NaN weights and sanitize: every session's
    outputs and learned weights are finite and equal the reference's."""
    jn, jp, tn, tp = _plastic_net()
    data = _streams(silent=-1)
    kw = dict(window=8, capacity=4, learn=True, guard="sanitize")
    with _same("nan_weights:frac=0.2,seed=3"):
        jeng = jmake_engine(jn, jp, JEngineConfig(**kw))
        _serve(jeng, data)
        eng = make_engine(tn, tp, EngineConfig(**kw), device="cpu")
        _serve(eng, data)
    for sid in data:
        w = eng.state_of(sid)["hidden"]["syn:input"]["w"]
        assert bool(torch.isfinite(w).all())
        assert np.all(np.isfinite(eng.outputs(sid)))
        np.testing.assert_allclose(
            w.numpy(), np.asarray(jeng.state_of(sid)["hidden"]["syn:input"]
                                  ["w"]), rtol=ATOL, atol=ATOL)
        np.testing.assert_allclose(eng.outputs(sid), jeng.outputs(sid),
                                   rtol=ATOL, atol=ATOL)
    assert incidents(kind="guard") == ()


# ---------------------------------------------------------------------------
# dispatch failures raise (the reference falls back)
# ---------------------------------------------------------------------------


def test_plan_run_raises_under_total_kernel_failure():
    _, _, tn, tp = _dh_net()
    x = torch.from_numpy(_raster(12, 4, 32, 0.3, 1))
    with faults.inject("compile_fail:kernels=*"):
        with pytest.raises(faults.FaultInjectedError):
            plan.run(tn, tp, x, device="cpu")
    with faults.inject("compile_fail:kernels=attention"):
        plan.run(tn, tp, x, device="cpu")       # untargeted: runs


@pytest.mark.parametrize("learn", [False, True])
def test_engine_step_raises_under_compile_fail(learn):
    """The engine serves through no fallback chain: a window whose kernels
    fail raises out of step(), and the sessions' state is left as it was
    before the window."""
    _, _, tn, tp = _plastic_net()
    data = _streams(silent=-1)
    eng = make_engine(tn, tp, EngineConfig(window=8, capacity=4,
                                           learn=learn), device="cpu")
    for sid, x in data.items():
        eng.open(sid)
        eng.submit(sid, x)
    before = {sid: eng.state_of(sid)["hidden"]["v"].clone() for sid in data}
    with faults.inject("compile_fail:kernels=lif"):
        with pytest.raises(faults.FaultInjectedError, match="lif"):
            eng.step()
    for sid in data:
        assert torch.equal(eng.state_of(sid)["hidden"]["v"], before[sid])
    assert eng.metrics.windows_run == 0
