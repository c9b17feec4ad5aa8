"""The port's plasticity module held against the JAX package, on the CPU.

Mirrors `tests/test_plasticity.py` (the STDP causality properties, the
SynapseProgram IR's factories against hand references, validation and the
registry) with every number compared to the JAX package's on the same
numpy inputs: spike trains drawn with numpy, weights carried as numpy
arrays. The tolerance is the reference tests' own (1e-5 absolute and
relative where they state one, else 1e-6): both packages run the same
per-step interpreter, each with its own einsum.

Left out: the accumulated-spike readout (`accumulated_spike_fc`, its
custom backward and `fuse_bn1d_fc`), which comes with the BCI slice, and
`jax.jit` of `synapse_step` (the port has no tracing; its counterpart here
checks the step against the reference's). The reference's
`test_reward_stdp_gated_by_modulator` claims linearity where a unit-reward
run hits the -1 clip; the port is held to the reference's `synapse_run`
trajectories there, clip included, not to that claim.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import plasticity as jpl
from repro.core.neuron import Decay as JDecay
from repro_torch.core import plasticity as tpl
from repro_torch.core.neuron import Decay
from repro_torch.core.plasticity import (STDPConfig, accumulated_spike,
                                         make_synapse, pair_stdp,
                                         register_synapse, reward_stdp,
                                         stdp_init, stdp_run, stdp_step,
                                         synapse_init, synapse_run,
                                         synapse_step, triplet_stdp,
                                         validate_synapse_program)

RULES = ("pair_stdp", "triplet_stdp", "reward_stdp", "accumulated_spike")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, ref, atol=1e-5, rtol=1e-5, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=atol,
                               rtol=rtol, err_msg=msg)


def _pair_run(dt_pre: int, dt_post: int, T: int = 20):
    """One pre spike at dt_pre, one post spike at dt_post; the port's
    learned weight, held to the reference's."""
    pre = np.zeros((T, 1, 1), np.float32)
    post = np.zeros((T, 1, 1), np.float32)
    pre[dt_pre, 0, 0] = 1.0
    post[dt_post, 0, 0] = 1.0
    got = stdp_run(STDPConfig(), torch.zeros(1, 1), _t(pre), _t(post))
    ref = jpl.stdp_run(jpl.STDPConfig(), jnp.zeros((1, 1)), jnp.asarray(pre),
                       jnp.asarray(post))
    _close(got, ref, atol=1e-6, rtol=0)
    return float(got[0, 0])


def test_stdp_causal_potentiates():
    assert _pair_run(3, 6) > 0          # pre before post: LTP


def test_stdp_acausal_depresses():
    assert _pair_run(6, 3) < 0          # post before pre: LTD


def test_stdp_window_decays():
    """|dw| shrinks as |dt| grows (exponential STDP window)."""
    close = abs(_pair_run(5, 7))
    far = abs(_pair_run(5, 15))
    assert close > far > 0


@given(st.integers(0, 9), st.integers(0, 9))
@settings(max_examples=20, deadline=None)
def test_stdp_sign_matches_timing(t_pre, t_post):
    if t_pre == t_post:
        return
    dw = _pair_run(t_pre, t_post, T=12)
    if t_pre < t_post:
        assert dw > 0
    else:
        assert dw < 0


@pytest.mark.parametrize("use_kernel", [False, True])
def test_stdp_bounds_respected(use_kernel):
    """Huge amplitudes drive every weight into the clip, on both paths of
    `stdp_step`, and the trajectory equals the reference's."""
    cfg = STDPConfig(w_min=-0.5, w_max=0.5, a_plus=10.0, a_minus=10.0)
    rng = np.random.default_rng(0)
    pre = (rng.random((50, 2, 8)) < 0.5).astype(np.float32)
    post = (rng.random((50, 2, 4)) < 0.5).astype(np.float32)
    w = stdp_run(cfg, torch.zeros(8, 4), _t(pre), _t(post),
                 use_kernel=use_kernel)
    assert float(w.max()) <= 0.5 and float(w.min()) >= -0.5
    ref = jpl.stdp_run(jpl.STDPConfig(w_min=-0.5, w_max=0.5, a_plus=10.0,
                                      a_minus=10.0), jnp.zeros((8, 4)),
                       jnp.asarray(pre), jnp.asarray(post))
    _close(w, ref)


def _trains(seed, T=12, B=3, M=8, N=5, rate=0.4):
    rng = np.random.default_rng(seed)
    pre = (rng.random((T, B, M)) < rate).astype(np.float32)
    post = (rng.random((T, B, N)) < rate).astype(np.float32)
    w = (0.3 * rng.standard_normal((M, N))).astype(np.float32)
    return pre, post, w


def test_stdp_run_use_kernel_matches_reference():
    """`use_kernel` reaches every step (the `stdp` family: its plain
    version here), agrees with the einsum path and with the reference."""
    pre, post, w = _trains(0, T=6, B=2, M=8, N=6)
    cfg = STDPConfig()
    w_ref = stdp_run(cfg, _t(w), _t(pre), _t(post), use_kernel=False)
    w_ker = stdp_run(cfg, _t(w), _t(pre), _t(post), use_kernel=True)
    torch.testing.assert_close(w_ker, w_ref, atol=1e-5, rtol=1e-5)
    assert float(torch.linalg.norm(w_ref - _t(w))) > 0   # something learned
    _close(w_ker, jpl.stdp_run(jpl.STDPConfig(), jnp.asarray(w),
                               jnp.asarray(pre), jnp.asarray(post),
                               use_kernel=True))


def test_stdp_step_matches_reference_on_traces_and_weight():
    """One legacy step, both paths, against the reference's einsum step
    from the same nonzero traces."""
    rng = np.random.default_rng(8)
    pre, post, w = _trains(8, T=1, B=4, M=16, N=12)
    tr = {"x_pre": rng.random((4, 16)).astype(np.float32),
          "x_post": rng.random((4, 12)).astype(np.float32)}
    jtr, jw = jpl.stdp_step(jpl.STDPConfig(), {k: jnp.asarray(v) for k, v
                                                in tr.items()},
                            jnp.asarray(w), jnp.asarray(pre[0]),
                            jnp.asarray(post[0]))
    for use_kernel in (False, True):
        ttr, tw = stdp_step(STDPConfig(), {k: _t(v) for k, v in tr.items()},
                            _t(w), _t(pre[0]), _t(post[0]),
                            use_kernel=use_kernel)
        _close(tw, jw, atol=1e-6, rtol=1e-6)
        for k in jtr:
            _close(ttr[k], jtr[k], atol=0, rtol=0, msg=k)


def test_stdp_init_defaults_to_the_card(monkeypatch):
    assert stdp_init(3, 2, 4, device="cpu")["x_pre"].shape == (4, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stdp_init(3, 2)


# ---------------------------------------------------------------------------
# the SynapseProgram IR: factories vs hand references
# ---------------------------------------------------------------------------


def test_pair_stdp_program_matches_legacy_loop():
    """The pair_stdp factory's per-step interpretation reproduces the
    hand-coded stdp_step/stdp_run trajectory (weights AND traces), and
    both equal the reference's."""
    pre, post, w = _trains(1)
    cfg = STDPConfig()
    syn = synapse_run(cfg.program, _t(w), _t(pre), _t(post))
    w_legacy = stdp_run(cfg, _t(w), _t(pre), _t(post))
    torch.testing.assert_close(syn["w"], w_legacy, atol=1e-6, rtol=0)
    traces = stdp_init(w.shape[0], w.shape[1], pre.shape[1], device="cpu")
    ww = _t(w)
    for t in range(pre.shape[0]):
        traces, ww = stdp_step(cfg, traces, ww, _t(pre[t]), _t(post[t]))
    for k in ("x_pre", "x_post"):
        torch.testing.assert_close(syn[k], traces[k], atol=1e-6, rtol=0)
    ref = jpl.synapse_run(jpl.STDPConfig().program, jnp.asarray(w),
                          jnp.asarray(pre), jnp.asarray(post))
    for k in ref:
        _close(syn[k], ref[k], atol=1e-6, rtol=0, msg=k)


def test_triplet_stdp_slow_traces_read_previous_value():
    """Triplet terms gate on the slow traces' pre-update values
    (update="after"): a manual Pfister-Gerstner step must agree, and so
    must the reference."""
    prog = triplet_stdp(w_min=-5.0, w_max=5.0)
    pre, post, w = _trains(2, T=10, B=2, M=6, N=4)
    pre_t, post_t = _t(pre), _t(post)
    syn = synapse_init(prog, _t(w), pre.shape[1])
    tr = {k: syn[k] for k in ("r1", "r2", "o1", "o2")}
    ww = _t(w)
    taus = {t.name: t.decay.value for t in prog.traces}
    amps = [t.amp for t in prog.terms]
    ein = torch.einsum
    for t in range(pre.shape[0]):
        r1 = taus["r1"] * tr["r1"] + pre_t[t]
        o1 = taus["o1"] * tr["o1"] + post_t[t]
        dw = (amps[0] * ein("bi,bj->ij", r1, post_t[t])
              + amps[1] * ein("bi,bj->ij", r1, post_t[t] * tr["o2"])
              + amps[2] * ein("bi,bj->ij", pre_t[t], o1)
              + amps[3] * ein("bi,bj->ij", pre_t[t] * tr["r2"], o1))
        ww = torch.clamp(ww + dw, prog.w_min, prog.w_max)
        tr = {"r1": r1, "o1": o1,
              "r2": taus["r2"] * tr["r2"] + pre_t[t],
              "o2": taus["o2"] * tr["o2"] + post_t[t]}
    syn = synapse_run(prog, _t(w), pre_t, post_t)
    torch.testing.assert_close(syn["w"], ww, atol=1e-5, rtol=0)
    ref = jpl.synapse_run(jpl.triplet_stdp(w_min=-5.0, w_max=5.0),
                          jnp.asarray(w), jnp.asarray(pre),
                          jnp.asarray(post))
    for k in tr:
        torch.testing.assert_close(syn[k], tr[k], atol=1e-5, rtol=0)
    for k in ref:
        _close(syn[k], ref[k], msg=k)


def test_reward_stdp_gated_by_modulator():
    """No reward -> frozen weights; constant unit reward -> exactly pair
    STDP; each reward level's trajectory equals the reference's
    `synapse_run`, including where the unit-reward run hits the -1 clip
    (so half reward need not give half the update there)."""
    pre, post, w = _trains(3)
    w[:2] = [[-0.995], [0.995]]          # two rows at the bounds
    T = pre.shape[0]
    prog = reward_stdp()
    frozen = synapse_run(prog, _t(w), _t(pre), _t(post))      # mod=None
    assert torch.equal(frozen["w"], _t(w))
    ones = synapse_run(prog, _t(w), _t(pre), _t(post), mod=torch.ones(T))
    pair = synapse_run(pair_stdp(), _t(w), _t(pre), _t(post))
    torch.testing.assert_close(ones["w"], pair["w"], atol=1e-6, rtol=0)
    clipped = False
    for level in (1.0, 0.5):
        got = synapse_run(prog, _t(w), _t(pre), _t(post),
                          mod=level * torch.ones(T))
        ref = jpl.synapse_run(jpl.reward_stdp(), jnp.asarray(w),
                              jnp.asarray(pre), jnp.asarray(post),
                              mod=level * jnp.ones((T,)))
        for k in ref:
            _close(got[k], ref[k], msg=f"{level} {k}")
        free = synapse_run(reward_stdp(w_min=-9.0, w_max=9.0), _t(w),
                           _t(pre), _t(post), mod=level * torch.ones(T))
        clipped |= not torch.equal(free["w"], got["w"])
    assert clipped, "no run reached the clip: the case would be vacuous"


def test_accumulated_spike_rule_matches_closed_form():
    """Teaching signal on the final step only: the learned update is
    exactly lr * (sum_t s_pre) (x) delta, as in the reference."""
    pre, post, w = _trains(4, T=9, B=2, M=7, N=3)
    lr = 0.05
    delta = np.random.default_rng(9).standard_normal((2, 3)).astype(
        np.float32)
    mod = np.zeros((9, 2, 3), np.float32)
    mod[-1] = delta
    syn = synapse_run(accumulated_spike(lr=lr), _t(w), _t(pre), _t(post),
                      mod=_t(mod))
    expect = _t(w) + lr * torch.einsum("bi,bj->ij", _t(pre).sum(0),
                                       _t(delta))
    torch.testing.assert_close(syn["w"], expect, atol=1e-5, rtol=1e-5)
    ref = jpl.synapse_run(jpl.accumulated_spike(lr=lr), jnp.asarray(w),
                          jnp.asarray(pre), jnp.asarray(post),
                          mod=jnp.asarray(mod))
    for k in ref:
        _close(syn[k], ref[k], msg=k)


def test_synapse_program_validation():
    """The port refuses what the reference refuses, with its messages."""
    ok = pair_stdp()
    assert validate_synapse_program(ok) is ok
    bad = [
        ("reserved", lambda D: dict(
            traces=(("mod", "pre", D("const", 0.9)),),
            terms=((0.1,),))),
        ("bad source", lambda D: dict(
            traces=(("x", "sideways", D("const", 0.9)),),
            terms=((0.1,),))),
        ("at least one update term", lambda D: dict(traces=(), terms=())),
        ("unknown factor", lambda D: dict(
            traces=(), terms=((0.1, ("ghost",)),))),
        ("post-side", lambda D: dict(traces=(), terms=((0.1, ("mod",)),))),
        ("reads a pre trace", lambda D: dict(
            traces=(("x", "pre", D("const", 0.9)),),
            terms=((0.1, ("spikes",), ("x",)),))),
        ("w_min", lambda D: dict(traces=(), terms=((0.1,),),
                                 w_min=1.0, w_max=-1.0)),
        ("duplicate trace names", lambda D: dict(
            traces=(("x", "pre", D("const", 0.9)),
                    ("x", "post", D("const", 0.9))), terms=((0.1,),))),
        ("learned decay needs", lambda D: dict(
            traces=(("x", "pre", D("learned", 0.9)),), terms=((0.1,),))),
        ("non-finite amp", lambda D: dict(traces=(),
                                          terms=((float("nan"),),))),
    ]
    for match, spec in bad:
        for mod, D in ((tpl, Decay), (jpl, JDecay)):
            kw = spec(D)
            prog = mod.SynapseProgram(
                traces=tuple(mod.TraceVar(*a) for a in kw.pop("traces")),
                terms=tuple(mod.UpdateTerm(*a) for a in kw.pop("terms")),
                **kw)
            with pytest.raises(ValueError, match=match):
                mod.validate_synapse_program(prog)


def test_synapse_registry_roundtrip_and_duplicates():
    made = make_synapse("pair_stdp", a_plus=0.02)
    assert made.terms[0].amp == 0.02
    with pytest.raises(KeyError):
        make_synapse("no_such_rule")
    with pytest.raises(ValueError, match="already registered"):
        register_synapse("pair_stdp", pair_stdp)
    # override is explicit and reversible
    register_synapse("pair_stdp", pair_stdp, override=True)
    for name in RULES:
        prog = validate_synapse_program(make_synapse(name))
        assert repr(prog) == repr(jpl.make_synapse(name)).replace(
            "repro.core", "repro_torch.core")


def test_synapse_step_matches_reference():
    """One step of each built-in rule from nonzero traces, with a
    modulator, against the reference's `synapse_step` (its jit check has no
    counterpart here: the port does not trace)."""
    pre, post, w = _trains(5, T=1, B=3)
    rng = np.random.default_rng(5)
    m = rng.random((3, 5)).astype(np.float32)
    for name in RULES:
        prog, jprog = make_synapse(name), jpl.make_synapse(name)
        syn0 = {t.name: rng.random((3, 8 if t.source == "pre" else 5)
                                   ).astype(np.float32) for t in prog.traces}
        syn0["w"] = w
        got = synapse_step(prog, {k: _t(v) for k, v in syn0.items()},
                           _t(pre[0]), _t(post[0]), _t(m))
        ref = jpl.synapse_step(jprog, {k: jnp.asarray(v) for k, v in
                                       syn0.items()}, jnp.asarray(pre[0]),
                               jnp.asarray(post[0]), jnp.asarray(m))
        assert set(got) == set(ref)
        for k in ref:
            _close(got[k], ref[k], atol=1e-6, rtol=1e-6, msg=f"{name} {k}")


@pytest.mark.parametrize("mod", [None, 0.7, "per_trial", "per_neuron"])
def test_mod_plane_matches_reference(mod):
    B, N = 3, 4
    val = {"per_trial": np.array([0.5, -1.0, 2.0], np.float32),
           "per_neuron": np.arange(12, dtype=np.float32).reshape(3, 4)
           }.get(mod, mod)
    got = tpl.mod_plane(None if val is None else (
        _t(val) if isinstance(val, np.ndarray) else val), B, N,
        torch.float32, device="cpu")
    ref = jpl.mod_plane(None if val is None else jnp.asarray(val), B, N,
                        jnp.float32)
    assert tuple(got.shape) == (B, N)
    _close(got, ref, atol=0, rtol=0)


def test_synapse_init_aliases_the_weight_and_nothing_writes_it():
    """The state's "w" is the weight tensor itself (the reference's
    `{"w": w}`), and a learning run returns a new tensor without writing
    into it."""
    pre, post, w = _trains(6)
    wt = _t(w.copy())
    syn0 = synapse_init(pair_stdp(), wt, pre.shape[1])
    assert syn0["w"] is wt
    out = synapse_run(pair_stdp(), wt, _t(pre), _t(post), syn=syn0)
    assert out["w"] is not wt and not torch.equal(out["w"], wt)
    assert torch.equal(wt, _t(w)) and syn0["w"] is wt
