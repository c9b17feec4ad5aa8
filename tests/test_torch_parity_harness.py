"""The port's parity harness (`repro_torch.kernels.parity`), on the CPU.

The harness holds CUDA wrappers against plain versions on the card, so
here it must refuse to run. Its comparison logic is driven through a CPU
stand-in: `_card` is made to return the CPU, and registry entries get a
deliberately wrong (or a correct) implementation in place of their CUDA
wrapper.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.parity import _loss as jloss
from repro_torch.kernels import parity, registry
from repro_torch.kernels.attention.ref import attention_ref


@pytest.mark.parametrize("call", [
    lambda: parity.check_kernel("attention"),
    lambda: parity.check_kernel("spikemm", check_vjp=False),
    lambda: parity.check_all(),
])
def test_refuses_the_cpu(call, monkeypatch):
    """Without a card both sides would be the plain version: it raises
    rather than compare the plain version with itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cuda"'):
        call()


@pytest.fixture
def stand_in(monkeypatch):
    """Run the harness on the CPU; returns a function that replaces a
    family's CUDA wrapper (or a channel's) for the test."""
    monkeypatch.setattr(parity, "_card", lambda: torch.device("cpu"))
    registry.ensure_registered()
    reg = dict(registry._REGISTRY)
    monkeypatch.setattr(registry, "_REGISTRY", reg)

    def replace(name, cuda, channel=None, bwd=None):
        spec = registry.get(name)
        if bwd is not None:
            reg[name] = dataclasses.replace(spec, bwd=dataclasses.replace(
                spec.bwd, cuda=bwd))
        elif channel is None:
            reg[name] = dataclasses.replace(spec, cuda=cuda)
        else:
            chans = dict(spec.channels)
            chans[channel] = dataclasses.replace(chans[channel], cuda=cuda)
            reg[name] = dataclasses.replace(spec, channels=chans)
    return replace


def test_all_families_pass_with_their_plain_versions(stand_in, capsys,
                                                     monkeypatch):
    """With every CUDA wrapper (forward and backward) replaced by its plain
    version, every family passes, `attention`, `lif`, `linrec`, `lifrec`,
    `alif`, `alifrec`, `spikemm_gather` (B6) and `spikemm` (both channels)
    with their VJP, and `main` reports 13 kernels (the session axis of
    `spikemm` and `stdp_seq` among them)."""
    for name in registry.names():
        spec = registry.get(name)
        stand_in(name, spec.plain)
        for key, ch in spec.channels.items():
            stand_in(name, ch.plain, channel=key)
        if spec.bwd is not None:
            stand_in(name, None, bwd=spec.bwd.plain)
    reports = parity.check_all()
    assert set(reports) == set(registry.names())
    vjp = ("attention", "lif", "linrec", "lifrec", "alif", "alifrec",
           "spikemm_gather")
    for name in vjp:
        assert reports[name] == {"forward_max_err": 0.0,
                                 "vjp_max_err": 0.0}
    assert reports["spikemm"]["channels"] == {
        "spikemm_sparse": {"forward_max_err": 0.0, "vjp_max_err": 0.0}}
    assert reports["spikemm"]["vjp_max_err"] == 0.0
    assert all("vjp_max_err" not in r for n, r in reports.items()
               if n not in vjp + ("spikemm",))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "stand-in")
    parity.main()
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "parity OK for 13 kernels (device=stand-in)"
    assert len(lines) == 14
    assert any(line.startswith("spikemm_sparse ") for line in lines)


@pytest.mark.parametrize("name,channel,bad,match", [
    ("attention", None,
     lambda q, k, v, **kw: attention_ref(q, k, v, **kw) + 1e-2,
     "attention: forward leaf 0 max"),
    ("attention", None,
     lambda q, k, v, **kw: attention_ref(q, k, v.detach(), **kw),
     "attention: VJP wrt arg 2 max"),
    ("lif", None,
     lambda *a, **kw: (lambda s, v: (s, v + 1e-3))(
         *registry.get("lif").plain(*a, **kw)),
     "lif: forward leaf 1 max"),
    ("spikemm", "sparse",
     lambda s, w, **kw: s @ w + 1e-3,
     "spikemm_sparse: forward leaf 0 max"),
])
def test_a_wrong_kernel_fails_naming_it_and_the_leaf(stand_in, name, channel,
                                                     bad, match):
    if channel is not None:         # the family's own wrapper is right
        stand_in(name, registry.get(name).plain)
    stand_in(name, bad, channel=channel)
    with pytest.raises(AssertionError, match=match):
        parity.check_kernel(name)


def test_check_vjp_false_skips_the_gradients(stand_in):
    stand_in("attention", lambda q, k, v, **kw: attention_ref(
        q, k, v.detach(), **kw))
    assert parity.check_kernel("attention", check_vjp=False) == {
        "forward_max_err": 0.0}


def test_names_and_diff_argnums():
    """`attention` is registered; it, `lif`, `linrec`, `spikemm`,
    `lifrec`, `alif`, `alifrec` and `spikemm_gather` are the
    differentiable families, with the JAX specs' `diff_argnums` (the
    gather's: its raster); the five scans, spikemm (its weight gradient,
    counted as `spikemm_wgrad`) and the gather (B6, counted as
    `spikemm_gather_bwd`) carry a backward pair of their own; the STDP
    kernels and the session axis (`spikemm_sessions`,
    `stdp_seq_sessions`) have none (the learning pass and serving stay
    out of the graph)."""
    names = registry.names()
    assert "attention" in names and len(names) == 12
    assert {n: registry.get(n).diff_argnums for n in names
            if registry.get(n).diff_argnums} == {
        "attention": (0, 1, 2), "lif": (0, 1, 2), "linrec": (0, 1, 2),
        "spikemm": (0, 1), "lifrec": (0, 1, 2, 3, 4),
        "alif": (0, 1, 2, 3, 4), "alifrec": (0, 1, 2, 3, 4, 5, 6),
        "spikemm_gather": (0,)}
    assert {n for n in names if registry.get(n).bwd is not None} == {
        "lif", "linrec", "lifrec", "alif", "alifrec", "spikemm",
        "spikemm_gather"}
    assert registry.get("spikemm").bwd_name == "spikemm_wgrad"
    assert registry.get("spikemm_gather").bwd_name == "spikemm_gather_bwd"
    assert {"spikemm_wgrad", "spikemm_gather_bwd"} <= set(
        registry.launch_counts())


def test_loss_matches_the_jax_harness():
    rng = np.random.default_rng(0)
    leaves = [rng.standard_normal((3, 5)).astype(np.float32),
              rng.standard_normal((4,)).astype(np.float32)]
    got = parity._loss(tuple(torch.from_numpy(a) for a in leaves))
    want = jloss(tuple(jnp.asarray(a) for a in leaves))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
