"""The BCI cross-day decoder through the port, held against the JAX
package on the CPU.

Inputs come from `gen_bci_trials` (numpy) and the parameters from the
JAX `bci_init(PRNGKey(0))`, copied by `params_from_numpy`. Two configs:
the JAX test's (32 channels, 20 bins, 4 paths x 8) and a ragged one
(24 channels, 17 bins, 3 paths x 5, kernel_t 4: an even temporal kernel,
so the conv pads one step more after than before).

Tolerances, each stated where it is used:

* `bci_forward`: logits within 1e-5 (absolute; |logits| ~ 1-10, fp32
  einsums summed in another order), spikes under the threshold-tie rule
  (`tests/_torch_parity.py`, the float64 membrane of the CPU's own
  features), no lane flipped at these inputs.
* The day-0 loss and its gradient against `jax.value_and_grad`: the loss
  within 1e-6 relative, each leaf within a relative L2 error of 1e-5.
* `accumulated_spike_fc` and its three cotangents against the JAX custom
  VJP: 1e-6 (spike sums are exact; one fp32 product each).
* `fuse_bn1d_fc` against the JAX function and against BN1d then FC
  computed plainly: 1e-5.
* `bci_finetune_fc`: the 25 losses within 1e-5 relative plus 1e-6
  absolute (the loss falls to ~1e-3 while the logits it is taken from
  reach |20|, where one fp32 spacing of a logit is ~2e-6), the tuned
  `fc_w`/`fc_b` within 1e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.plasticity import accumulated_spike_fc as jasfc
from repro.core.plasticity import fuse_bn1d_fc as jfuse
from repro.core.snn_layers import BCIConfig as JBCIConfig
from repro.core.snn_layers import bci_finetune_fc as jfinetune
from repro.core.snn_layers import bci_forward as jforward
from repro.core.snn_layers import bci_init as jinit
from repro_torch.core.plasticity import accumulated_spike_fc, fuse_bn1d_fc
from repro_torch.core.snn_layers import (BCIConfig, bci_features,
                                         bci_finetune_fc, bci_forward,
                                         bci_init)
from repro_torch.data.spikes import gen_bci_trials
from repro_torch.kernels import registry
from repro_torch.weights import (grads_to_numpy, params_from_numpy,
                                 params_to_numpy)
from tests._torch_parity import lif_membrane, tie_rule

LOGIT_ATOL = 1e-5
LOSS_RTOL, LEAF_RTOL = 1e-6, 1e-5
ASFC_TOL = 1e-6
FUSE_TOL = 1e-5
FT_LOSS_RTOL, FT_LOSS_ATOL, FT_FC_ATOL = 1e-5, 1e-6, 1e-5
LIF_TAU, V_TH = 0.8, 1.0          # bci_forward's LIF(tau=0.8)

CONFIGS = {"jax_test": dict(n_channels=32, n_steps=20, n_paths=4, d_path=8),
           "ragged": dict(n_channels=24, n_steps=17, n_paths=3, d_path=5,
                          kernel_t=4)}
KEYS = ("lin", "attn", "tconv", "fc_w", "fc_b")


def _setup(name, n=96, day=0, seed=0):
    kw = CONFIGS[name]
    cfg, jcfg = BCIConfig(**kw), JBCIConfig(**kw)
    jparams = jinit(jax.random.PRNGKey(0), jcfg)
    nparams = jax.tree_util.tree_map(np.asarray, jparams)
    x, y = gen_bci_trials(n, day=day, seed=seed, n_channels=cfg.n_channels,
                          n_bins=cfg.n_steps)
    return cfg, jcfg, jparams, nparams, x, y


def _jloss(params, x, y, cfg):
    logits, _ = jforward(params, x, cfg)
    return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(len(y)), y])


def _loss(params, x, y, cfg):
    logits, _ = bci_forward(params, x, cfg)
    return -torch.log_softmax(logits, -1)[torch.arange(len(y)), y].mean()


def _rel_l2(got, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - ref)
                 / max(np.linalg.norm(ref), 1e-30))


def _held_by_tie_rule(params, x, spikes_ref, spikes_test, cfg):
    """The two records under the tie rule, on the float64 membrane of the
    port's CPU features along `spikes_ref`; returns the flips."""
    with torch.no_grad():
        feat = bci_features(params, torch.from_numpy(x), cfg).numpy()
    u = lif_membrane(feat, LIF_TAU, spikes_ref, V_TH)
    _, flips = tie_rule(spikes_ref, spikes_test, u, V_TH)
    return flips


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_bci_forward_matches_jax(name):
    cfg, jcfg, jparams, nparams, x, _ = _setup(name)
    jl, js = jforward(jparams, jnp.asarray(x), jcfg)
    params = params_from_numpy(nparams, device="cpu")
    with torch.no_grad():
        logits, spikes = bci_forward(params, torch.from_numpy(x), cfg)
    assert spikes.shape == (cfg.n_steps, len(x), cfg.n_paths * cfg.d_path)
    rate = float(spikes.mean())
    assert 0.01 <= rate < 0.5, rate          # the comparison is not vacuous
    flips = _held_by_tie_rule(params, x, np.asarray(js), spikes.numpy(), cfg)
    assert flips == 0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0,
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_bci_day0_loss_and_gradients_match_jax(name):
    cfg, jcfg, jparams, nparams, x, y = _setup(name)
    jl, jg = jax.value_and_grad(_jloss)(jparams, jnp.asarray(x),
                                        jnp.asarray(y), jcfg)
    params = params_from_numpy(nparams, device="cpu")
    for p in params.values():
        p.requires_grad_()
    loss = _loss(params, torch.from_numpy(x), torch.from_numpy(y).long(),
                 cfg)
    loss.backward()
    assert abs(loss.item() - float(jl)) <= LOSS_RTOL * abs(float(jl))
    grads = grads_to_numpy(params)
    assert sorted(grads) == sorted(KEYS)
    for k in KEYS:
        assert np.abs(np.asarray(jg[k])).sum() > 0, k
        assert _rel_l2(grads[k], jg[k]) <= LEAF_RTOL, (k, _rel_l2(
            grads[k], jg[k]))


@pytest.mark.parametrize("raster", ["binary", "graded"])
def test_accumulated_spike_fc_vjp_matches_jax(raster):
    rng = np.random.default_rng(3)
    T, B, N, M = 13, 5, 37, 4
    s = (rng.random((T, B, N)) < 0.3).astype(np.float32)
    if raster == "graded":
        s *= rng.standard_normal((T, B, N)).astype(np.float32)
    w = rng.standard_normal((N, M)).astype(np.float32)
    b = rng.standard_normal(M).astype(np.float32)
    ct = rng.standard_normal((B, M)).astype(np.float32)
    jout, vjp = jax.vjp(jasfc, jnp.asarray(s), jnp.asarray(w),
                        jnp.asarray(b))
    jds, jdw, jdb = vjp(jnp.asarray(ct))
    ts, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (s, w, b))
    out = accumulated_spike_fc(ts, tw, tb)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=ASFC_TOL, atol=ASFC_TOL)
    ds, dw, db = torch.autograd.grad(out, (ts, tw, tb), torch.from_numpy(ct))
    for got, want in ((ds, jds), (dw, jdw), (db, jdb)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=ASFC_TOL, atol=ASFC_TOL)
    # d_spikes is d_acc broadcast over T: every step the same plane
    assert torch.equal(ds, ds[:1].expand_as(ds))


def test_accumulated_spike_fc_saves_only_the_accumulated_spikes():
    rng = np.random.default_rng(4)
    s = torch.from_numpy((rng.random((9, 3, 7)) < 0.4).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((7, 2)).astype(np.float32))
    w.requires_grad_()
    out = accumulated_spike_fc(s, w, torch.zeros(2))
    shapes = sorted(tuple(t.shape) for t in out.grad_fn.saved_tensors)
    assert shapes == [(3, 7), (7, 2)]          # acc and W, no (T, B, N)
    # only what autograd asks for: a raster that needs no gradient gets none
    (dw,) = torch.autograd.grad(out.sum(), (w,))
    np.testing.assert_allclose(dw.numpy(), np.repeat(
        s.sum(0).sum(0).numpy()[:, None], 2, axis=1), rtol=0, atol=0)


def test_fuse_bn1d_fc_matches_jax_and_bn_then_fc():
    rng = np.random.default_rng(5)
    N, M, B = 23, 6, 11
    gamma, beta, mean = (rng.standard_normal(N).astype(np.float32)
                         for _ in range(3))
    var = rng.random(N).astype(np.float32) + 0.1
    w = rng.standard_normal((N, M)).astype(np.float32)
    b = rng.standard_normal(M).astype(np.float32)
    x = rng.standard_normal((B, N)).astype(np.float32)
    eps = 1e-5
    jw, jb = jfuse(*(jnp.asarray(a) for a in (gamma, beta, mean, var)), eps,
                   jnp.asarray(w), jnp.asarray(b))
    t = [torch.from_numpy(a) for a in (gamma, beta, mean, var)]
    tw, tb = fuse_bn1d_fc(*t, eps, torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=FUSE_TOL,
                               atol=FUSE_TOL)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=FUSE_TOL,
                               atol=FUSE_TOL)
    # BN1d (inference: running statistics) then FC, computed plainly
    bn = (x - mean) / np.sqrt(var + eps) * gamma + beta
    np.testing.assert_allclose(x @ tw.numpy() + tb.numpy(), bn @ w + b,
                               rtol=FUSE_TOL, atol=FUSE_TOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_bci_finetune_fc_follows_jax(name):
    cfg, jcfg, jparams, nparams, _, _ = _setup(name)
    xf, yf = gen_bci_trials(32, day=3, seed=9, n_channels=cfg.n_channels,
                            n_bins=cfg.n_steps)
    jtuned, jlosses = jfinetune(jparams, jnp.asarray(xf), jnp.asarray(yf),
                                jcfg, lr=0.05, steps=25)
    params = params_from_numpy(nparams, device="cpu")
    tuned, losses = bci_finetune_fc(params, torch.from_numpy(xf),
                                    torch.from_numpy(yf).long(), cfg,
                                    lr=0.05, steps=25)
    assert losses.shape == (25,)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=FT_LOSS_RTOL, atol=FT_LOSS_ATOL)
    for k in ("fc_w", "fc_b"):
        np.testing.assert_allclose(tuned[k].numpy(), np.asarray(jtuned[k]),
                                   rtol=0, atol=FT_FC_ATOL)
        assert not np.array_equal(tuned[k].numpy(), nparams[k]), k
    # only the readout is tuned; the features' parameters are the same
    # tensors, and the caller's params are not written
    for k in ("lin", "attn", "tconv"):
        assert tuned[k] is params[k]
    for k in KEYS:
        np.testing.assert_array_equal(params[k].numpy(), nparams[k])


def test_bci_finetune_runs_no_lif_backward(monkeypatch):
    """Each fine-tune step runs one LIF forward and no LIF backward (its
    features need no gradient); a day-0 training step runs one of each."""
    cfg, _, _, nparams, x, y = _setup("jax_test", n=16)
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = registry.dispatch, registry.dispatch_bwd

    def fwd(name, *a, **kw):
        calls["fwd"] += name == "lif"
        return real_fwd(name, *a, **kw)

    def bwd(name, *a, **kw):
        calls["bwd"] += name == "lif"
        if name == "lif":
            assert not kw["need_tau"] and not kw["need_v0"]
        return real_bwd(name, *a, **kw)

    monkeypatch.setattr(registry, "dispatch", fwd)
    monkeypatch.setattr(registry, "dispatch_bwd", bwd)
    params = params_from_numpy(nparams, device="cpu")
    for p in params.values():
        p.requires_grad_()
    _loss(params, torch.from_numpy(x), torch.from_numpy(y).long(),
          cfg).backward()
    assert calls == {"fwd": 1, "bwd": 1}
    bci_finetune_fc(params, torch.from_numpy(x), torch.from_numpy(y).long(),
                    cfg, lr=0.05, steps=3)
    assert calls == {"fwd": 4, "bwd": 1}


def test_params_carry_the_bci_tree_both_ways():
    cfg, _, _, nparams, x, y = _setup("ragged", n=8)
    params = params_from_numpy(nparams, device="cpu")
    assert sorted(params) == sorted(KEYS)
    for k in KEYS:
        assert params[k].dtype == torch.float32 and params[k].is_contiguous()
        np.testing.assert_array_equal(params[k].numpy(), nparams[k])
        params[k].requires_grad_()
    back = params_to_numpy(params)
    assert all(np.array_equal(back[k], nparams[k]) for k in KEYS)
    assert grads_to_numpy(params) == {k: None for k in KEYS}
    _loss(params, torch.from_numpy(x), torch.from_numpy(y).long(),
          cfg).backward()
    grads = grads_to_numpy(params)
    assert all(grads[k].shape == nparams[k].shape for k in KEYS)


def test_bci_init_shapes_and_device(monkeypatch):
    cfg = BCIConfig(**CONFIGS["ragged"])
    a = bci_init(torch.Generator().manual_seed(2), cfg, device="cpu")
    b = bci_init(torch.Generator().manual_seed(2), cfg, device="cpu")
    P, C, D, K = cfg.n_paths, cfg.n_channels, cfg.d_path, cfg.kernel_t
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        "lin": (P, C, D), "attn": (P, C, C), "tconv": (P, K, D),
        "fc_w": (P * D, cfg.n_out), "fc_b": (cfg.n_out,)}
    assert all(torch.equal(a[k], b[k]) for k in KEYS)
    assert not a["fc_b"].any()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bci_init(torch.Generator().manual_seed(2), cfg)


def _clipped_sgd(params, x, y, cfg, steps, lr):
    """`tests/test_events_and_apps.py::_train_a_bit`'s update on the port."""
    losses = []
    for p in params.values():
        p.requires_grad_()
    for _ in range(steps):
        loss = _loss(params, x, y, cfg)
        g = torch.autograd.grad(loss, list(params.values()))
        gn = torch.sqrt(sum((gg ** 2).sum() for gg in g))
        sc = torch.clamp_max(1.0 / (gn + 1e-9), 1.0)
        with torch.no_grad():
            for p, gg in zip(params.values(), g):
                p -= lr * sc * gg
        losses.append(loss.item())
    return params, losses


def test_port_bci_cross_day_finetune_recovers_accuracy():
    """The port twin of `tests/test_events_and_apps.py::
    test_bci_cross_day_finetune_recovers_accuracy`: train day 0, the
    accuracy on a drifted day, then the 32-sample FC-only fine-tune does
    not lower it; the same data and (copied) parameters, the port alone."""
    cfg, _, _, nparams, x0, y0 = _setup("jax_test")
    params = params_from_numpy(nparams, device="cpu")
    params, losses = _clipped_sgd(params, torch.from_numpy(x0),
                                  torch.from_numpy(y0).long(), cfg, 60, 0.05)
    assert losses[-1] < losses[0] * 0.8

    def acc(p, x, y):
        with torch.no_grad():
            logits, _ = bci_forward(p, torch.from_numpy(x), cfg)
        return float((logits.argmax(-1) == torch.from_numpy(y)).float()
                     .mean())

    xt, yt = gen_bci_trials(64, day=3, n_channels=32, n_bins=20, seed=5)
    before = acc(params, xt, yt)
    xf, yf = gen_bci_trials(32, day=3, n_channels=32, n_bins=20, seed=9)
    tuned, _ = bci_finetune_fc(params, torch.from_numpy(xf),
                               torch.from_numpy(yf).long(), cfg, lr=0.05,
                               steps=25)
    after = acc(tuned, xt, yt)
    assert after >= before, (before, after)
