"""The port's fault injection (`repro_torch.core.faults`) held against the
JAX package's (`repro.core.faults`): the twin of `tests/test_faults.py`.

* The spec grammar, REPRO_FAULTS and `inject()` resolve as in the
  reference.
* Every data fault's mask is the reference's bit for bit: the port draws
  it with its own numpy threefry-2x32, which must give what
  `jax.random.uniform(fold_in(PRNGKey(seed), crc32(site)), shape)` gives,
  at several seeds and shapes, for `drop_blocks`, `dead_rows` (dead and
  stuck, all nodes and a named one), `bitflip` and `nan_weights`; a
  session axis gets one session's mask, as under the reference's vmap.
* `compile_fail` fails exactly the reference's `_fails` set over every
  registered kernel name, and raises `FaultInjectedError` out of dispatch
  (the port has no fallback chain); `vmem_limit` raises.
* `plan.run` under faults matches the JAX `plan.run` within
  `CROSS_ENGINE_ATOL` on the DH-SNN and the plastic net of the JAX tests
  (`tests/_faults.py`), the port's plan equals its stepper under faults on
  a feed-forward program, and a second run draws no mask on the host.

`test_faults_jit_matches_eager` has no twin: the port has no jit.
Each test runs inside both packages' `faults.inject(...)`, so a chaos
REPRO_FAULTS in the environment cannot leak in; the JAX package runs its
reference kernels (REPRO_KERNEL_IMPL=ref), as its own tests do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import faults as jfaults
from repro.core import plan as jplan
from repro.kernels import registry as jregistry
from repro_torch.core import faults, plan
from repro_torch.kernels import registry
from tests import _faults as jnets
from tests._torch_parity import hidden_membrane, max_err_before, tie_rule
from repro_torch.core.snn_layers import make_dhsnn_shd, make_plastic_ff
from repro_torch.weights import params_from_numpy, params_to_numpy

ATOL = plan.CROSS_ENGINE_ATOL
SPEC = ("drop_blocks:p=0.3,seed=3;dead_rows:frac=0.2,seed=5;"
        "bitflip:frac=0.01,seed=7")


@pytest.fixture(autouse=True)
def _reference_kernels(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_IMPL", "ref")
    faults.clear_mask_cache()


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _same(spec):
    """Both packages' fault context at once."""
    class Both:
        def __enter__(self):
            self.a, self.b = jfaults.inject(spec), faults.inject(spec)
            self.a.__enter__()
            self.b.__enter__()

        def __exit__(self, *exc):
            self.b.__exit__(*exc)
            self.a.__exit__(*exc)
    return Both()


def _dh_net():
    """`tests/_faults.py::dh_net` in both packages, the same weights."""
    jn, jp = jnets.dh_net()
    tn, _ = make_dhsnn_shd(torch.Generator().manual_seed(0), n_in=32,
                           n_hidden=24, n_out=8, device="cpu")
    return jn, jp, tn, params_from_numpy(_np_tree(jp), "cpu")


def _plastic_net():
    """`tests/_faults.py::plastic_net` in both packages."""
    jn, jp = jnets.plastic_net()
    tn, _ = make_plastic_ff(torch.Generator().manual_seed(0), n_in=24,
                            n_hidden=16, n_out=4, device="cpu")
    return jn, jp, tn, params_from_numpy(_np_tree(jp), "cpu")


def _raster(T, B, n, rate, seed):
    return (np.random.default_rng(seed).random((T, B, n)) < rate).astype(
        np.float32)


def _bits(a):
    """fp32 bit patterns (NaN and -0 compare exactly)."""
    return np.asarray(a, np.float32).view(np.uint32)


# ---------------------------------------------------------------------------
# spec grammar + resolution
# ---------------------------------------------------------------------------


def test_parse_spec_matches_reference():
    spec = "drop_blocks:p=0.1,seed=3; dead_rows:frac=0.2,mode=stuck"
    fs = faults.parse(spec)
    assert [f.kind for f in fs] == ["drop_blocks", "dead_rows"]
    assert fs[0].getf("p", 0.0) == pytest.approx(0.1)
    assert fs[0].geti("seed", 0) == 3
    assert fs[1].get("mode") == "stuck"
    assert [(f.kind, f.params) for f in fs] == \
        [(f.kind, f.params) for f in jfaults.parse(spec)]
    assert faults.describe(fs) == jfaults.describe(jfaults.parse(spec))
    assert faults.KINDS == jfaults.KINDS


def test_parse_rejects_unknown_kind_and_bad_param():
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.parse("cosmic_ray:p=1")
    with pytest.raises(ValueError, match="not key=value"):
        faults.parse("drop_blocks:p")


def test_env_spec_activates(monkeypatch):
    monkeypatch.setenv("REPRO_FAULTS", "bitflip:frac=0.5,seed=1")
    assert [f.kind for f in faults.active()] == ["bitflip"]
    monkeypatch.setenv("REPRO_FAULTS", "")
    assert faults.active() == ()


def test_inject_overrides_env(monkeypatch):
    monkeypatch.setenv("REPRO_FAULTS", "bitflip:frac=0.5")
    with faults.inject("dead_rows:frac=0.1"):
        assert [f.kind for f in faults.active()] == ["dead_rows"]
        with faults.inject(""):        # chaos-CI escape hatch: clean world
            assert faults.active() == ()
    assert [f.kind for f in faults.active()] == ["bitflip"]


# ---------------------------------------------------------------------------
# the masks, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 123456, 2 ** 31 - 1])
@pytest.mark.parametrize("site,shape", [
    ("drop_blocks:40x700", (5, 6)), ("dead_rows:hidden:64", (64,)),
    ("nan:hidden/w_input", (700, 256)), ("bitflip:readout/w_hidden", (3, 5, 7))])
def test_uniform_draw_is_jax_random_bit_for_bit(seed, site, shape):
    ref = jax.random.uniform(jfaults._site_key(seed, site), shape)
    got = faults._uniform(faults._site_key(seed, site), shape)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    key = jax.random.key_data(jfaults._site_key(seed, site))
    assert faults._site_key(seed, site) == tuple(int(k) for k in key)


@pytest.mark.parametrize("spec,shape", [
    ("drop_blocks:p=0.5,bt=4,bn=16,seed=7", (16, 2, 64)),
    ("drop_blocks:p=0.2,seed=1", (32, 3, 700)),
    ("drop_blocks:p=0.3,bt=5,bn=9,seed=11", (13, 1, 30)),
])
def test_drop_blocks_equals_reference(spec, shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    with _same(spec):
        ref = jfaults.perturb_input(jnp.asarray(x))
        got = faults.perturb_input(torch.from_numpy(x))
        again = faults.perturb_input(torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    assert torch.equal(got, again)
    assert float(got.abs().sum()) < float(np.abs(x).sum())


@pytest.mark.parametrize("spec,node", [
    ("dead_rows:frac=0.4,node=hidden,seed=2", "hidden"),
    ("dead_rows:frac=0.4,node=hidden,seed=2", "readout"),
    ("dead_rows:frac=0.4,mode=stuck,seed=2", "hidden"),
    ("dead_rows:frac=0.1,seed=9", "readout"),
    ("dead_rows:frac=0.3,mode=stuck,node=a|b,seed=4", "b"),
])
@pytest.mark.parametrize("shape", [(5, 3, 40), (2, 64), (7, 1, 1, 20)])
def test_dead_rows_equal_reference(spec, node, shape):
    out = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    with _same(spec):
        ref = jfaults.perturb_output(node, jnp.asarray(out))
        got = faults.perturb_output(node, torch.from_numpy(out))
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_dead_rows_mask_only_the_named_node():
    out = torch.ones(5, 3, 40)
    with faults.inject("dead_rows:frac=0.4,node=hidden,seed=2"):
        hit = faults.perturb_output("hidden", out)
        other = faults.perturb_output("readout", out)
    assert float(hit.sum()) < float(out.sum())
    assert torch.equal(other, out)
    col = hit.sum(dim=(0, 1)).unique().tolist()
    assert set(col) <= {0.0, 15.0}


@pytest.mark.parametrize("spec", ["nan_weights:frac=0.3,seed=5",
                                  "bitflip:frac=0.3,seed=5",
                                  "bitflip:frac=0.01,seed=1;"
                                  "nan_weights:frac=0.05,seed=2"])
def test_weight_poisoning_equals_reference(spec):
    rng = np.random.default_rng(3)
    arrays = {"hidden": {"w_input": rng.standard_normal((4, 30, 8)),
                         "neuron": {"tau_m": rng.standard_normal(8)},
                         "bias": rng.standard_normal(8)},
              "readout": {"w_hidden": rng.standard_normal((8, 4))}}
    arrays = jax.tree_util.tree_map(lambda a: a.astype(np.float32), arrays)
    with _same(spec):
        ref = jfaults.perturb_params(
            jax.tree_util.tree_map(jnp.asarray, arrays))
        got = faults.perturb_params(params_from_numpy(arrays, "cpu"))
    for node, key in (("hidden", "w_input"), ("readout", "w_hidden")):
        np.testing.assert_array_equal(_bits(got[node][key]),
                                      _bits(ref[node][key]))
    assert torch.equal(got["hidden"]["bias"],
                       torch.from_numpy(arrays["hidden"]["bias"]))
    assert torch.equal(got["hidden"]["neuron"]["tau_m"],
                       torch.from_numpy(arrays["hidden"]["neuron"]["tau_m"]))


def test_session_axis_gets_one_sessions_mask():
    """A (S, K, N) plastic weight of a learning serve window: the mask is
    drawn on (K, N) and broadcast, as `jax.vmap` of the reference's
    `perturb_params` over the sessions draws it."""
    w = np.random.default_rng(4).standard_normal((5, 24, 16)).astype(
        np.float32)
    spec = "nan_weights:frac=0.2,seed=3;bitflip:frac=0.1,seed=4"
    with _same(spec):
        ref = jax.vmap(lambda v: jfaults.perturb_params(
            {"hidden": {"w_input": v}})["hidden"]["w_input"])(jnp.asarray(w))
        got = faults.perturb_params(
            {"hidden": {"w_input": torch.from_numpy(w)}},
            sessions={("hidden", "w_input")})["hidden"]["w_input"]
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def test_identity_when_inactive():
    x = torch.ones(4, 2, 8)
    with faults.inject(""):
        assert faults.perturb_input(x) is x
        assert faults.perturb_output("n", x) is x
        p = {"n": {"w_x": x}}
        assert faults.perturb_params(p) is p


def test_mask_cache_serves_a_repeat_run_without_drawing():
    jn, jp, tn, tp = _dh_net()
    x = torch.from_numpy(_raster(12, 4, 32, 0.3, 1))
    with faults.inject(SPEC):
        plan.run(tn, tp, x, device="cpu")
        first = faults.mask_cache_info()
        plan.run(tn, tp, x, device="cpu")
        second = faults.mask_cache_info()
    # drop_blocks, dead_rows on both nodes, bitflip on both weight planes
    assert first["draws"] == 5
    assert second["draws"] == first["draws"]
    assert second["hits"] - first["hits"] == 5


# ---------------------------------------------------------------------------
# infrastructure faults
# ---------------------------------------------------------------------------


def _kernel_names():
    return sorted(set(registry.names()) | set(registry.launch_counts())
                  | set(jregistry.names()))


@pytest.mark.parametrize("spec", [
    "compile_fail:kernels=*,p=0.5,seed=1", "compile_fail:kernels=*,p=0.3",
    "compile_fail:kernels=lif|linrec|spikemm_sessions,p=0.7,seed=9",
    "compile_fail:kernels=*,p=1", "compile_fail:kernels=*,p=0",
    "compile_fail:kernels=attention"])
def test_compile_fail_set_equals_reference(spec):
    f, jf_ = faults.parse(spec)[0], jfaults.parse(spec)[0]
    names = _kernel_names()
    picks = {k: faults._fails(f, k) for k in names}
    assert picks == {k: jfaults._fails(jf_, k) for k in names}
    with faults.inject(spec):
        for k in registry.names():
            if picks[k]:
                with pytest.raises(faults.FaultInjectedError, match=k):
                    faults.check_dispatch(k)
            else:
                faults.check_dispatch(k)


def test_compile_fail_raises_out_of_dispatch_on_either_pass():
    """No fallback: the targeted family's dispatch raises before choosing
    a device, and so does its backward's; an untargeted family runs."""
    a = torch.full((6, 2, 5), 0.9)
    x = torch.randn(6, 2, 5, generator=torch.Generator().manual_seed(0))
    h0 = torch.zeros(2, 5)
    with faults.inject("compile_fail:kernels=linrec"):
        with pytest.raises(faults.FaultInjectedError, match="linrec"):
            registry.dispatch("linrec", (a, x, h0))
        with pytest.raises(faults.FaultInjectedError, match="linrec"):
            registry.dispatch_bwd("linrec", (a, x, h0, x, x, h0))
        registry.dispatch("lif", (x, torch.full((5,), 0.9), h0), v_th=1.0,
                          reset="zero")
    with faults.inject("compile_fail:kernels=lif|linrec"):
        with pytest.raises(faults.FaultInjectedError):
            faults.maybe_fail_compile("lif")
        faults.maybe_fail_compile("spikemm")      # untargeted: no raise


def test_vmem_limit_parses_and_raises_at_dispatch():
    with faults.inject("vmem_limit:mb=2;vmem_limit:mb=1"):
        assert faults.vmem_limit_override_bytes() == 1 * 2 ** 20
        with pytest.raises(faults.FaultInjectedError, match="VMEM"):
            registry.dispatch("linrec", (torch.full((3, 1, 2), 0.5),
                                         torch.ones(3, 1, 2),
                                         torch.zeros(1, 2)))
    with faults.inject(""):
        assert faults.vmem_limit_override_bytes() is None


# ---------------------------------------------------------------------------
# through the engines
# ---------------------------------------------------------------------------


def _leaves(state):
    return {(n, k): v for n, d in state.items() for k, v in d.items()
            if not isinstance(v, dict)}


@pytest.mark.parametrize("spec", ["", SPEC,
                                  "dead_rows:frac=0.3,mode=stuck,seed=1",
                                  "nan_weights:frac=0.05,seed=2"])
def test_plan_run_under_faults_matches_reference_dh_net(spec):
    jn, jp, tn, tp = _dh_net()
    x = _raster(12, 4, 32, 0.3, 1)
    with _same(spec):
        js, jo, jr = jplan.run(jn, jp, jnp.asarray(x), record=("hidden",))
        ts, to, tr = plan.run(tn, tp, torch.from_numpy(x),
                              record=("hidden",), device="cpu")
        tx = faults.perturb_input(torch.from_numpy(x)).numpy()
        tw = faults.perturb_params(tp)["hidden"]
    s_ref = np.asarray(jr["hidden"])
    u, th = hidden_membrane(tn[0], params_to_numpy(tw), tx, s_ref)
    first_div, _ = tie_rule(s_ref, tr["hidden"].numpy(), u, th)
    jo, to = np.asarray(jo), to.numpy()
    np.testing.assert_array_equal(np.isnan(jo), np.isnan(to))
    assert max_err_before(np.nan_to_num(jo), np.nan_to_num(to),
                          first_div) <= ATOL
    clean = first_div == x.shape[0]
    jl, tl = _leaves(js), _leaves(ts)
    assert set(jl) == set(tl)
    for k in jl:
        np.testing.assert_allclose(tl[k].numpy()[clean],
                                   np.asarray(jl[k])[clean], rtol=ATOL,
                                   atol=ATOL, err_msg=str(k))
    if spec == SPEC:
        with faults.inject(""):
            _, clean_out, _ = plan.run(tn, tp, torch.from_numpy(x),
                                       device="cpu")
        assert not torch.equal(clean_out, torch.from_numpy(to))


@pytest.mark.parametrize("spec", [SPEC, "nan_weights:frac=0.1,seed=4"])
def test_plan_run_under_faults_matches_reference_plastic_net(spec):
    """The learning window too: the learned weight and traces under the
    faults (the NaN plane seeds the synapse, as init_state seeds it from
    the perturbed params in both packages)."""
    jn, jp, tn, tp = _plastic_net()
    x = _raster(12, 4, 24, 0.3, 2)
    with _same(spec):
        js, jo, _ = jplan.run(jn, jp, jnp.asarray(x))
        ts, to, _ = plan.run(tn, tp, torch.from_numpy(x), device="cpu")
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=ATOL,
                               atol=ATOL)
    for k, v in js["hidden"]["syn:input"].items():
        np.testing.assert_allclose(ts["hidden"]["syn:input"][k].numpy(),
                                   np.asarray(v), rtol=ATOL, atol=ATOL,
                                   err_msg=k)


def test_plan_equals_stepper_under_faults(monkeypatch):
    """The fused plan and the per-step stepper see the same injected world
    on a feed-forward program: the dead rows' mask depends on the neuron
    axis only."""
    _, _, tn, tp = _dh_net()
    x = torch.from_numpy(_raster(12, 4, 32, 0.3, 1))
    with faults.inject(SPEC):
        _, fused, _ = plan.run(tn, tp, x, device="cpu")
        monkeypatch.setenv("REPRO_SNN_ENGINE", "stepper")
        _, stepped, _ = plan.run(tn, tp, x, device="cpu")
    torch.testing.assert_close(fused, stepped, rtol=ATOL, atol=ATOL)


def test_faults_change_the_run_and_are_deterministic():
    _, _, tn, tp = _dh_net()
    x = torch.from_numpy(_raster(12, 4, 32, 0.3, 1))
    with faults.inject(""):
        _, clean, _ = plan.run(tn, tp, x, device="cpu")
    with faults.inject(SPEC):
        _, a, _ = plan.run(tn, tp, x, device="cpu")
        faults.clear_mask_cache()
        _, b, _ = plan.run(tn, tp, x, device="cpu")
    assert not torch.equal(a, clean)
    assert torch.equal(a, b)
