"""The port's surrogate gradients held against the JAX package, on the CPU.

* `surrogate_names()` equals the reference's.
* Each of the four surrogate gradients, and `spike`'s VJP (ct * g), equal
  `jax.vjp` of `repro.core.surrogate.spike` on a grid that runs through
  every window edge (|x| = alpha / 2 for `rectangle`, 1 / alpha for
  `triangle`) and a step to either side of it, at alpha 0.5, 1 and 2.
  Both packages compute each proxy one rounded fp32 operation at a time
  in the same order, so `rectangle` and `triangle` are held bit for bit
  and the others within rtol 1e-6, atol 1e-7.
* `spike`'s forward is the exact Heaviside, and `register` adds a
  surrogate that `spike` then uses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import surrogate as jsurrogate
from repro_torch.core import surrogate

ALPHAS = (0.5, 1.0, 2.0)


def _grid(alpha: float) -> np.ndarray:
    """x through each window edge and one fp32 step to either side, and
    through 0 (a step of 1e-6 there: XLA on the CPU flushes subnormals to
    zero, so the step next to 0 would test that, not the surrogate)."""
    edges = np.float32([alpha / 2.0, 1.0 / alpha])
    pts = [np.linspace(-3.0, 3.0, 241, dtype=np.float32),
           np.float32([-1e-6, -0.0, 0.0, 1e-6])]
    for e in edges:
        for sign in (1.0, -1.0):
            c = np.float32(sign * e)
            pts.append(np.float32([np.nextafter(c, np.float32(-np.inf)), c,
                                   np.nextafter(c, np.float32(np.inf))]))
    return np.concatenate(pts).astype(np.float32)


def test_surrogate_names_match_the_reference():
    assert surrogate.surrogate_names() == jsurrogate.surrogate_names()


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("name", ["arctan", "rectangle", "sigmoid",
                                  "triangle"])
def test_spike_vjp_matches_jax(name, alpha):
    x = _grid(alpha)
    ct = np.random.default_rng(0).standard_normal(x.shape).astype(
        np.float32)
    s_j, vjp = jax.vjp(lambda v: jsurrogate.spike(v, name, alpha),
                       jnp.asarray(x))
    (g_j,) = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_()
    s_t = surrogate.spike(xt, name, alpha)
    (g_t,) = torch.autograd.grad(s_t, xt, torch.from_numpy(ct))
    np.testing.assert_array_equal(s_t.detach().numpy(), np.asarray(s_j))
    want = np.asarray(jsurrogate._SURROGATES[name](
        jnp.asarray(x), jnp.asarray(alpha, jnp.float32)))
    got = surrogate.surrogate_grad(torch.from_numpy(x), name, alpha).numpy()
    if name in ("rectangle", "triangle"):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("alpha", ALPHAS)
def test_rectangle_window_edge_is_open(alpha):
    """1/alpha strictly inside |x| < alpha/2, 0 on the edge itself."""
    e = np.float32(alpha / 2.0)
    x = torch.tensor([np.nextafter(e, np.float32(0)), e, -e],
                     dtype=torch.float32)
    g = surrogate.surrogate_grad(x, "rectangle", alpha)
    assert g.tolist() == [np.float32(1.0) / np.float32(alpha), 0.0, 0.0]


def test_register_adds_a_surrogate_spike_uses():
    name = "test_flat"
    surrogate.register(name)(lambda x, alpha: torch.full_like(x, 0.25))
    try:
        assert name in surrogate.surrogate_names()
        x = torch.tensor([-1.0, 0.0, 2.0], requires_grad=True)
        s = surrogate.spike(x, name, 1.0)
        assert s.tolist() == [0.0, 1.0, 1.0]
        (g,) = torch.autograd.grad(s.sum(), x)
        assert g.tolist() == [0.25, 0.25, 0.25]
    finally:
        surrogate._SURROGATES.pop(name)


def test_unknown_surrogate_raises():
    with pytest.raises(ValueError, match="unknown surrogate"):
        surrogate.spike(torch.zeros(3), "nope")
