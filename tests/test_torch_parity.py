"""The threshold-tie rule of `tests/_torch_parity.py`, on hand-made cases.

* Per-lane: a lane may differ only from a step where the reference's
  membrane is at a tie; a moving (ALIF) threshold array decides what a
  tie is.
* Row-wise (self-recurrent layers): a row may differ only from its first
  differing step, every lane that differs there must be at a tie, and
  from then on the whole row has diverged. The recurrent case below fails
  the per-lane rule and passes the row-wise one.
* `hidden_membrane` of a recurrent ALIF node recomputes u along the
  reference's spikes, with s_{t-1} @ w_self and the moving threshold.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import events, plan
from repro_torch.core.neuron import ALIF, LIF
from repro_torch.core.snn_layers import ff_integrate
from tests._torch_parity import hidden_membrane, tie_rule

T, B, N = 6, 2, 3


def _recurrent_case():
    """Row 0: lane 0 flips at t=2 at a tie (u = th); through W_rec, lane 1
    then differs at t=3, where its membrane is far from threshold. Row 1
    is identical in both trains."""
    s_ref = np.zeros((T, B, N), np.float32)
    s_ref[[1, 4], 0, 1] = 1.0
    s_test = s_ref.copy()
    s_test[2, 0, 0] = 1.0                     # the flip at the tie
    s_test[3, 0, 1] = 1.0                     # its recurrent consequence
    u = np.full((T, B, N), 0.2)
    u[2, 0, 0] = 1.0 + 2e-6
    return s_ref, s_test, u


def test_per_lane_rule_refuses_the_recurrent_consequence():
    s_ref, s_test, u = _recurrent_case()
    with pytest.raises(AssertionError, match=r"t=3, batch 0, neuron 1"):
        tie_rule(s_ref, s_test, u, 1.0)


def test_rowwise_rule_accepts_the_recurrent_consequence():
    s_ref, s_test, u = _recurrent_case()
    first_div, n_flips = tie_rule(s_ref, s_test, u, 1.0, rowwise=True)
    assert first_div.tolist() == [2, T] and n_flips == 1


def test_rowwise_rule_refuses_a_first_step_lane_off_the_tie():
    """Every lane that differs at a row's first differing step must be at
    a tie, not just one of them."""
    s_ref, s_test, u = _recurrent_case()
    s_test[2, 0, 2] = 1.0                     # u = 0.2 there: no tie
    with pytest.raises(AssertionError, match=r"t=2, batch 0, neuron 2"):
        tie_rule(s_ref, s_test, u, 1.0, rowwise=True)


@pytest.mark.parametrize("rowwise", [False, True])
def test_moving_threshold_decides_the_tie(rowwise):
    """An ALIF lane whose membrane sits at its moving threshold (1.5 here)
    is at a tie; held to the base threshold 1.0 it is not."""
    s_ref = np.zeros((T, B, N), np.float32)
    s_test = s_ref.copy()
    s_test[4, 1, 2] = 1.0
    u = np.zeros((T, B, N))
    u[4, 1, 2] = 1.5
    th = np.ones((T, B, N))
    th[4, 1, 2] = 1.5 + 3e-6
    first_div, n_flips = tie_rule(s_ref, s_test, u, th, rowwise=rowwise)
    assert first_div.tolist() == [T, 4] and n_flips == 1
    with pytest.raises(AssertionError, match="not a tie"):
        tie_rule(s_ref, s_test, u, 1.0, rowwise=rowwise)


@pytest.mark.parametrize("neuron", [LIF(), ALIF(beta=0.5)])
def test_hidden_membrane_of_a_recurrent_layer(neuron):
    """Along the port's own spike train, the recomputed u and th give back
    that train: s_t = [u_t >= th_t] wherever u is off the tie."""
    rng = np.random.default_rng(1)
    n_in, n = 5, 12
    node = events.LayerNode("hidden", neuron, ff_integrate,
                            inputs=("input", "self"), out_dim=n)
    params = {"w_input": rng.standard_normal((n_in, n)).astype(np.float32),
              "w_self": (0.5 * rng.standard_normal((n, n))).astype(
                  np.float32)}
    if isinstance(neuron, ALIF):
        params["neuron"] = {k: v.numpy() for k, v in neuron.param_init(
            torch.Generator().manual_seed(2), (n,)).items()}
    x = (rng.random((40, 3, n_in)) < 0.4).astype(np.float32)
    tparams = {"hidden": {k: (torch.from_numpy(v) if not isinstance(v, dict)
                              else {kk: torch.from_numpy(vv)
                                    for kk, vv in v.items()})
                          for k, v in params.items()}}
    _, _, rec = plan.run([node], tparams, torch.from_numpy(x),
                         record=("hidden",), device="cpu")
    s = rec["hidden"].numpy()
    assert 0.02 < s.mean() < 0.9
    u, th = hidden_membrane(node, params, x, s)
    off_tie = np.abs(u - th) > 1e-5
    np.testing.assert_array_equal((u >= th)[off_tie], s[off_tie] > 0)
    if isinstance(neuron, ALIF):
        assert th.max() > 1.0 + 0.5              # the threshold moved
