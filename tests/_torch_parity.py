"""Comparing spike trains across engines: the threshold-tie rule.

Two engines that sum the same currents in another order (a blocked matmul
against another blocking, an associative scan against a sequential fold,
the CPU against the card) agree to ~1e-6 on membranes, not bit for bit.
Where a membrane lands within that distance of the threshold, the two
engines may take different sides of it, and a spike appears in one train
and not in the other. That is not a fault of either engine.

The rule: two spike trains must be identical, except that a (batch,
neuron) lane may differ from the first step where the *reference's*
pre-reset membrane u satisfies |u - v_th| < TIE_MARGIN. From that step on
the lane has legitimately diverged (its reset differs), and so has every
output downstream of it in that batch row; comparisons of those outputs
stop at the row's first divergence. A lane whose first difference is not
at such a tie fails the check.

`hidden_membrane` computes the reference's pre-reset membrane itself, in
float64 numpy, along the reference's own spike train (its resets), so the
margin is checked independently of either engine. It covers the two
hidden-layer lowerings of the SHD model: a feed-forward LIF and a DH-LIF.

The tests and `chip_smoke.py` share this helper; it is checking code, so it
lives beside the tests and not in the `repro_torch` package.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

TIE_MARGIN = 1e-5


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-np.asarray(x, np.float64)))


def _decay(decay, nparams, shape) -> np.ndarray:
    p = (nparams or {}).get(decay.param) if decay.kind != "const" else None
    if p is not None:
        return np.broadcast_to(_sigmoid(p), shape)
    return np.full(shape, decay.value, np.float64)


def hidden_membrane(node, params: Dict[str, Any], x: np.ndarray,
                    spikes_ref: np.ndarray) -> np.ndarray:
    """Pre-reset membrane u (T, B, N), float64, of a feed-forward LIF or
    DH-LIF node reading "input", from a cold start, resetting where
    `spikes_ref` (T, B, N) spiked. `params` is the node's parameter dict
    as numpy arrays; `x` the (T, B, n_in) input raster."""
    prog = node.neuron.program
    th = prog.threshold
    nparams = params.get("neuron")
    w = np.asarray(params["w_input"], np.float64)
    x = np.asarray(x, np.float64)
    T, B = x.shape[:2]
    N = node.out_dim
    mem = next(s for s in prog.states if s.name == th.on)
    branch = next((s for s in prog.states if s.branch), None)
    tau = _decay(mem.decay, nparams, (N,))
    if branch is not None:
        K = w.shape[0]
        tau_d = _decay(branch.decay, nparams, (K, N))
        w2 = w.transpose(1, 0, 2).reshape(w.shape[1], K * N)
        drive = (x.reshape(T * B, -1) @ w2).reshape(T, B, K, N)
        d = np.zeros((B, K, N))
    else:
        drive = (x.reshape(T * B, -1) @ w).reshape(T, B, N)
    v = np.zeros((B, N))
    u = np.zeros((T, B, N))
    for t in range(T):
        if branch is not None:
            d = tau_d * d + drive[t]
            cur = d.sum(axis=1)
        else:
            cur = drive[t]
        u[t] = tau * v + cur
        s = spikes_ref[t]
        v = u[t] - th.base * s if prog.reset == "subtract" \
            else u[t] * (1.0 - s)
    return u


def tie_rule(spikes_ref: np.ndarray, spikes_test: np.ndarray,
             u_ref: np.ndarray, v_th: float,
             margin: float = TIE_MARGIN) -> Tuple[np.ndarray, int]:
    """Check two (T, B, N) spike trains under the threshold-tie rule.

    Returns (first divergence step of each batch row, T where none; the
    number of lanes that flipped at a tie). Raises AssertionError when a
    lane's first difference is not at a tie."""
    s_ref = np.asarray(spikes_ref)
    s_test = np.asarray(spikes_test)
    if s_ref.shape != s_test.shape:
        raise AssertionError(f"spike trains differ in shape: {s_ref.shape} "
                             f"vs {s_test.shape}")
    T, B, _ = s_ref.shape
    diff = s_ref != s_test
    lanes = np.argwhere(diff.any(axis=0))             # (n_lanes, 2): b, n
    first_div = np.full(B, T, np.int64)
    for b, n in lanes:
        t0 = int(np.argmax(diff[:, b, n]))
        gap = abs(float(u_ref[t0, b, n]) - v_th)
        if gap >= margin:
            raise AssertionError(
                f"spike trains differ at t={t0}, batch {b}, neuron {n}, "
                f"where the reference membrane is {gap:.3e} from threshold "
                f"(not a tie: margin {margin:.0e})")
        first_div[b] = min(first_div[b], t0)
    return first_div, len(lanes)


def max_err_before(ref: np.ndarray, test: np.ndarray,
                   first_div: np.ndarray) -> float:
    """Max |ref - test| over (T, B, ...) outputs, each batch row only up
    to (not including) its first spike divergence."""
    err = 0.0
    for b, t0 in enumerate(first_div):
        if t0 > 0:
            err = max(err, float(np.max(np.abs(
                np.asarray(ref)[:t0, b] - np.asarray(test)[:t0, b]))))
    return err


__all__ = ["TIE_MARGIN", "hidden_membrane", "tie_rule", "max_err_before"]
