"""Comparing spike trains across engines: the threshold-tie rule.

Two engines that sum the same currents in another order (a blocked matmul
against another blocking, an associative scan against a sequential fold,
the CPU against the card) agree to ~1e-6 on membranes, not bit for bit.
Where a membrane lands within that distance of the threshold, the two
engines may take different sides of it, and a spike appears in one train
and not in the other. That is not a fault of either engine.

The rule: two spike trains must be identical, except that a (batch,
neuron) lane may differ from the first step where the *reference's*
pre-reset membrane u lies within TIE_MARGIN of the lane's threshold th
(v_th, or ALIF's moving v_th + beta * a_{t-1}). From that step on the lane
has legitimately diverged (its reset differs), and so has every output
downstream of it in that batch row; comparisons of those outputs stop at
the row's first divergence. A lane whose first difference is not at such
a tie fails the check.

In a self-recurrent layer one lane's flip at step t changes every lane of
its row at t+1 through W_rec, and those lanes are not at a tie. For such
a layer the rule is row-wise (`rowwise=True`): a batch row may differ only
from its first differing step, every lane that differs at that step must
be at a tie, and from then on the whole row has diverged.

Gradients extend the rule. A surrogate gradient is a function of the
same pre-reset membrane, and `rectangle`'s is discontinuous at its window
edge |u - th| = alpha / 2 (`triangle`'s kinks at 1 / alpha): where the
reference's u lies within TIE_MARGIN of an edge, two engines may take
different sides of it, and that lane's gradient may differ from that step
back to its first step (the reverse scan carries it), and so may every
gradient summed over it. `surrogate_edges` finds those lane-steps.

`lif_membrane` does the same for a LIF layer given its currents (the BCI
decoder's features), which is not a `LayerNode`.

`hidden_membrane` computes the reference's pre-reset membrane and
threshold itself, in float64 numpy, along the reference's own spike train
(its resets, its adaptation, its recurrent input), so the margin is checked
independently of either engine. It covers the hidden layers of the
paper's models: a feed-forward LIF or ALIF, a DH-LIF, and a self-recurrent
LIF or ALIF.

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
                    spikes_ref: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Pre-reset membrane u and threshold th, each (T, B, N) float64, of a
    hidden node reading "input" (and, if it has one, its own previous
    spikes through "w_self"), from a cold start, resetting and adapting
    where `spikes_ref` (T, B, N) spiked. `params` is the node's parameter
    dict as numpy arrays; `x` the (T, B, n_in) input raster."""
    prog = node.neuron.program
    th = prog.threshold
    nparams = params.get("neuron")
    w = params["w_input"]
    if not hasattr(w, "lowering"):
        w = np.asarray(w, np.float64)
    x = np.asarray(x, np.float64)
    s_ref = np.asarray(spikes_ref, np.float64)
    T, B = x.shape[:2]
    N = node.out_dim
    mem = next(s for s in prog.states if s.name == th.on)
    branch = next((s for s in prog.states if s.branch), None)
    adapt = next((s for s in prog.states if s.name == th.adapt), None)
    self_conn = next((c for c in node.connections if c.src == "self"), None)
    w_self = (None if self_conn is None
              else np.asarray(params[self_conn.weight_key], np.float64))
    tau = _decay(mem.decay, nparams, (N,))
    if branch is not None:
        K = w.shape[0]
        tau_d = _decay(branch.decay, nparams, (K, N))
        w2 = w.transpose(1, 0, 2).reshape(w.shape[1], K * N)
        drive = (x.reshape(T * B, -1) @ w2).reshape(T, B, K, N)
        d = np.zeros((B, K, N))
    else:
        drive = _drive(x.reshape(T * B, -1), w).reshape(T, B, N)
    rho = None if adapt is None else _decay(adapt.decay, nparams, (N,))
    v = np.zeros((B, N))
    a = np.zeros((B, N))
    s_prev = np.zeros((B, N))
    u = np.zeros((T, B, N))
    thr = np.full((T, B, N), float(th.base))
    for t in range(T):
        if branch is not None:
            d = tau_d * d + drive[t]
            cur = d.sum(axis=1)
        else:
            cur = drive[t]
        u[t] = tau * v + cur
        if w_self is not None:
            u[t] += s_prev @ w_self
        if adapt is not None:
            thr[t] = th.base + th.scale * a
        s = s_ref[t]
        v = u[t] - thr[t] * s if prog.reset == "subtract" \
            else u[t] * (1.0 - s)
        if adapt is not None:
            a = rho * a + s
        s_prev = s
    return u, thr


def lif_membrane(current: np.ndarray, tau, spikes_ref: np.ndarray,
                 v_th: float = 1.0, reset: str = "zero") -> np.ndarray:
    """Pre-reset membrane u (T, B, N) float64 of a LIF layer driven by the
    given (T, B, N) currents from a zero membrane, resetting where
    `spikes_ref` spiked: the tie rule's membrane for a layer that is not a
    `LayerNode` (the BCI decoder's, whose currents are its features)."""
    cur = np.asarray(current, np.float64)
    s_ref = np.asarray(spikes_ref, np.float64)
    tau = np.asarray(tau, np.float64)
    v = np.zeros(cur.shape[1:])
    u = np.zeros(cur.shape)
    for t in range(cur.shape[0]):
        u[t] = tau * v + cur[t]
        v = u[t] - v_th * s_ref[t] if reset == "subtract" \
            else u[t] * (1.0 - s_ref[t])
    return u


def _drive(x: np.ndarray, w) -> np.ndarray:
    """x (M, n_in) float64 times the input weight: an array, or a
    compressed topology (anything with `lowering()`), whose block tables
    are contracted in float64 without building its dense matrix."""
    if not hasattr(w, "lowering"):
        return x @ w
    if w.exec_channel() == "dense":
        return x @ np.asarray(w.dense_equivalent(), np.float64)
    t = w.lowering()
    xp = np.zeros((len(x), -(-t.n_pre // t.bk) * t.bk))
    xp[:, :t.n_pre] = x
    out = np.zeros((len(x), -(-t.n_post // t.bn) * t.bn))
    for e in np.flatnonzero(t.act):
        j, k = int(t.jj[e]), int(t.kk[e])
        out[:, j * t.bn:(j + 1) * t.bn] += \
            xp[:, k * t.bk:(k + 1) * t.bk] @ t.wblk[e].astype(np.float64)
    return out[:, :t.n_post]


def is_recurrent(node) -> bool:
    """Whether a node reads its own previous spikes: its spike trains are
    then compared row-wise."""
    return any(c.src == "self" for c in node.connections)


def tie_rule(spikes_ref: np.ndarray, spikes_test: np.ndarray,
             u_ref: np.ndarray, threshold, margin: float = TIE_MARGIN,
             rowwise: bool = False) -> Tuple[np.ndarray, int]:
    """Check two (T, B, N) spike trains under the threshold-tie rule.

    `threshold` is v_th or the reference's (T, B, N) per-step threshold.
    Returns (first divergence step of each batch row, T where none; the
    number of lanes that flipped at a tie: every flipped lane per-lane,
    the lanes of each row's first differing step row-wise). Raises
    AssertionError when a lane's first difference (per-lane) or a lane of
    a row's first differing step (`rowwise`) is not at a tie."""
    s_ref = np.asarray(spikes_ref)
    s_test = np.asarray(spikes_test)
    if s_ref.shape != s_test.shape:
        raise AssertionError(f"spike trains differ in shape: {s_ref.shape} "
                             f"vs {s_test.shape}")
    T, B, _ = s_ref.shape
    th = np.broadcast_to(np.asarray(threshold, np.float64), s_ref.shape)
    diff = s_ref != s_test
    if rowwise:
        rows = np.flatnonzero(diff.any(axis=(0, 2)))
        starts = [(b, int(np.argmax(diff[:, b].any(axis=1)))) for b in rows]
        flips = [(t0, b, n) for b, t0 in starts
                 for n in np.flatnonzero(diff[t0, b])]
    else:
        flips = [(int(np.argmax(diff[:, b, n])), b, n)
                 for b, n in np.argwhere(diff.any(axis=0))]
    first_div = np.full(B, T, np.int64)
    for t0, b, n in flips:
        gap = abs(float(u_ref[t0, b, n]) - float(th[t0, b, n]))
        if gap >= margin:
            raise AssertionError(
                f"spike trains differ at t={t0}, batch {b}, neuron {n}, "
                f"where the reference membrane is {gap:.3e} from threshold "
                f"(not a tie: margin {margin:.0e})")
        first_div[b] = min(first_div[b], t0)
    return first_div, len(flips)


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


def surrogate_edges(u: np.ndarray, threshold, surrogate: str, alpha: float,
                    margin: float = TIE_MARGIN) -> np.ndarray:
    """(T, B, N) bool: where the reference's pre-reset membrane `u` lies
    within `margin` of a window edge of a `rectangle` (|u - th| = alpha/2)
    or `triangle` (|u - th| = 1/alpha) surrogate; all False for the
    smooth ones."""
    if surrogate not in ("rectangle", "triangle"):
        return np.zeros(np.shape(u), bool)
    edge = alpha / 2.0 if surrogate == "rectangle" else 1.0 / alpha
    x = np.abs(np.asarray(u, np.float64)
               - np.asarray(threshold, np.float64))
    return np.abs(x - edge) < margin


__all__ = ["TIE_MARGIN", "hidden_membrane", "lif_membrane", "is_recurrent",
           "tie_rule", "max_err_before", "surrogate_edges"]
