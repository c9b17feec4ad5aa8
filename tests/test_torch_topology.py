"""The port's compressed topology held against the JAX package, on the CPU.

* The six encodings of `tests/test_topology_exec.py` (one per IE type,
  plus pool), built from the same numpy arrays in both packages, have
  equal storage accounting, equal `coo()` triples and bit-for-bit equal
  gather tables (`jj`, `kk`, `act`, `wblk`), and so do their transposes
  (`GatherTables.transpose()`, the gather's backward tables), whose row
  bitmap lists the forward patches' nonzero columns.
* `apply_spikes` and the plain `spikemm_gather` agree with the JAX
  reference (`_ref_impl`, through its registry) and the JAX Pallas kernel
  in interpret mode within the family's `KernelSpec.tol` (1e-4).
* A two-layer program with a `Connection(topology=...)` edge runs through
  the port's `plan.run` and `events.run` and agrees with the JAX
  `plan.run` within `CROSS_ENGINE_ATOL` (1e-5); a params-key topology and
  a skip encoding at delay 2 through `Connection.from_topology` do too;
  `run_stream` equals one-shot exactly; the four validation errors raise
  as in the reference.
* A narrow banded net (the topology benchmark's program at n=512, band 8)
  and a narrow homogeneous DH-SNN on population-packed rasters (the
  block-sparse INTEG path) agree with the JAX package under the
  threshold-tie rule (`tests/_torch_parity.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import events as jevents
from repro.core import plan as jplan
from repro.core import topology as jtopo
from repro.core.neuron import LI as JLI, LIF as JLIF
from repro.core.snn_layers import ff_integrate as jff, \
    make_dhsnn_shd as jmake_dhsnn
from repro.kernels import registry as jreg
from repro_torch.core import events, plan
from repro_torch.core import topology as topo
from repro_torch.core.neuron import LI, LIF
from repro_torch.core.snn_layers import ff_integrate, make_dhsnn_shd
from repro_torch.kernels import registry
from repro_torch.kernels.spikemm.gather import (GatherTables,
                                                build_gather_tables,
                                                spikemm_gather,
                                                spikemm_gather_ref)
from repro_torch.weights import params_from_numpy
from tests._torch_parity import hidden_membrane, max_err_before, tie_rule

ATOL = plan.CROSS_ENGINE_ATOL
MIN_RATE = 0.01
NAMES = ["fc_t2", "sparse_t0", "sparse_t1", "sparse_coo_t1", "conv_t3",
         "pool_t0"]
# the encodings that execute through the gather (every one but type-2 FC)
GATHER_NAMES = NAMES[1:]


def _encodings(mod, rng):
    """One encoding per IE type (+pool), modest but non-block-aligned: the
    reference's test set, built by package `mod` from `rng`'s arrays."""
    dense = rng.standard_normal((37, 29)).astype(np.float32) * 0.3
    sp = dense * (rng.random((37, 29)) < 0.15)
    filt = 0.4 * rng.standard_normal((3, 2, 3, 3)).astype(np.float32)
    pre, post = np.nonzero(rng.random((45, 33)) < 0.08)
    w = 0.5 * rng.standard_normal(len(pre)).astype(np.float32)
    return {
        "fc_t2": mod.encode(dense, kind="fc", n_cores=3),
        "sparse_t0": mod.encode(sp, kind="sparse", ie_type=0),
        "sparse_t1": mod.encode(sp, kind="sparse", ie_type=1),
        "sparse_coo_t1": mod.encode((pre, post, w), kind="sparse_coo",
                                    n_pre=45, n_post=33),
        "conv_t3": mod.encode(filt, kind="conv", h=6, w=5),
        "pool_t0": mod.encode(None, kind="pool", h=6, w=6, c=2, k=2),
    }


@pytest.fixture(scope="module")
def encs():
    """{name: (JAX encoding, port encoding)} from the same arrays."""
    j = _encodings(jtopo, np.random.default_rng(3))
    t = _encodings(topo, np.random.default_rng(3))
    return {k: (j[k], t[k]) for k in NAMES}


def _spikes(shape, rate, seed):
    return (np.random.default_rng(seed).random(shape) < rate
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_encodings_and_tables_equal_reference(encs, name):
    je, te = encs[name]
    assert (te.kind, te.n_pre, te.n_post) == (je.kind, je.n_pre, je.n_post)
    assert te.storage_bits() == je.storage_bits()
    assert te.baseline_bits() == je.baseline_bits()
    np.testing.assert_array_equal(te.dense_equivalent(),
                                  je.dense_equivalent())
    if te.exec_channel() == "dense":
        assert je.exec_channel() == "dense"
        return
    for a, b in zip(te.coo(), je.coo()):
        np.testing.assert_array_equal(a, b)
    for bk, bn in ((None, None), (8, 4)):
        tt, jt = te.lowering(bk, bn), je.lowering(bk, bn)
        for f in ("jj", "kk", "act", "wblk"):
            a, b = getattr(tt, f), getattr(jt, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        assert (tt.n_pre, tt.n_post, tt.bk, tt.bn) == \
            (jt.n_pre, jt.n_post, jt.bk, jt.bn)


@pytest.mark.parametrize("bk,bn", [(None, None), (8, 4)])
@pytest.mark.parametrize("name", GATHER_NAMES)
def test_transposed_tables_equal_reference(encs, name, bk, bn):
    """`GatherTables.transpose()` (the gather's backward, B6): its `jj`,
    `kk`, `act` and `wblk` equal the JAX package's; it is memoised with
    the back-link, and built afresh from its own arrays it transposes back
    to the original's; its `row_bitmap` lists exactly the patch rows that
    are columns of a forward patch holding a nonzero weight of a real
    post neuron."""
    je, te = encs[name]
    t, jt = te.lowering(bk, bn), je.lowering(bk, bn).transpose()
    tt = t.transpose()
    for f in ("jj", "kk", "act", "wblk"):
        a, b = getattr(tt, f), getattr(jt, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (tt.n_pre, tt.n_post, tt.bk, tt.bn) == \
        (jt.n_pre, jt.n_post, jt.bk, jt.bn) == (t.n_post, t.n_pre, t.bn, t.bk)
    assert tt.transpose() is t and t.transpose() is tt
    assert tt.device("cpu") is tt.device("cpu")
    fresh = GatherTables(tt.jj, tt.kk, tt.act, tt.wblk, tt.n_pre,
                         tt.n_post, tt.bk, tt.bn).transpose()
    for f in ("jj", "kk", "act", "wblk"):
        np.testing.assert_array_equal(getattr(fresh, f), getattr(t, f))
    fwd = {(int(j), int(k)): t.wblk[e]
           for e, (j, k) in enumerate(zip(t.jj, t.kk)) if t.act[e]}
    bits = tt.row_bitmap()
    for e in range(len(tt.jj)):
        rows = {r for r in range(tt.bk)
                if bits[e, r // 32] >> (r % 32) & 1}
        want = set()
        if tt.act[e]:
            patch = fwd[(int(tt.kk[e]), int(tt.jj[e]))]       # (bk, bn)
            want = {c for c in range(t.bn) if patch[:, c].any()
                    and int(tt.kk[e]) * tt.bk + c < t.n_post}
        assert rows == want, e


def test_skip_encoding_and_relay_baseline_equal_reference(encs):
    je, te = encs["sparse_t1"]
    js, ts = (jtopo.encode(je, kind="skip", delay=2),
              topo.encode(te, kind="skip", delay=2))
    assert ts.kind == "skip" and ts.meta["base_kind"] == "sparse"
    assert ts.storage_bits() == js.storage_bits()
    assert topo.relay_baseline_bits(te, 2) == jtopo.relay_baseline_bits(je, 2)
    assert [e.delayed for e in ts.fan_out] == [e.delayed for e in js.fan_out]


def test_propagate_equals_dense(encs):
    """The event-driven reference semantics of the port's tables."""
    for name in NAMES:
        _, te = encs[name]
        x = _spikes((te.n_pre,), 0.35, 1)
        np.testing.assert_allclose(te.propagate(x),
                                   x @ te.dense_equivalent(), atol=1e-5,
                                   err_msg=name)


def test_encoding_registry_refuses_duplicates():
    with pytest.raises(ValueError, match="already registered"):
        topo.register_encoding("fc", lambda obj: None)
    with pytest.raises(KeyError, match="unknown encoding"):
        topo.encode(np.zeros((2, 2)), kind="nope")


def test_gather_tables_reject_ghost_indices():
    with pytest.raises(ValueError, match="ghost"):
        build_gather_tables(np.array([0, 99]), np.array([1, 2]),
                            np.ones(2, np.float32), 10, 10, bk=8, bn=8)


def test_gather_duplicate_entries_accumulate():
    t = build_gather_tables(np.array([1, 1]), np.array([2, 2]),
                            np.array([0.25, 0.75], np.float32), 4, 4,
                            bk=4, bn=4)
    x = torch.zeros((1, 4))
    x[0, 1] = 1.0
    assert float(spikemm_gather(x, t)[0, 2]) == 1.0


def test_params_from_numpy_passes_a_topology_through(encs):
    _, te = encs["conv_t3"]
    p = params_from_numpy({"h": {"T": te, "w": np.ones((2, 2), np.float32)}},
                          "cpu")
    assert p["h"]["T"] is te and isinstance(p["h"]["w"], torch.Tensor)


# ---------------------------------------------------------------------------
# kernel level: apply_spikes and the plain gather against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("force_pallas", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_apply_spikes_matches_reference(encs, name, force_pallas):
    je, te = encs[name]
    x = _spikes((9, te.n_pre), 0.35, 11)
    got = te.apply_spikes(torch.from_numpy(x)).numpy()
    if je.exec_channel() == "dense":
        want = np.asarray(jreg.dispatch(
            "spikemm", (jnp.asarray(x), jnp.asarray(je.weights)),
            force_pallas=force_pallas))
    else:
        want = np.asarray(jreg.dispatch(
            "spikemm_gather", (jnp.asarray(x), je.lowering()),
            force_pallas=force_pallas))
    tol = jreg.get("spikemm_gather").tol
    assert registry.get("spikemm_gather").tol == tol
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("force_pallas", [False, True])
@pytest.mark.parametrize("bk,bn", [(128, 128), (8, 4), (16, 32)])
def test_spikemm_gather_matches_reference(bk, bn, force_pallas):
    """The plain gather at the JAX `_make_inputs` shape (96 x 260 -> 200,
    5 % connectivity), at the default and at small ragged blocks."""
    rng = np.random.default_rng(bk * bn)
    pre, post = np.nonzero(rng.random((260, 200)) < 0.05)
    w = rng.standard_normal(len(pre)).astype(np.float32)
    x = _spikes((96, 260), 0.3, bk + bn)
    tt = build_gather_tables(pre, post, w, 260, 200, bk=bk, bn=bn)
    from repro.kernels.spikemm.gather import build_gather_tables as jbuild
    jt = jbuild(pre, post, w, 260, 200, bk=bk, bn=bn)
    want = np.asarray(jreg.dispatch("spikemm_gather", (jnp.asarray(x), jt),
                                    force_pallas=force_pallas))
    got = spikemm_gather(torch.from_numpy(x), tt).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=registry.get("spikemm_gather").tol)


def test_gather_plain_sums_in_the_kernel_order():
    """Each output of the plain gather is the sequential fp32 sum over its
    post block's entries in list order and each entry's rows in
    ascending k, a rounded product then a rounded sum per term: the order
    `csrc/spikemm_gather.cu` sums in."""
    rng = np.random.default_rng(9)
    pre, post = np.nonzero(rng.random((50, 23)) < 0.3)
    w = rng.standard_normal(len(pre)).astype(np.float32)
    t = build_gather_tables(pre, post, w, 50, 23, bk=16, bn=8)
    x = (rng.random((5, 50)) * (rng.random((5, 50)) < 0.5)).astype(
        np.float32)                       # not 0/1: products round too
    got = spikemm_gather_ref(torch.from_numpy(x), t).numpy()
    want = np.zeros((5, 23), np.float32)
    for j in range(-(-23 // 8)):
        for e in np.flatnonzero(t.jj == j):
            if not t.act[e]:
                continue
            for k in range(16):
                p = t.kk[e] * 16 + k
                for c in range(8):
                    q = j * 8 + c
                    if p < 50 and q < 23:
                        want[:, q] = want[:, q] + x[:, p] * t.wblk[e, k, c]
    np.testing.assert_array_equal(got, want)


def test_gather_rows_are_independent():
    """A row's result does not depend on the rows batched with it."""
    rng = np.random.default_rng(2)
    pre, post = np.nonzero(rng.random((70, 40)) < 0.2)
    w = rng.standard_normal(len(pre)).astype(np.float32)
    t = build_gather_tables(pre, post, w, 70, 40, bk=16, bn=16)
    x = torch.from_numpy(_spikes((12, 70), 0.4, 3))
    full = spikemm_gather(x, t)
    for r in (0, 5, 11):
        assert torch.equal(spikemm_gather(x[r:r + 1], t)[0], full[r])


# ---------------------------------------------------------------------------
# program level: Connection(topology=) through both engines
# ---------------------------------------------------------------------------


def _two_layer(conn_j, conn_t, n_post, seed=7):
    """input --edge--> h (LIF) --dense--> ro (LI), JAX and port."""
    w_ro = (0.5 * np.random.default_rng(seed).standard_normal(
        (n_post, 4))).astype(np.float32)
    jn = [jevents.LayerNode("h", JLIF(tau=0.8, v_th=0.6), jff, (conn_j,),
                            n_post),
          jevents.LayerNode("ro", JLI(tau=0.9), jff, ("h",), 4)]
    tn = [events.LayerNode("h", LIF(tau=0.8, v_th=0.6), ff_integrate,
                           (conn_t,), n_post),
          events.LayerNode("ro", LI(tau=0.9), ff_integrate, ("h",), 4)]
    return (jn, {"h": {}, "ro": {"w_h": jnp.asarray(w_ro)}},
            tn, {"h": {}, "ro": {"w_h": torch.from_numpy(w_ro)}})


@pytest.mark.parametrize("name", NAMES)
def test_topology_program_matches_reference_both_engines(encs, name):
    je, te = encs[name]
    jn, jp, tn, tp = _two_layer(jevents.Connection("input", topology=je),
                                events.Connection("input", topology=te),
                                te.n_post)
    assert plan.compile_program(tn).describe() == \
        jplan.compile_program(jn).describe()
    x = _spikes((7, 2, te.n_pre), 0.35, 12)
    _, o_ref, r_ref = jplan.run(jn, jp, jnp.asarray(x), record=("h",))
    for engine in (plan.run, events.run):
        _, o, r = engine(tn, tp, torch.from_numpy(x), record=("h",),
                         device="cpu")
        np.testing.assert_array_equal(r["h"].numpy(), np.asarray(r_ref["h"]))
        np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=0,
                                   atol=ATOL, err_msg=engine.__module__)


def test_topology_by_params_key_and_from_topology(encs):
    """A string topology resolves through params; from_topology lifts the
    skip delay out of meta; a delayed skip edge through both engines
    equals the JAX package's, with the same plan, and `run_stream`
    carries its delay ring across chunks exactly."""
    je, te = encs["sparse_t1"]
    jskip = jtopo.encode(je, kind="skip", delay=2)
    tskip = topo.encode(te, kind="skip", delay=2)
    conn = events.Connection.from_topology("a", tskip)
    assert conn.delay == 2 and conn.topology is tskip
    assert events.Connection.from_topology("a", te).delay == 0
    rng = np.random.default_rng(4)
    w_in = (0.5 * rng.standard_normal((6, te.n_pre))).astype(np.float32)
    w_ro = (0.5 * rng.standard_normal((te.n_post, 4))).astype(np.float32)

    def net(ev, lif, li, ff, edge):
        return [ev.LayerNode("a", lif(tau=0.7, v_th=0.5), ff, ("input",),
                             te.n_pre),
                ev.LayerNode("h", lif(tau=0.8, v_th=0.6), ff, (edge,),
                             te.n_post),
                ev.LayerNode("ro", li(tau=0.9), ff, ("h",), 4)]

    jn = net(jevents, JLIF, JLI, jff,
             jevents.Connection("a", topology="T", delay=2))
    jp = {"a": {"w_input": jnp.asarray(w_in)}, "h": {"T": jskip},
          "ro": {"w_h": jnp.asarray(w_ro)}}
    tn = net(events, LIF, LI, ff_integrate,
             events.Connection("a", topology="T", delay=2))
    tp = params_from_numpy({"a": {"w_input": w_in}, "h": {"T": tskip},
                            "ro": {"w_h": w_ro}}, "cpu")
    x = _spikes((9, 2, 6), 0.35, 5)
    _, o_ref, _ = jplan.run(jn, jp, jnp.asarray(x))
    assert plan.compile_program(tn).describe() == \
        jplan.compile_program(jn).describe()
    for engine in (plan.run, events.run):
        _, o, _ = engine(tn, tp, torch.from_numpy(x), device="cpu")
        np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=0,
                                   atol=ATOL)
    # the delay ring of the skip edge carries across chunk boundaries
    xt = torch.from_numpy(x)
    _, o1, _ = plan.run(tn, tp, xt, device="cpu")
    outs = [o for _, o in plan.run_stream(tn, tp, [xt[:1], xt[1:4], xt[4:]],
                                          device="cpu")]
    assert torch.equal(o1, torch.cat(outs, 0))


def test_topology_connection_validation(encs):
    _, te = encs["sparse_t1"]
    with pytest.raises(ValueError, match="plastic"):
        events.Connection("input", topology=te, plastic=object())
    with pytest.raises(ValueError, match="weight"):
        events.Connection("input", topology=te, weight="w_x")
    with pytest.raises(TypeError, match="topology"):
        events.Connection("input", topology=42)
    with pytest.raises(KeyError, match="no such"):
        events.resolve_topology(events.Connection("input", topology="nope"),
                                "h", {"h": {}})


@pytest.mark.parametrize("name", ["conv_t3", "fc_t2"])
def test_run_stream_equals_one_shot_with_topology(encs, name):
    _, te = encs[name]
    _, _, tn, tp = _two_layer(jevents.Connection("input"),
                              events.Connection("input", topology=te),
                              te.n_post)
    x = torch.from_numpy(_spikes((20, 2, te.n_pre), 0.35, 6))
    st1, o1, _ = plan.run(tn, tp, x, device="cpu")
    outs = [o for _, o in plan.run_stream(
        tn, tp, [x[:6], x[6:7], x[7:15], x[15:]], device="cpu")]
    assert torch.equal(o1, torch.cat(outs, 0))


# ---------------------------------------------------------------------------
# the two card paths, narrow, against the reference
# ---------------------------------------------------------------------------


def _banded(mod, n, band):
    """`bench_topology_exec`'s `_MEM_SCRIPT` net: each neuron reaches its
    +-band neighbours with weight 0.05 (sparse_coo)."""
    rows = np.repeat(np.arange(n), 2 * band + 1)
    cols = rows + np.tile(np.arange(-band, band + 1), n)
    keep = (cols >= 0) & (cols < n)
    w = 0.05 * np.ones(keep.sum(), np.float32)
    return mod.encode((rows[keep], cols[keep], w), kind="sparse_coo",
                      n_pre=n, n_post=n)


def test_banded_net_matches_reference_under_tie_rule():
    """The topology benchmark's program at n=512, band 8: input
    --sparse_coo--> LIF(0.8, 0.6) --0.1--> 8 LI(0.9), Bernoulli(0.2)."""
    n, T = 512, 40
    je, te = _banded(jtopo, n, 8), _banded(topo, n, 8)
    w_h = 0.1 * np.ones((n, 8), np.float32)
    jn = [jevents.LayerNode("hidden", JLIF(tau=0.8, v_th=0.6), jff,
                            (jevents.Connection("input", topology=je),), n),
          jevents.LayerNode("readout", JLI(tau=0.9), jff, ("hidden",), 8)]
    tn = [events.LayerNode("hidden", LIF(tau=0.8, v_th=0.6), ff_integrate,
                           (events.Connection("input", topology=te),), n),
          events.LayerNode("readout", LI(tau=0.9), ff_integrate,
                           ("hidden",), 8)]
    x = _spikes((T, 1, n), 0.2, 0)
    _, o_ref, r_ref = jplan.run(jn, {"hidden": {}, "readout": {
        "w_hidden": jnp.asarray(w_h)}}, jnp.asarray(x), record=("hidden",))
    _, o, r = plan.run(tn, {"hidden": {}, "readout": {
        "w_hidden": torch.from_numpy(w_h)}}, torch.from_numpy(x),
        record=("hidden",), device="cpu")
    s_ref = np.asarray(r_ref["hidden"])
    assert s_ref.mean() >= MIN_RATE
    u, th = hidden_membrane(tn[0], {"w_input": te}, x, s_ref)
    first_div, _ = tie_rule(s_ref, r["hidden"].numpy(), u, th)
    # readouts reach |v| ~ 400 here: CROSS_ENGINE_ATOL relative as well
    err = max_err_before(np.asarray(o_ref) / np.maximum(
        1.0, np.abs(np.asarray(o_ref))), o.numpy() / np.maximum(
        1.0, np.abs(np.asarray(o_ref))), first_div)
    assert err <= ATOL


def _packed(M, K, density, seed, rate=0.5):
    """`spikemm/sparse.py::_packed_raster` with numpy: activity fills a
    dense corner, so block occupancy tracks density."""
    f = min(1.0, float(density / rate) ** 0.5)
    m_act, k_act = max(1, int(M * f)), max(1, int(K * f))
    x = np.zeros((M, K), np.float32)
    x[:m_act, :k_act] = np.random.default_rng(seed).random(
        (m_act, k_act)) < rate
    return x


@pytest.mark.parametrize("density", [0.05, 0.5])
def test_sparse_integ_dhsnn_matches_reference(density, monkeypatch):
    """A narrow homogeneous DH-SNN (256 -> 32 LIF -> 5 LI) on a
    population-packed raster: at 5 % the hoisted INTEG routes sparse, at
    50 % dense; both agree with the JAX package under the tie rule, and
    `never` equals `always` on the port."""
    n_in, T, B = 256, 24, 8
    jn, jp = jmake_dhsnn(jax.random.PRNGKey(0), n_in=n_in, n_hidden=32,
                         n_out=5, dendritic=False)
    tn, _ = make_dhsnn_shd(torch.Generator().manual_seed(0), n_in=n_in,
                           n_hidden=32, n_out=5, dendritic=False,
                           device="cpu")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    x = _packed(T * B, n_in, density, 3).reshape(T, B, n_in)
    from repro_torch.kernels.spikemm.ops import _select_channel
    s2d = torch.from_numpy(x.reshape(T * B, n_in))
    want = "sparse" if density < 0.25 else None
    assert _select_channel(s2d, tp["hidden"]["w_input"])[0] == want
    _, o_ref, r_ref = jplan.run(jn, jp, jnp.asarray(x), record=("hidden",))
    _, o, r = plan.run(tn, tp, torch.from_numpy(x), record=("hidden",),
                       device="cpu")
    s_ref = np.asarray(r_ref["hidden"])
    assert s_ref.mean() >= MIN_RATE
    u, th = hidden_membrane(tn[0], jax.tree_util.tree_map(
        np.asarray, jp)["hidden"], x, s_ref)
    first_div, _ = tie_rule(s_ref, r["hidden"].numpy(), u, th)
    assert max_err_before(np.asarray(o_ref), o.numpy(), first_div) <= ATOL
    runs = {}
    for mode in ("never", "always"):
        monkeypatch.setenv("REPRO_SPIKEMM_SPARSE", mode)
        runs[mode] = plan.run(tn, tp, torch.from_numpy(x),
                              record=("hidden",), device="cpu")
    assert torch.equal(runs["never"][2]["hidden"],
                       runs["always"][2]["hidden"])
    torch.testing.assert_close(runs["never"][1], runs["always"][1],
                               rtol=0, atol=ATOL)
