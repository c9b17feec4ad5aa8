"""Port kernels held against the JAX package, on the CPU.

For `block_occupancy`, `spikemm`, `linrec`, `lif` (both resets), `lifrec`,
`alif` and `alifrec`, the port's plain version (what `repro_torch`
dispatch runs for CPU tensors) is compared on the same numpy inputs with
  * the JAX reference, through `repro.kernels.registry.dispatch`, which
    picks the XLA reference off-TPU, and
  * the JAX Pallas kernel in interpret mode (`force_pallas=True`).
Shapes: the JAX `_make_inputs` shapes, plus a prime T=37 for the time
kernels; the recurrent and adaptive families start from a nonzero state.
Tolerance: the family's `KernelSpec.tol` (1e-4) in both packages.
`block_occupancy` and `compact_blocks` must match exactly. spikemm's
block-sparse channel is held against the JAX package's sparse reference
and sparse Pallas kernel (interpret mode) at density extremes, and its
router against the threshold and `REPRO_SPIKEMM_SPARSE`; the gather family
is held against the reference in `tests/test_torch_topology.py`.
`stdp` (fp32 and bf16 traces) and `stdp_seq` (the JAX family's ragged
shape, four term planes, and a case that hits the clip) are held to the
JAX reference and the Pallas kernels in interpret mode at their tol 1e-4,
and their plain versions to the kernel's summation order. The recurrent
plain versions take rows wider than 1024 neurons, as the reference does.

The hand CUDA kernels themselves cannot run here (no card, no nvcc);
`chip_smoke.py` holds each one against its plain version on the card.
"""

import dataclasses
import json
import re
import shutil
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import registry as jreg
from repro.kernels.common import pad_axis as jpad
from repro.kernels.spikemm.ops import block_occupancy as jblock_occupancy
from repro.kernels.spikemm.sparse import compact_blocks as jcompact_blocks
from repro_torch.kernels import _build, registry
from repro_torch.kernels.alifrec.ops import (alif_cuda, alif_scan,
                                             alifrec_cuda, alifrec_scan)
from repro_torch.kernels.attention.ops import flash_attention_cuda
from repro_torch.kernels.lif.ops import lif_cuda, lif_scan
from repro_torch.kernels.lifrec.ops import lifrec_cuda, lifrec_scan
from repro_torch.kernels.linrec.ops import linrec, linrec_cuda
from repro_torch.kernels.spikemm import ops as spikemm_ops
from repro_torch.kernels.spikemm import sparse as spikemm_sparse
from repro_torch.kernels.spikemm.gather import (build_gather_tables,
                                                spikemm_gather_cuda)
from repro_torch.kernels.spikemm.ops import (block_occupancy, spikemm,
                                             spikemm_cuda)
from repro_torch.kernels.spikemm.ref import spikemm_chain_ref, spikemm_ref
from repro_torch.kernels.spikemm.sparse import (SPARSE_BLOCK,
                                                compact_blocks, occupancy,
                                                occupancy_cuda,
                                                occupancy_flags,
                                                spikemm_sparse_cuda,
                                                spikemm_sparse_ref)
from repro_torch.kernels.stdp.ops import (stdp_seq, stdp_seq_cuda,
                                          stdp_update, stdp_update_cuda)
from repro_torch.kernels.stdp.ref import outer_sum

IMPLS = [False, True]           # JAX side: reference, Pallas (interpret)


def _tol(name):
    tol = jreg.get(name).tol
    assert registry.get(name).tol == tol
    return tol


def _jax(name, args, force_pallas, **static):
    out = jreg.dispatch(name, tuple(jnp.asarray(a) for a in args),
                        force_pallas=force_pallas, **static)
    return [np.asarray(o) for o in (out if isinstance(out, (tuple, list))
                                    else (out,))]


def _port(fn, args, **static):
    out = fn(*(torch.from_numpy(a) for a in args), **static)
    return [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]


@pytest.mark.parametrize("M,K,bm,bk", [(128, 384, 64, 128), (2048, 704, 64, 16),
                                       (96, 40, 8, 8)])
def test_block_occupancy_matches_reference(M, K, bm, bk):
    rng = np.random.default_rng(M + K)
    s = (rng.random((M, K)) < 0.004).astype(np.float32)
    s[:bm, :] = 0.0                     # a silent row block
    s[:, -bk:] = 0.0                    # a silent k block
    ref = np.asarray(jblock_occupancy(jnp.asarray(s), bm, bk))
    got = block_occupancy(torch.from_numpy(s), bm, bk).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < got.size


def test_block_occupancy_pads_ragged_edges():
    """Ragged (M, K) count as zero-padded, as the JAX wrapper pads them."""
    rng = np.random.default_rng(3)
    s = (rng.random((100, 300)) < 0.002).astype(np.float32)
    sp, _ = jpad(jnp.asarray(s), 0, 64)
    sp, _ = jpad(sp, 1, 16)
    ref = np.asarray(jblock_occupancy(sp, 64, 16))
    got = block_occupancy(torch.from_numpy(s), 64, 16).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("force_pallas", IMPLS)
@pytest.mark.parametrize("M,K,N", [(100, 300, 200), (111, 700, 20)])
def test_spikemm_matches_reference(M, K, N, force_pallas):
    rng = np.random.default_rng(M * K)
    s = (rng.random((M, K)) < 0.13).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    ref, = _jax("spikemm", (s, w), force_pallas)
    got, = _port(spikemm, (s, w))
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol("spikemm"))


@pytest.mark.parametrize("force_pallas", IMPLS)
@pytest.mark.parametrize("M,K,N,p", [(100, 300, 200, 0.13), (111, 700, 20, 0.13),
                                     (37, 65, 6, 0.5), (64, 129, 8, 0.02),
                                     (5, 1, 3, 1.0)])
def test_spikemm_chain_ref_matches_reference(M, K, N, p, force_pallas):
    """The kernel's summation order in plain PyTorch (an ascending-k chain
    of fp32 adds) is the JAX package's spikemm within the family's tol,
    on ragged shapes."""
    rng = np.random.default_rng(M + K + N)
    s = (rng.random((M, K)) < p).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    ref, = _jax("spikemm", (s, w), force_pallas)
    got, = _port(spikemm_chain_ref, (s, w))
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol("spikemm"))


@pytest.mark.parametrize("M,K,N", [(100, 300, 200), (64, 700, 20)])
def test_spikemm_chain_ref_is_the_plain_version_and_row_isolated(M, K, N):
    """`spikemm_chain_ref` matches `spikemm_ref` (the registry's plain
    version) within `_tol("spikemm")`, and each row is the same bits alone
    as packed with other rows: the isolation the kernel keeps."""
    rng = np.random.default_rng(K)
    s = torch.from_numpy((rng.random((M, K)) < 0.1).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32))
    packed = spikemm_chain_ref(s, w)
    torch.testing.assert_close(packed, spikemm_ref(s, w), rtol=0,
                               atol=_tol("spikemm"))
    for i in (0, 1, M // 2, M - 1):
        assert torch.equal(spikemm_chain_ref(s[i:i + 1], w)[0], packed[i])
        assert torch.equal(spikemm_chain_ref(s[i:i + 3], w)[0], packed[i])


@pytest.mark.parametrize("M,N,cw,bm", [
    (2048, 256, 64, 64),      # the SHD window's hidden INTEG
    (2048, 20, 32, 16),       # its readout
    (2048, 64, 64, 16), (2048, 6, 8, 32),    # the ECG window's
    (64, 8, 8, 32),           # the banded readout
    (2048, 512, 64, 128),     # sparse_integ's hidden INTEG
    (1000, 257, 64, 32), (100, 200, 64, 16), (1, 1, 8, 32),
])
def test_spikemm_tile_plan(M, N, cw, bm):
    """The column tile follows N; the rows per CTA are the largest that
    keep about a wave of CTAs on 132 SMs."""
    assert spikemm_ops.col_tile(N) == cw
    assert spikemm_ops.rows_per_cta(M, N, 132) == bm


@pytest.mark.parametrize("M,K,N", [(2048, 700, 256), (64, 8192, 8),
                                   (5, 0, 3)])
def test_spikemm_wrapper_launches_one_kernel_and_nothing_before(
        monkeypatch, M, K, N):
    """With a recording stand-in for the library (no card here) the
    wrapper makes one C call, `spikemm_f32` with the planned tile, counts
    one launch, and runs no occupancy reduction before it."""
    from contextlib import nullcontext
    from unittest import mock

    def refuse(*a, **k):
        raise AssertionError("a reduction before the kernel")
    lib = mock.Mock(**{"spikemm_f32.return_value": 0})
    monkeypatch.setattr(spikemm_ops, "check_matmul", lambda *a: None)
    monkeypatch.setattr(spikemm_ops, "sm_count", lambda dev: 132)
    monkeypatch.setattr(spikemm_ops, "block_occupancy", refuse)
    monkeypatch.setattr(spikemm_ops, "occupancy", refuse)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    registry.reset_launches()
    spikemm_cuda(torch.zeros((M, K)), torch.zeros((K, N)))
    assert [c[0] for c in lib.method_calls] == ["spikemm_f32"]
    assert lib.spikemm_f32.call_args.args[3:8] == (
        M, K, N, spikemm_ops.rows_per_cta(M, N, 132),
        spikemm_ops.col_tile(N))
    assert registry.launch_counts()["spikemm"] == 1
    registry.reset_launches()


@pytest.mark.parametrize("symbol", ["spikemm_block_m", "spikemm_block_k",
                                    "kernel_block_shape"])
def test_spikemm_block_shape_symbols_are_gone(symbol):
    """The kernel measures occupancy itself: no block-shape symbol is left
    in the library's signatures, the kernel source or the wrapper."""
    assert symbol not in _build.SIGNATURES
    assert symbol not in (_build.CSRC / "spikemm.cu").read_text()
    assert not hasattr(spikemm_ops, symbol)


@pytest.mark.parametrize("force_pallas", IMPLS)
@pytest.mark.parametrize("T,B,D", [(24, 3, 136), (37, 3, 136)])
def test_linrec_matches_reference(T, B, D, force_pallas):
    rng = np.random.default_rng(T * D)
    a = rng.uniform(0.5, 0.99, (T, B, D)).astype(np.float32)
    x = rng.standard_normal((T, B, D)).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    ref = _jax("linrec", (a, x, h0), force_pallas)
    got = _port(linrec, (a, x, h0))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=_tol("linrec"))


@pytest.mark.parametrize("force_pallas", IMPLS)
@pytest.mark.parametrize("decay", ["per_neuron", "full_plane"])
def test_linrec_matches_reference_at_the_trace_shape(decay, force_pallas):
    """plastic_ff's trace scans, T = 300, B = 8, D = 256 on spike input:
    the plain version against the reference and the Pallas kernel
    (interpret mode) at the family's tol, with a per-neuron decay that the
    port takes as a stride-0 view (the JAX side takes it materialised) and
    with a full decay plane."""
    T, B, D = 300, 8, 256
    rng = np.random.default_rng(22)
    x = (rng.random((T, B, D)) < 0.15).astype(np.float32)
    h0 = rng.random((B, D)).astype(np.float32)
    if decay == "per_neuron":
        a_d = rng.uniform(0.8, 0.99, (D,)).astype(np.float32)
        a = np.ascontiguousarray(np.broadcast_to(a_d, (T, B, D)))
        a_port = torch.from_numpy(a_d).expand(T, B, D)
        assert a_port.stride() == (0, 0, 1)
    else:
        a = rng.uniform(0.8, 0.99, (T, B, D)).astype(np.float32)
        a_port = torch.from_numpy(a)
    ref = _jax("linrec", (a, x, h0), force_pallas)
    got = linrec(a_port, torch.from_numpy(x), torch.from_numpy(h0))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=_tol("linrec"))


@pytest.mark.parametrize("T", [1, 7, 32, 300])
@pytest.mark.parametrize("lanes", [1, 6 * 64, 20 * 64, 1024, 2048, 16384])
def test_linrec_lane_plan(lanes, T):
    """`lane_plan`: one to four warps a CTA, the fewest that keep the CTAs
    within one an SM of 132 (2048 lanes on 64 SMs, 16384 on 128); no CTA
    without a lane and every lane covered exactly once; the ring's stages
    are LANE_SCAN_STAGES or the chunks T has, within the shared memory a
    CTA may take with a decay plane staged too. It lives in
    `kernels/common.py` (`linrec`, `lif` and `alif` share it) and stays
    importable from `linrec/ops.py`."""
    from repro_torch.kernels import common
    from repro_torch.kernels.linrec.ops import MAX_WARPS, lane_plan
    assert (lane_plan, MAX_WARPS) == (common.lane_plan, common.MAX_WARPS)
    warps, ctas, stages = lane_plan(lanes, T, 132)
    threads = 32 * warps
    assert warps in (1, 2, 4) and warps <= MAX_WARPS
    assert (ctas - 1) * threads < lanes <= ctas * threads
    owner = np.arange(ctas * threads)
    assert np.array_equal(owner[owner < lanes], np.arange(lanes))
    assert ctas <= 132 or warps == MAX_WARPS
    if warps > 1:                       # half the warps would overfill
        assert -(-lanes // (16 * warps)) > 132
    chunk, ring = _build.LANE_SCAN_CHUNK, _build.LANE_SCAN_STAGES
    assert stages == min(ring, -(-T // chunk)) >= 1
    assert threads * 2 * stages * chunk * 4 <= 232448
    assert {2048: (1, 64), 16384: (4, 128)}.get(lanes, (warps, ctas)) == (
        warps, ctas)


@pytest.mark.parametrize("T", [1, 37, 2 * _build.LANE_BWD_SEG + 5])
def test_linrec_bwd_ref_sums_a_per_neuron_decay(T):
    """`linrec_bwd_ref` with a (D,) decay returns g_a of shape (D,): each
    lane's gx_t y_{t-1} summed in descending t from +0, then over B in
    ascending b (`csrc/linrec_bwd.cu`'s order), bit for bit that loop; and
    within the family's tol of `jax.vjp` of the JAX `linrec` over the
    broadcast decay. g_x and g_h0 are those of the (T, B, D) view of the
    same decay, bit for bit."""
    import jax
    from repro.kernels.linrec.ops import linrec as jlinrec
    from repro_torch.kernels.linrec.ref import linrec_bwd_ref
    rng = np.random.default_rng(T + 1)
    B, D = 3, 136
    a = rng.uniform(0.5, 0.99, D).astype(np.float32)
    x = rng.standard_normal((T, B, D)).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    gy = rng.standard_normal((T, B, D)).astype(np.float32)
    ghT = rng.standard_normal((B, D)).astype(np.float32)
    at, ht = torch.from_numpy(a), torch.from_numpy(h0)
    y, _ = linrec(at, torch.from_numpy(x), ht)
    g_a, g_x, g_h0 = linrec_bwd_ref(at, y, ht, torch.from_numpy(gy),
                                    torch.from_numpy(ghT))
    assert g_a.shape == (D,)
    y_prev = torch.cat([ht[None], y[:-1]])
    acc = torch.zeros(B, D)
    for t in range(T - 1, -1, -1):
        acc = acc + g_x[t] * y_prev[t]
    want = acc[0]
    for b in range(1, B):
        want = want + acc[b]
    assert torch.equal(g_a.view(torch.int32), want.view(torch.int32))
    full = linrec_bwd_ref(at.expand(T, B, D), y, ht, torch.from_numpy(gy),
                          torch.from_numpy(ghT))
    assert full[0].shape == (T, B, D)
    assert torch.equal(full[1], g_x) and torch.equal(full[2], g_h0)
    _, vjp = jax.vjp(
        lambda a_, x_, h_: jlinrec(jnp.broadcast_to(a_, (T, B, D)), x_, h_),
        jnp.asarray(a), jnp.asarray(x), jnp.asarray(h0))
    for got, ref in zip((g_a, g_x, g_h0),
                        vjp((jnp.asarray(gy), jnp.asarray(ghT)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=_tol("linrec"), atol=_tol("linrec"))


def test_linrec_wrapper_passes_the_plan(monkeypatch):
    """With a recording stand-in for the library (no card here) the
    wrapper hands `linrec_f32` the decay's strides (0 where broadcast) and
    `lane_plan`'s warps and stages, and counts one launch."""
    from contextlib import nullcontext
    from unittest import mock
    from repro_torch.kernels.linrec import ops as linrec_ops
    lib = mock.Mock(**{"linrec_f32.return_value": 0})
    monkeypatch.setattr(linrec_ops, "_check", lambda *a: None)
    monkeypatch.setattr(linrec_ops, "sm_count", lambda dev: 132)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    T, B, D = 300, 8, 256
    registry.reset_launches()
    linrec_cuda(torch.ones(D).expand(T, B, D), torch.zeros((T, B, D)),
                torch.zeros((B, D)))
    call, = lib.linrec_f32.call_args_list
    assert call.args[1:4] == (0, 0, 1)
    assert call.args[8:13] == (T, B, D) + tuple(
        linrec_ops.lane_plan(B * D, T, 132)[i] for i in (0, 2))
    assert registry.launch_counts()["linrec"] == 1
    registry.reset_launches()


@pytest.mark.parametrize("name,reset,shape", [
    ("lif", "zero", (300, 8, 128)), ("lif", "subtract", (300, 8, 128)),
    ("alif", None, (250, 64, 64))])
def test_lane_scan_wrappers_pass_the_plan(monkeypatch, name, reset, shape):
    """With a recording stand-in for the library (no card here) the `lif`
    and `alif` wrappers hand `lif_f32`/`alif_f32` the shape, the reset and
    `lane_plan`'s warps and stages, at plastic_ff's hidden layer
    (300, 8, 128; both resets) and alif_ff's (250, 64, 64), and count one
    launch."""
    from contextlib import nullcontext
    from unittest import mock
    from repro_torch.kernels import common
    from repro_torch.kernels.alifrec import ops as alif_ops
    from repro_torch.kernels.lif import ops as lif_ops
    ops = lif_ops if name == "lif" else alif_ops
    lib = mock.Mock(**{f"{name}_f32.return_value": 0})
    monkeypatch.setattr(ops, "check_scan", lambda *a: None)
    monkeypatch.setattr(ops, "sm_count", lambda dev: 132)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    T, B, N = shape
    cur, lane = torch.zeros(shape), torch.zeros((B, N))
    registry.reset_launches()
    if name == "lif":
        lif_cuda(cur, torch.ones(N), lane, 0.5, reset)
    else:
        alif_cuda(cur, torch.ones(N), torch.ones(N), lane, lane, 0.5, 1.8)
    call, = getattr(lib, f"{name}_f32").call_args_list
    warps, ctas, stages = common.lane_plan(B * N, T, 132)
    assert (warps, ctas) == {1024: (1, 32), 4096: (1, 128)}[B * N]
    assert stages == _build.LANE_SCAN_STAGES
    if name == "lif":
        assert call.args[5:12] == (T, B, N, 0.5, int(reset == "subtract"),
                                   warps, stages)
    else:
        assert call.args[8:15] == (T, B, N, 0.5, 1.8, warps, stages)
    assert registry.launch_counts()[name] == 1
    registry.reset_launches()


def _density_rasters(M, K, seed):
    """The JAX sparse tests' extremes: all-empty, one occupied block, a
    packed low-density corner, and dense."""
    rng = np.random.default_rng(seed)
    single = np.zeros((M, K), np.float32)
    single[1, 2] = 1.0
    packed = np.zeros((M, K), np.float32)
    m, k = max(1, M // 8), max(1, K // 8)
    packed[:m, :k] = rng.random((m, k)) < 0.5
    return {"all_empty": np.zeros((M, K), np.float32),
            "single_block": single, "packed_2pct": packed,
            "dense": (rng.random((M, K)) < 0.5).astype(np.float32)}


@pytest.mark.parametrize("M,K,N", [(256, 1024, 256), (100, 300, 200),
                                   (130, 700, 64)])
def test_spikemm_sparse_matches_reference(M, K, N):
    """The sparse channel's plain version against the JAX package's
    sparse reference and its sparse Pallas kernel (interpret mode), at the
    shapes of the JAX sparse tests and their density extremes."""
    from repro.kernels.spikemm.ops import (_sparse_pallas_impl,
                                           _sparse_ref_impl,
                                           resolve_block_shape)
    blocks = resolve_block_shape(M, K)
    blocks["bn"] = min(512, max(128, N))
    w = np.random.default_rng(1).standard_normal((K, N)).astype(np.float32)
    tol = _tol("spikemm")
    for label, s in _density_rasters(M, K, M + K).items():
        got = spikemm_sparse_ref(torch.from_numpy(s),
                                 torch.from_numpy(w)).numpy()
        for ref in (_sparse_ref_impl(jnp.asarray(s), jnp.asarray(w),
                                     blocks=blocks),
                    _sparse_pallas_impl(jnp.asarray(s), jnp.asarray(w),
                                        blocks=blocks, interpret=True)):
            np.testing.assert_allclose(got, np.asarray(ref), rtol=0,
                                       atol=tol, err_msg=label)


@pytest.mark.parametrize("Mb,Kb,p", [(4, 6, 0.3), (5, 3, 0.0), (3, 7, 1.0),
                                     (6, 5, 0.15)])
def test_compact_blocks_matches_reference(Mb, Kb, p):
    rng = np.random.default_rng(Mb * Kb)
    flags = (rng.random((Mb, Kb)) < p).astype(np.int32)
    flags[min(1, Mb - 1)] = 0                  # a silent row block
    ref = [np.asarray(a) for a in jcompact_blocks(jnp.asarray(flags))]
    got = [a.numpy() for a in compact_blocks(torch.from_numpy(flags))]
    for g, r in zip(got, ref):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, r)


def test_sparse_block_shape_is_the_kernels(tmp_path, monkeypatch):
    """The sparse kernel is compiled at `SPARSE_BLOCK`, the block shape the
    wrapper, the router and the plain version measure occupancy at: the
    one nvcc call passes it as -D flags, and the source takes its BM and
    SBK from them and no other value."""
    nvcc, calls = _fake_nvcc(tmp_path, 0)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    _build.build()
    argv, = [a for a in (json.loads(line) for line in
                         calls.read_text().splitlines())
             if str(_build.CSRC / "spikemm_sparse.cu") in a]
    bm, bk = SPARSE_BLOCK
    assert f"-DSPIKEMM_SPARSE_BM={bm}" in argv
    assert f"-DSPIKEMM_SPARSE_BK={bk}" in argv
    src = (_build.CSRC / "spikemm_sparse.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\w+);", src))
    assert (consts["BM"], consts["SBK"]) == ("SPIKEMM_SPARSE_BM",
                                             "SPIKEMM_SPARSE_BK")
    half = torch.zeros(bm, 2 * bk)
    half[:, :bk] = 1.0
    assert spikemm_ops.occupancy_fraction(half) == 0.5


def _block_raster(M, K, n_blocks, seed):
    """A raster with exactly `n_blocks` occupied blocks of the sparse
    kernel's (bm, bk), each holding a single spike."""
    bm, bk = SPARSE_BLOCK
    s = np.zeros((M, K), np.float32)
    cells = np.random.default_rng(seed).permutation(
        (M // bm) * (K // bk))[:n_blocks]
    for c in cells:
        i, k = divmod(int(c), K // bk)
        s[i * bm, k * bk] = 1.0
    return torch.from_numpy(s)


def test_router_at_below_and_above_the_threshold(monkeypatch):
    """`auto` routes sparse at and below 0.25 of the blocks occupied and
    dense above; `never`/`always` pin; `_traced` routes `auto` dense."""
    monkeypatch.delenv("REPRO_SPIKEMM_SPARSE", raising=False)
    w = torch.ones(512, 8)
    route = registry.get("spikemm").select_channel
    assert spikemm_ops.sparse_threshold() == 0.25
    for n, want in ((15, "sparse"), (16, "sparse"), (17, None)):
        s = _block_raster(512, 512, n, n)       # 64 blocks in all
        assert spikemm_ops.occupancy_fraction(s) == n / 64
        choice, measured = route(s, w)
        assert choice == want, n
        # the sparse channel gets the flags the router measured
        if want == "sparse":
            assert torch.equal(measured.pop("flags"), occupancy_flags(s))
        assert measured == {}
        assert route(s, w, traced=True) == (None, {})
    s = _block_raster(512, 512, 60, 0)
    monkeypatch.setenv("REPRO_SPIKEMM_SPARSE", "always")
    assert route(s, w) == ("sparse", {})
    assert route(s, w, traced=True) == ("sparse", {})
    monkeypatch.setenv("REPRO_SPIKEMM_SPARSE", "never")
    assert route(_block_raster(512, 512, 1, 0), w) == (None, {})


def _occupancy_rasters():
    """Rasters for the occupancy at SPARSE_BLOCK: all silent, all
    occupied, ragged M and K, and Kb > 64 (a CTA's list spans several
    ballot words)."""
    rng = np.random.default_rng(12)
    full = np.zeros((192, 256), np.float32)
    full[::64, ::64] = 1.0                      # one spike in every block
    wide = np.zeros((130, 64 * 130 + 5), np.float32)
    wide[:, rng.permutation(wide.shape[1])[:90]] = 1.0
    return {"all_silent": np.zeros((128, 320), np.float32),
            "all_occupied": full,
            "ragged": (rng.random((100, 300)) < 0.002).astype(np.float32),
            "kb_over_64": wide}


@pytest.mark.parametrize("label", sorted(_occupancy_rasters()))
def test_block_occupancy_at_the_sparse_block_matches_reference(label):
    """`block_occupancy` at SPARSE_BLOCK (what the occupancy kernel
    computes, held to it on the card) against the JAX `block_occupancy`
    on the zero-padded raster, and `occupancy` on the CPU gives those
    flags and their count."""
    bm, bk = SPARSE_BLOCK
    s = _occupancy_rasters()[label]
    sp, _ = jpad(jnp.asarray(s), 0, bm)
    sp, _ = jpad(sp, 1, bk)
    ref = np.asarray(jblock_occupancy(sp, bm, bk))
    flags, total = occupancy(torch.from_numpy(s))
    np.testing.assert_array_equal(flags.numpy(), ref)
    assert total.dtype == torch.int32 and total.shape == (1,)
    assert int(total) == int(ref.sum())
    assert torch.equal(occupancy_flags(torch.from_numpy(s)), flags)


@pytest.mark.parametrize("Mb,Kb,p", [(3, 65, 0.2), (4, 130, 0.05),
                                     (2, 1100, 0.01), (5, 96, 1.0)])
def test_compact_blocks_rows_match_reference(Mb, Kb, p):
    """Row by row, the occupied k blocks in ascending k (the list a CTA of
    the product builds for its block row, by ballot and popc) and the
    sentinel of a silent row, against the JAX `compact_blocks`, with rows
    whose lists span several 32-bit ballot words."""
    rng = np.random.default_rng(Mb * Kb)
    flags = (rng.random((Mb, Kb)) < p).astype(np.int32)
    flags[1] = 0                                # a silent row block
    ref = [np.asarray(a) for a in jcompact_blocks(jnp.asarray(flags))]
    got = [a.numpy() for a in compact_blocks(torch.from_numpy(flags))]
    for i in range(Mb):
        rows = [(ii == i) for ii in (got[0], ref[0])]
        for g, r in zip(got[1:], ref[1:]):
            np.testing.assert_array_equal(g[rows[0]], r[rows[1]])
        listed = got[1][rows[0] & (got[2] == 1)]
        np.testing.assert_array_equal(listed, np.flatnonzero(flags[i]))
        if not flags[i].any():
            assert got[2][rows[0]].tolist() == [0]       # the sentinel


@pytest.mark.parametrize("M,N,tile", [(2048, 512, 64), (2048, 20, 16),
                                      (128, 64, 16), (100, 200, 16),
                                      (8448, 64, 64)])
def test_sparse_tile_plan(M, N, tile):
    """The product's tile: 64 where the output holds a 64 x 64 tile for
    each of 132 SMs, else 16."""
    assert spikemm_sparse.sparse_tile(M, N, 132) == tile
    assert tile in spikemm_sparse.SPARSE_TILES


def _stand_in(monkeypatch, lib):
    """CPU tensors through the CUDA wrappers: `lib` for the library, the
    device checks and the stream stood in for, no host read allowed."""
    from contextlib import nullcontext

    def refuse(*a, **k):
        raise AssertionError("a host read or a host-side compaction")
    monkeypatch.setattr(spikemm_sparse, "check_matmul", lambda *a: None)
    monkeypatch.setattr(spikemm_sparse, "check_raster", lambda *a: None)
    monkeypatch.setattr(spikemm_sparse, "sm_count", lambda dev: 132)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    for mod, name in ((torch, "nonzero"), (torch, "searchsorted"),
                      (torch.Tensor, "nonzero"), (torch.Tensor, "item"),
                      (torch.Tensor, "tolist"), (torch.Tensor, "cpu")):
        monkeypatch.setattr(mod, name, refuse)


@pytest.mark.parametrize("M,K,N", [(2048, 4096, 512), (2048, 512, 20),
                                   (128, 8192, 64), (5, 0, 3)])
@pytest.mark.parametrize("flags_given", [False, True])
def test_sparse_wrapper_is_two_launches_and_no_host_read(monkeypatch, M, K,
                                                         N, flags_given):
    """With a recording stand-in for the library, `spikemm_sparse_cuda`
    calls the occupancy kernel and then the product on the flags it wrote
    (only the product when flags are handed in), on `sparse_tile`'s tile;
    it calls no nonzero, searchsorted or item, and counts one launch."""
    from unittest import mock
    bm, bk = SPARSE_BLOCK
    flags = torch.zeros((-(-M // bm), -(-K // bk)), dtype=torch.int32)
    lib = mock.Mock(**{"spikemm_occupancy_f32.return_value": 0,
                       "spikemm_sparse_f32.return_value": 0})
    registry.reset_launches()
    spikemm_sparse.occupancy_cuda.launches = 0
    _stand_in(monkeypatch, lib)
    out = spikemm_sparse_cuda(torch.zeros((M, K)), torch.zeros((K, N)),
                              flags if flags_given else None)
    assert out.shape == (M, N)
    calls = [c[0] for c in lib.method_calls]
    product = lib.spikemm_sparse_f32.call_args.args
    assert product[4:8] == (M, K, N, spikemm_sparse.sparse_tile(M, N, 132))
    if flags_given:
        assert calls == ["spikemm_sparse_f32"]
        assert product[2] == flags.data_ptr()
    else:
        assert calls == ["spikemm_occupancy_f32", "spikemm_sparse_f32"]
        occ = lib.spikemm_occupancy_f32.call_args.args
        assert occ[3:5] == (M, K)
        assert product[2] == occ[1]       # the flags the occupancy wrote
    assert registry.launch_counts()["spikemm_sparse"] == 1
    assert spikemm_sparse.occupancy_cuda.launches == int(not flags_given)
    registry.reset_launches()
    spikemm_sparse.occupancy_cuda.launches = 0


def test_sparse_wrapper_refuses_flags_it_cannot_take(monkeypatch):
    """Handed-in flags must be the raster's (Mb, Kb) contiguous int32."""
    from unittest import mock
    _stand_in(monkeypatch, mock.Mock())
    s, w = torch.zeros((130, 70)), torch.zeros((70, 8))
    for bad in (torch.zeros((3, 2), dtype=torch.int64),
                torch.zeros((2, 2), dtype=torch.int32),
                torch.zeros((2, 6), dtype=torch.int32)[:, ::2]):
        with pytest.raises(ValueError, match="flags must be"):
            spikemm_sparse_cuda(s, w, bad)


def _fake_occupancy(total_shift=0):
    """A library stand-in whose occupancy kernel reads the raster through
    its pointer and writes `block_occupancy` and its count (plus
    `total_shift`) through theirs, as the kernel does on the card."""
    import ctypes

    def at(ptr, n, ct):
        return np.ctypeslib.as_array((ct * max(n, 1)).from_address(ptr))[:n]

    def occupancy_f32(s, flags, total, M, K, stream):
        x = torch.from_numpy(at(s, M * K, ctypes.c_float).reshape(M, K))
        f = block_occupancy(x, *SPARSE_BLOCK).numpy()
        at(flags, f.size, ctypes.c_int32)[:] = f.ravel()
        at(total, 1, ctypes.c_int32)[:] = f.sum() + total_shift
        return 0
    return type("Lib", (), {"spikemm_occupancy_f32":
                            staticmethod(occupancy_f32)})()


@pytest.mark.parametrize("n,want", [(15, "sparse"), (16, "sparse"),
                                    (17, None)])
def test_router_decides_from_the_kernels_total_with_one_read(monkeypatch, n,
                                                             want):
    """On the card `auto` launches the occupancy kernel and reads its
    4-byte total once: it routes as `occupancy_fraction <= 0.25` does at
    15, 16 and 17 of 64 blocks, hands the kernel's flags to the sparse
    channel, and follows the total (a total one block higher routes as
    one more block would)."""
    monkeypatch.delenv("REPRO_SPIKEMM_SPARSE", raising=False)
    s = _block_raster(512, 512, n, n)
    w = torch.ones(512, 8)
    assert (spikemm_ops.occupancy_fraction(s) <= 0.25) == (want is not None)
    route = registry.get("spikemm").select_channel
    real_item = torch.Tensor.item
    reads = []

    def item(self):
        reads.append(tuple(self.shape))
        return real_item(self)
    for shift, expect in ((0, want), (1, "sparse" if n < 16 else None)):
        _stand_in(monkeypatch, _fake_occupancy(shift))
        monkeypatch.setattr(spikemm_sparse, "on_cuda", lambda args: True)
        monkeypatch.setattr(torch.Tensor, "item", item)
        reads.clear()
        spikemm_sparse.occupancy_cuda.launches = 0
        choice, measured = route(s, w)
        assert reads == [(1,)]                   # the total, once
        assert spikemm_sparse.occupancy_cuda.launches == 1
        assert choice == expect, (n, shift)
        if expect == "sparse":
            assert torch.equal(measured.pop("flags"),
                               block_occupancy(s, *SPARSE_BLOCK))
        assert measured == {}
        monkeypatch.undo()
        monkeypatch.delenv("REPRO_SPIKEMM_SPARSE", raising=False)
    spikemm_sparse.occupancy_cuda.launches = 0


def test_sparse_env_refuses_a_bad_value(monkeypatch):
    monkeypatch.setenv("REPRO_SPIKEMM_SPARSE", "sometimes")
    with pytest.raises(ValueError, match="expected 'never', 'auto', or "
                                         "'always'"):
        spikemm(torch.zeros(4, 3), torch.zeros(3, 2))


def test_dispatch_runs_the_routed_channel(monkeypatch):
    """On CPU tensors, `always` runs the sparse channel's plain version and
    `never` the dense one; `auto` on a sparse raster runs the sparse one
    with the router's flags. All equal the matmul."""
    rng = np.random.default_rng(6)
    s = torch.from_numpy(_density_rasters(200, 300, 6)["packed_2pct"])
    w = torch.from_numpy(rng.standard_normal((300, 40)).astype(np.float32))
    calls = []
    spec = registry.get("spikemm")

    def plain(*args, **kw):
        calls.append(sorted(kw))
        return spikemm_sparse_ref(*args, **kw)

    chan = registry.Channel(plain=plain, cuda=spikemm_sparse_cuda)
    monkeypatch.setitem(registry._REGISTRY, "spikemm", dataclasses.replace(
        spec, channels={"sparse": chan}))
    for mode in ("always", "never", "auto"):
        monkeypatch.setenv("REPRO_SPIKEMM_SPARSE", mode)
        torch.testing.assert_close(spikemm(s, w), s @ w, rtol=0, atol=1e-5)
    assert calls == [[], ["flags"]]


def test_linrec_broadcast_decay_equals_full_plane():
    """A (D,) decay broadcast over T and B gives exactly the result of the
    materialised (T, B, D) plane (the plan passes the broadcast view)."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.uniform(0.5, 0.99, (64,)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((37, 3, 64)).astype(np.float32))
    h0 = torch.zeros(3, 64)
    y1, h1 = linrec(a.expand(x.shape), x, h0)
    y2, h2 = linrec(a.expand(x.shape).contiguous(), x, h0)
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


@pytest.mark.parametrize("reset", ["zero", "subtract"])
@pytest.mark.parametrize("force_pallas", IMPLS)
@pytest.mark.parametrize("T,B,N", [(20, 3, 130), (37, 3, 130)])
def test_lif_matches_reference(T, B, N, force_pallas, reset):
    rng = np.random.default_rng(T * N)
    cur = (0.6 * rng.standard_normal((T, B, N))).astype(np.float32)
    tau = rng.uniform(0.7, 0.98, (N,)).astype(np.float32)
    v0 = np.zeros((B, N), np.float32)
    ref = _jax("lif", (cur, tau, v0), force_pallas, v_th=1.0, reset=reset)
    got = _port(lif_scan, (cur, tau, v0), v_th=1.0, reset=reset)
    assert got[0].sum() > 0, "no spikes: the comparison would be vacuous"
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=_tol("lif"))


def _state(rng, B, N):
    """A nonzero (v0, a0, s0): membranes below threshold, adaptation
    traces of a few past spikes, 0/1 spikes of the step before."""
    v0 = rng.uniform(-0.5, 0.9, (B, N)).astype(np.float32)
    a0 = rng.uniform(0.0, 2.0, (B, N)).astype(np.float32)
    s0 = (rng.random((B, N)) < 0.3).astype(np.float32)
    return v0, a0, s0


def _scan_inputs(T, B, N, seed):
    rng = np.random.default_rng(seed)
    cur = (0.8 * rng.standard_normal((T, B, N))).astype(np.float32)
    w_rec = (0.4 / np.sqrt(N) * rng.standard_normal((N, N))).astype(
        np.float32)
    tau = rng.uniform(0.7, 0.98, (N,)).astype(np.float32)
    rho = rng.uniform(0.85, 0.99, (N,)).astype(np.float32)
    return (cur, w_rec, tau, rho) + _state(rng, B, N)


def _assert_spiking_outputs_close(got, ref, name):
    assert got[0].sum() > 0, "no spikes: the comparison would be vacuous"
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=_tol(name))


@pytest.mark.parametrize("force_pallas", IMPLS)
@pytest.mark.parametrize("T,B,N", [(20, 3, 70), (37, 3, 70)])
def test_lifrec_matches_reference(T, B, N, force_pallas):
    cur, w_rec, tau, _, v0, _, s0 = _scan_inputs(T, B, N, T * N)
    args = (cur, w_rec, tau, v0, s0)
    ref = _jax("lifrec", args, force_pallas, v_th=1.0)
    got = _port(lifrec_scan, args, v_th=1.0)
    _assert_spiking_outputs_close(got, ref, "lifrec")


@pytest.mark.parametrize("force_pallas", IMPLS)
@pytest.mark.parametrize("T,B,N", [(20, 3, 130), (37, 3, 70)])
def test_alif_matches_reference(T, B, N, force_pallas):
    cur, _, tau, rho, v0, a0, _ = _scan_inputs(T, B, N, T * N + 1)
    args = (cur, tau, rho, v0, a0)
    ref = _jax("alif", args, force_pallas, v_th=1.0, beta=1.8)
    got = _port(alif_scan, args, v_th=1.0, beta=1.8)
    _assert_spiking_outputs_close(got, ref, "alif")


@pytest.mark.parametrize("force_pallas", IMPLS)
@pytest.mark.parametrize("T,B,N", [(20, 3, 70), (37, 3, 70)])
def test_alifrec_matches_reference(T, B, N, force_pallas):
    cur, w_rec, tau, rho, v0, a0, s0 = _scan_inputs(T, B, N, T * N + 2)
    args = (cur, w_rec, tau, rho, v0, a0, s0)
    ref = _jax("alifrec", args, force_pallas, v_th=1.0, beta=0.5)
    got = _port(alifrec_scan, args, v_th=1.0, beta=0.5)
    _assert_spiking_outputs_close(got, ref, "alifrec")


def test_recurrent_term_is_the_event_sum_in_ascending_order():
    """The plain recurrence adds W[i] for each spiking i, in ascending i,
    from zero: the sum `csrc/lifrec.cu` and `csrc/alifrec.cu` compute."""
    from repro_torch.kernels.lifrec.ref import recurrent_current
    rng = np.random.default_rng(4)
    s = torch.from_numpy((rng.random((3, 40)) < 0.3).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((40, 40)).astype(np.float32))
    got = recurrent_current(s, w)
    for b in range(3):
        want = torch.zeros(40)
        for i in torch.nonzero(s[b]).flatten().tolist():
            want = want + w[i]
        assert torch.equal(got[b], want)


def test_registry_make_inputs_run_plain_on_cpu():
    """Every family's make_inputs (with its static keywords) runs through
    dispatch on the CPU, and the CPU path never counts a kernel launch."""
    registry.reset_launches()
    g = torch.Generator().manual_seed(0)
    for name in registry.names():
        spec = registry.get(name)
        out = registry.dispatch(name, spec.make_inputs(g), **spec.static)
        for o in (out if isinstance(out, tuple) else (out,)):
            assert torch.isfinite(o).all()
    assert registry.names() == ("alif", "alifrec", "attention", "lif",
                                "lifrec", "linrec", "spikemm",
                                "spikemm_gather", "spikemm_sessions", "stdp",
                                "stdp_seq", "stdp_seq_sessions")
    assert registry.launch_counts() == {
        n: 0 for n in registry.names() + ("spikemm_sparse", "lif_bwd",
                                          "linrec_bwd", "lifrec_bwd",
                                          "alif_bwd", "alifrec_bwd",
                                          "spikemm_wgrad",
                                          "spikemm_gather_bwd")}


def test_dispatch_rejects_mixed_devices():
    with pytest.raises(ValueError, match="span devices"):
        registry.on_cuda((torch.zeros(2), torch.zeros(2, device="meta")))


@pytest.mark.parametrize("call", [
    lambda: spikemm_cuda(torch.zeros(4, 3), torch.zeros(3, 2)),
    lambda: linrec_cuda(torch.ones(4), torch.zeros(5, 2, 4),
                        torch.zeros(2, 4)),
    lambda: lif_cuda(torch.zeros(5, 2, 4), torch.ones(4), torch.zeros(2, 4)),
    lambda: lifrec_cuda(torch.zeros(5, 2, 4), torch.zeros(4, 4),
                        torch.ones(4), torch.zeros(2, 4), torch.zeros(2, 4)),
    lambda: alif_cuda(torch.zeros(5, 2, 4), torch.ones(4), torch.ones(4),
                      torch.zeros(2, 4), torch.zeros(2, 4)),
    lambda: alifrec_cuda(torch.zeros(5, 2, 4), torch.zeros(4, 4),
                         torch.ones(4), torch.ones(4), torch.zeros(2, 4),
                         torch.zeros(2, 4), torch.zeros(2, 4)),
    lambda: spikemm_sparse_cuda(torch.zeros(4, 3), torch.zeros(3, 2)),
    lambda: occupancy_cuda(torch.zeros(4, 3)),
    lambda: spikemm_gather_cuda(torch.zeros(4, 3), build_gather_tables(
        [0], [1], [1.0], 3, 2, bk=4, bn=4)),
    lambda: stdp_update_cuda(torch.zeros(2, 3), torch.zeros(2, 4),
                             torch.zeros(2, 3), torch.zeros(2, 4),
                             torch.zeros(3, 4)),
    lambda: stdp_seq_cuda(torch.zeros(2, 6, 3), torch.zeros(2, 6, 4),
                          torch.zeros(3, 4), amps=(0.1, -0.1), w_min=-1.0,
                          w_max=1.0, batch=2),
    lambda: flash_attention_cuda(torch.zeros(2, 5, 4), torch.zeros(2, 3, 4),
                                 torch.zeros(2, 3, 4)),
])
def test_cuda_wrappers_refuse_cpu_tensors(call):
    """A CUDA wrapper never runs a plain version: CPU tensors raise."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()


def _fake_nvcc(tmp_path, exit_code):
    """An `nvcc` stand-in that logs its arguments, one JSON line per call,
    and writes the `-o` file when it succeeds."""
    calls = tmp_path / "calls.jsonl"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\nimport json, sys\n"
        f"open({str(calls)!r}, 'a').write(json.dumps(sys.argv[1:]) + '\\n')\n"
        "if not " + str(exit_code) + ":\n"
        "    open(sys.argv[sys.argv.index('-o') + 1], 'wb').close()\n"
        f"sys.exit({exit_code})\n")
    nvcc.chmod(0o755)
    return nvcc, calls


def test_build_is_one_nvcc_call(tmp_path, monkeypatch):
    """Every source is compiled for sm_90a by its own `nvcc -c`, all
    started together, and the objects are linked by one `nvcc -shared`
    call into the digest directory (`build.log` heads each source's output
    with its seconds); an unchanged tree reuses the build."""
    nvcc, calls = _fake_nvcc(tmp_path, 0)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    lib = _build.build()
    argvs = [json.loads(line) for line in calls.read_text().splitlines()]
    *compiles, link = argvs
    assert sorted(a[a.index("-c") + 1] for a in compiles) == \
        [str(s) for s in _build.sources()]
    for argv in argvs:
        assert "arch=compute_90a,code=sm_90a" in argv
    assert "-shared" in link and "-c" not in link
    assert sorted(a for a in link if a.endswith(".o")) == sorted(
        a[a.index("-o") + 1] for a in compiles)
    assert lib.parent.parent == tmp_path / "build" and lib.exists()
    # build.log heads each source's output with its compile seconds
    log = (lib.parent / "build.log").read_text()
    assert all(re.search(rf"^== {re.escape(s.name)} \(\d+\.\d s\)$", log,
                         re.M) for s in _build.sources())
    assert {s.name for s in _build.sources()} >= {
        "spikemm.cu", "linrec.cu", "lif.cu", "lifrec.cu", "alifrec.cu",
        "spikemm_sparse.cu", "spikemm_gather.cu", "stdp.cu",
        "flash_attention.cu"}
    assert _build.build() == lib
    assert len(calls.read_text().splitlines()) == len(_build.sources()) + 1


def test_header_edit_rebuilds(tmp_path, monkeypatch):
    """The digest covers the `*.cuh` headers the sources include: an edited
    header rebuilds though no `.cu` file changed."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    nvcc, calls = _fake_nvcc(tmp_path, 0)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    first = _build.build()
    header = csrc / "rec_scan.cuh"
    header.write_text(header.read_text() + "// edited\n")
    second = _build.build()
    assert second != first and second.exists()
    assert len(calls.read_text().splitlines()) == 2 * (len(_build.sources())
                                                       + 1)


def test_build_failure_raises(tmp_path, monkeypatch):
    nvcc, calls = _fake_nvcc(tmp_path, 1)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc exited 1"):
        _build.build()
    assert not list((tmp_path / "build").rglob(_build.LIB_NAME))


def test_build_failure_shows_each_failed_sources_messages(tmp_path,
                                                          monkeypatch):
    """A source that fails to compile is named in the error with its own
    messages, however much ptxas reported for the sources that built."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\nimport sys\n"
        "src = sys.argv[sys.argv.index('-c') + 1]\n"
        "if src.endswith('/rec_bwd.cu'):\n"
        "    print(src + '(12): error: boom')\n"
        "    sys.exit(2)\n"
        "print('ptxas info    : Used 32 registers\\n' * 400)\n"
        "open(sys.argv[sys.argv.index('-o') + 1], 'wb').close()\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError) as err:
        _build.build()
    msg = str(err.value)
    assert "nvcc exited 2 building ['rec_bwd.cu']" in msg
    assert "== rec_bwd.cu" in msg and "error: boom" in msg
    assert "ptxas info" not in msg


def test_build_root_is_the_checkout_or_a_user_cache(tmp_path, monkeypatch):
    """A checkout builds into its own git-ignored `build/`; an installed
    copy builds into the user's cache, never beside site-packages."""
    root = Path(__file__).resolve().parents[1]
    assert _build.build_root() == root / "build" / "repro_torch"
    monkeypatch.setattr(_build, "PKG", tmp_path / "site-packages" / "repro_torch")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _build.build_root() == tmp_path / "cache" / "repro_torch"


# ---------------------------------------------------------------------------
# stdp and stdp_seq (on-chip learning)
# ---------------------------------------------------------------------------


def _bf16_exact(a):
    """fp32 values that bf16 holds exactly (both packages then read the
    same bf16 tensor)."""
    return torch.from_numpy(a).bfloat16().float().numpy()


@pytest.mark.parametrize("force_pallas", IMPLS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,M,N", [(8, 256, 256), (16, 300, 200),
                                   (4, 128, 640), (8, 256, 128),
                                   (3, 130, 70)])
def test_stdp_matches_reference(B, M, N, dtype, force_pallas):
    """The JAX kernel tests' shapes and dtypes and its clip (+-0.4), and
    stdp_step's (8, 256, 128) and an unaligned (3, 130, 70): the plain
    version against the reference and the Pallas kernel (interpret mode) at
    the family's tol. bf16 traces are upcast exactly in all three, so one
    tolerance holds both dtypes."""
    rng = np.random.default_rng(B * M + N)
    x_pre = rng.random((B, M)).astype(np.float32)
    x_post = rng.random((B, N)).astype(np.float32)
    s_pre = (rng.random((B, M)) < 0.2).astype(np.float32)
    s_post = (rng.random((B, N)) < 0.2).astype(np.float32)
    w = (0.5 * rng.standard_normal((M, N))).astype(np.float32)
    traces = [x_pre, s_post, s_pre, x_post]
    if dtype == "bfloat16":
        traces = [_bf16_exact(a) for a in traces]
    kw = dict(a_plus=0.05, a_minus=0.06, w_min=-0.4, w_max=0.4)
    jargs = tuple(jnp.asarray(a, getattr(jnp, dtype)) for a in traces) + (
        jnp.asarray(w),)
    ref = np.asarray(jreg.dispatch("stdp", jargs, force_pallas=force_pallas,
                                   **kw))
    targs = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in traces]
    got = stdp_update(*targs, torch.from_numpy(w), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=_tol("stdp"))
    assert (got.abs() == 0.4).sum() > 0, "no weight reached the clip"


@pytest.mark.parametrize("force_pallas", IMPLS)
def test_stdp_with_no_batch_rows_only_clips(force_pallas):
    """B = 0: no event, so the step is the clip of the weight alone, in
    the plain version as in the reference and the Pallas kernel."""
    rng = np.random.default_rng(12)
    M, N = 130, 70
    w = (0.5 * rng.standard_normal((M, N))).astype(np.float32)
    traces = [np.zeros((0, n), np.float32) for n in (M, N, M, N)]
    kw = dict(a_plus=0.05, a_minus=0.06, w_min=-0.4, w_max=0.4)
    got = stdp_update(*(torch.from_numpy(a) for a in traces),
                      torch.from_numpy(w), **kw)
    assert torch.equal(got, torch.clamp(torch.from_numpy(w), -0.4, 0.4))
    ref = np.asarray(jreg.dispatch(
        "stdp", tuple(jnp.asarray(a) for a in traces + [w]),
        force_pallas=force_pallas, **kw))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=_tol("stdp"))


def _seq_case(K, T, B, M, N, seed):
    rng = np.random.default_rng(seed)
    P = rng.random((K, T * B, M)).astype(np.float32)
    Q = (rng.random((K, T * B, N)) < 0.2).astype(np.float32)
    w = (0.5 * rng.standard_normal((M, N))).astype(np.float32)
    return P, Q, w


@pytest.mark.parametrize("force_pallas", IMPLS)
@pytest.mark.parametrize("case", ["jax_make_inputs", "four_terms",
                                  "clip"])
def test_stdp_seq_matches_reference(case, force_pallas):
    """`_make_seq_inputs`' ragged shape (K=2, T=12, B=4, 130 x 140), four
    term planes (the matcher's largest program) and bounds of +-0.4 that
    the trajectory hits: the plain version against the reference and the
    Pallas kernel (interpret mode) at the family's tol."""
    K, amps, lo, hi = {
        "jax_make_inputs": (2, (0.01, -0.012), -1.0, 1.0),
        "four_terms": (4, (0.02, -0.015, 0.01, -0.03), -1.0, 1.0),
        "clip": (2, (0.05, -0.06), -0.4, 0.4)}[case]
    P, Q, w = _seq_case(K, 12, 4, 130, 140, K * 7 + len(case))
    static = dict(amps=amps, w_min=lo, w_max=hi, batch=4)
    ref, = _jax("stdp_seq", (P, Q, w), force_pallas, **static)
    got, = _port(stdp_seq, (P, Q, w), **static)
    np.testing.assert_allclose(got, ref, rtol=0, atol=_tol("stdp_seq"))
    if case == "clip":
        assert (np.abs(got) == 0.4).sum() > 0, "no weight reached the clip"


def test_stdp_plain_versions_sum_in_the_kernels_order():
    """`outer_sum` adds p[b] q[b] from zeros over b ascending, one rounded
    product and one rounded sum a row: the order `csrc/stdp.cu` follows.
    `stdp_seq`'s step is dw = sum over k of amp_k * s_k from zeros, then
    clip(w + dw); the single step is (w + a_plus pot) - a_minus dep."""
    rng = np.random.default_rng(11)
    p = torch.from_numpy(rng.random((5, 7)).astype(np.float32))
    q = torch.from_numpy(rng.random((5, 6)).astype(np.float32))
    s = outer_sum(p, q)
    for i in range(7):
        for j in range(6):
            acc = torch.tensor(0.0)
            for b in range(5):
                acc = acc + p[b, i] * q[b, j]
            assert torch.equal(s[i, j], acc)
    P, Q, w = (torch.from_numpy(a) for a in _seq_case(2, 3, 5, 7, 6, 2))
    amps = (0.3, -0.2)
    want = w.clone()
    for t in range(3):
        rows = slice(5 * t, 5 * t + 5)
        dw = torch.zeros_like(w)
        for k in range(2):
            dw = dw + torch.tensor(amps[k]) * outer_sum(P[k, rows],
                                                        Q[k, rows])
        want = torch.clamp(want + dw, -0.5, 0.5)
    assert torch.equal(stdp_seq(P, Q, w, amps=amps, w_min=-0.5, w_max=0.5,
                                batch=5), want)
    x_pre, s_pre = P[0, :5], P[1, :5]
    s_post, x_post = Q[0, :5], Q[1, :5]
    one = stdp_update(x_pre, s_post, s_pre, x_post, w, a_plus=0.3,
                      a_minus=0.2, w_min=-0.5, w_max=0.5)
    want = torch.clamp((w + torch.tensor(0.3) * outer_sum(x_pre, s_post))
                       - torch.tensor(0.2) * outer_sum(s_pre, x_post),
                       -0.5, 0.5)
    assert torch.equal(one, want)
    bf = stdp_update(x_pre.bfloat16(), s_post.bfloat16(), s_pre.bfloat16(),
                     x_post.bfloat16(), w, a_plus=0.3, a_minus=0.2,
                     w_min=-0.5, w_max=0.5)
    up = stdp_update(x_pre.bfloat16().float(), s_post.bfloat16().float(),
                     s_pre.bfloat16().float(), x_post.bfloat16().float(), w,
                     a_plus=0.3, a_minus=0.2, w_min=-0.5, w_max=0.5)
    assert torch.equal(bf, up)                 # bf16 upcasts exactly


def test_stdp_wrappers_write_a_fresh_weight():
    """The plain versions return a new tensor and leave w as it was (the
    CUDA wrappers allocate theirs with torch.empty_like)."""
    P, Q, w = (torch.from_numpy(a) for a in _seq_case(2, 2, 3, 5, 4, 3))
    w0 = w.clone()
    out = stdp_seq(P, Q, w, amps=(0.5, -0.5), w_min=-1.0, w_max=1.0, batch=3)
    assert out is not w and torch.equal(w, w0) and not torch.equal(out, w0)
    out = stdp_update(P[0, :3], Q[0, :3], P[1, :3], Q[1, :3], w)
    assert out is not w and torch.equal(w, w0)


def _stdp_seq_grouped(P, Q, w, *, amps, w_min, w_max, batch, T, G):
    """The schedule of `csrc/stdp.cu`'s stdp_seq, in plain PyTorch: for
    each group of G steps, every step's dw at once (s_k summed from zeros
    over b ascending, dw from zeros over k ascending as dw + amp_k s_k),
    then the clip chain w = clip(w + dw_t) over the group's steps. T is
    explicit, so that steps with no batch rows (B = 0) still clip."""
    K = P.shape[0]
    M, N = w.shape
    amp = [torch.tensor(a, dtype=torch.float32) for a in amps]
    w = w.clone()
    for t0 in range(0, T, G):
        steps = torch.arange(t0, min(t0 + G, T))
        dw = torch.zeros((len(steps), M, N))
        for k in range(K):
            s = torch.zeros((len(steps), M, N))
            for b in range(batch):
                rows = steps * batch + b
                s = s + P[k, rows][:, :, None] * Q[k, rows][:, None, :]
            dw = dw + amp[k] * s
        for d in dw:
            w = torch.clamp(w + d, w_min, w_max)
    return w


@pytest.mark.parametrize("B", [0, 1, 8])
@pytest.mark.parametrize("K", [1, 2, 4])
@pytest.mark.parametrize("T_of_G", ["1", "G-1", "G", "G+1", "3G+5"])
def test_stdp_seq_group_schedule_is_the_plain_version(T_of_G, K, B):
    """The kernel's split of the window (all dw of a group of
    STDP_SEQ_GROUP steps first, then the clip chain over the group) is
    exact: bit for bit `stdp_seq_ref` at T on both sides of a group's edge
    and past several groups, with bounds the trajectory hits. At B = 0,
    which the wrapper cannot express, against the plain loop it runs: each
    step clips w + dw, dw = sum_k amp_k * 0 from zeros."""
    G = _build.STDP_SEQ_GROUP
    T = {"1": 1, "G-1": G - 1, "G": G, "G+1": G + 1, "3G+5": 3 * G + 5}[
        T_of_G]
    P, Q, w = (torch.from_numpy(a) for a in _seq_case(K, T, B, 12, 10,
                                                        T * 16 + K * 4 + B))
    w = 2.0 * w
    amps = (0.05, -0.06, 0.03, -0.04)[:K]
    kw = dict(amps=amps, w_min=-0.4, w_max=0.4)
    got = _stdp_seq_grouped(P, Q, w, batch=B, T=T, G=G, **kw)
    if B:
        want = stdp_seq(P, Q, w, batch=B, **kw)
    else:
        want, dw = w.clone(), torch.zeros_like(w)
        for a in amps:
            dw = dw + torch.tensor(a) * torch.zeros_like(w)
        for _ in range(T):
            want = torch.clamp(want + dw, -0.4, 0.4)
    assert torch.equal(got, want)
    assert (got.abs() == 0.4).sum() > 0, "no weight reached the clip"
    if B:
        assert not torch.equal(got, torch.clamp(w, -0.4, 0.4))


@pytest.mark.parametrize("n", [1, 31, 32, 33, 64, "max-1", "max", "max+1",
                               1024, 4096])
def test_rec_route_follows_the_row_width(n):
    """Rows of up to 32 * REC_LANE_NEURONS neurons (128) take the warp
    route, wider rows the block route."""
    from repro_torch.kernels.common import (REC_BLOCK, REC_WARP,
                                            REC_WARP_MAX_N, rec_route)
    assert REC_WARP_MAX_N == 32 * _build.REC_LANE_NEURONS == 128
    n = {"max-1": REC_WARP_MAX_N - 1, "max": REC_WARP_MAX_N,
         "max+1": REC_WARP_MAX_N + 1}.get(n, n)
    assert rec_route(n) == (REC_WARP if n <= REC_WARP_MAX_N else REC_BLOCK)


@pytest.mark.parametrize("name", ["lifrec", "alifrec"])
@pytest.mark.parametrize("side", ["warp", "block"])
def test_rec_wrappers_pass_the_route_and_count_it(monkeypatch, name, side):
    """With a recording stand-in for the library (no card here) the
    wrapper tells the C entry point `common.rec_plan`'s launch (the `warp`
    flag, 1 up to REC_WARP_MAX_N neurons and 0 above, its neurons a lane
    or a thread, and whether W_rec sits in shared memory) and counts one
    launch on that route's counter and on the registry's."""
    from contextlib import nullcontext
    from unittest import mock
    from repro_torch.kernels import common
    from repro_torch.kernels.alifrec import ops as alifrec_ops
    from repro_torch.kernels.lifrec import ops as lifrec_ops
    ops = lifrec_ops if name == "lifrec" else alifrec_ops
    n = common.REC_WARP_MAX_N + (side == "block")
    lib = mock.Mock(**{f"{name}_f32.return_value": 0})
    monkeypatch.setattr(ops, "check_scan", lambda *a: None)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    T, B = 3, 2
    lane = torch.zeros((B, n))
    args = ((torch.zeros((T, B, n)), torch.zeros((n, n)), torch.ones(n),
             lane, lane) if name == "lifrec" else
            (torch.zeros((T, B, n)), torch.zeros((n, n)), torch.ones(n),
             torch.ones(n), lane, lane, lane))
    registry.reset_launches()
    before = common.rec_route_launch_counts()[name]
    (lifrec_cuda if name == "lifrec" else alifrec_cuda)(*args)
    after = common.rec_route_launch_counts()[name]
    call, = getattr(lib, f"{name}_f32").call_args_list
    plan = common.rec_plan(n, B, common.smem_budget())
    assert call.args[-4:-1] == (int(side == "warp"), plan.unit,
                                int(plan.w_smem))
    assert plan.route == side
    assert {r: after[r] - before[r] for r in after} == {
        "warp": int(side == "warp"), "block": int(side == "block")}
    assert registry.launch_counts()[name] == 1
    registry.reset_launches()


@pytest.mark.parametrize("source,macro,const", [
    ("stdp.cu", "STDP_SEQ_GROUP", "G"),
    ("lifrec.cu", "REC_LANE_NEURONS", None),
    ("alifrec.cu", "REC_LANE_NEURONS", None),
    ("linrec.cu", "LANE_SCAN_CHUNK", "LS_CHUNK"),
    ("linrec.cu", "LANE_SCAN_STAGES", "LS_STAGES"),
    ("lif_bwd.cu", "LANE_BWD_SEG", "SEG"),
    ("alif_bwd.cu", "LANE_BWD_SEG", "SEG"),
    ("lif.cu", "LANE_SCAN_CHUNK", "LS_CHUNK"),
    ("lif.cu", "LANE_SCAN_STAGES", "LS_STAGES"),
    ("alifrec.cu", "LANE_SCAN_CHUNK", "LS_CHUNK"),
    ("alifrec.cu", "LANE_SCAN_STAGES", "LS_STAGES")])
def test_serial_kernel_constants_are_the_wrappers(tmp_path, monkeypatch,
                                                 source, macro, const):
    """stdp_seq's group of STDP_SEQ_GROUP steps, the scan's
    REC_LANE_NEURONS neurons a lane, the lane scans' staging ring
    (LANE_SCAN_CHUNK steps a stage, LANE_SCAN_STAGES stages) and the lane
    backward kernels' segment (LANE_BWD_SEG steps) have one
    definition, in `_build`: the nvcc call of each source that uses them
    passes them as -D flags, and the sources (or the headers they include)
    take them from there and from no other value."""
    nvcc, calls = _fake_nvcc(tmp_path, 0)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    _build.build()
    argv, = [a for a in (json.loads(line) for line in
                         calls.read_text().splitlines())
             if str(_build.CSRC / source) in a]
    assert f"-D{macro}={getattr(_build, macro)}" in argv
    src = (_build.CSRC / source).read_text()
    text = "".join([src] + [(_build.CSRC / h).read_text() for h in
                            re.findall(r'#include "(\w+\.cuh)"', src)])
    if const is None:
        assert '#include "rec_scan.cuh"' in src
        const = "LANE_N"
    elif macro.startswith("LANE_SCAN"):
        assert '#include "lane_scan.cuh"' in src
    consts = dict(re.findall(r"constexpr int (\w+) = (\w+);", text))
    assert consts[const] == macro


@pytest.mark.parametrize("name", ["lifrec", "alifrec"])
def test_recurrent_plain_versions_take_rows_over_1024(name):
    """N = 1025, past what the recurrent kernel once held per batch row:
    the reference and the port's plain version take it (the card's check
    is in `chip_smoke.py`), and the kernel's source sets no limit on N
    short of device memory."""
    T, B, N = 3, 2, 1025
    cur, w_rec, tau, rho, v0, a0, s0 = _scan_inputs(T, B, N, N)
    cur = cur + 0.6                     # enough spikes for a real check
    if name == "lifrec":
        args, kw, fn = (cur, w_rec, tau, v0, s0), dict(v_th=1.0), lifrec_scan
    else:
        args, kw, fn = ((cur, w_rec, tau, rho, v0, a0, s0),
                        dict(v_th=1.0, beta=0.5), alifrec_scan)
    ref = _jax(name, args, False, **kw)
    got = _port(fn, args, **kw)
    _assert_spiking_outputs_close(got, ref, name)
    src = (_build.CSRC / "rec_scan.cuh").read_text()
    assert "REC_MAX_N" not in src and "rec_scan_max_n" not in \
        (_build.CSRC / "lifrec.cu").read_text()
    assert "rec_scan_max_n" not in _build.SIGNATURES
