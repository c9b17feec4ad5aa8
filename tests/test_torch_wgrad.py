"""spikemm's weight gradient (B3) on the CPU: its plain versions against
the JAX package, its split, and its routing.

* `spikemm_wgrad_chain_ref`, the card kernel's bit-exact twin (chunks of
  `wgrad_chunk(R, K, N)` rows, each an fmaf chain in ascending rows, the
  partials added in ascending chunk order), within `KernelSpec.tol` of
  `jax.vjp` of the JAX package's spikemm (g_w), at ragged shapes: R not a
  multiple of the chunk, K and N under and over a tile, R = 0 and 1;
  with one chunk it is `spikemm_chain_ref` on the transposed raster bit
  for bit.
* `wgrad_chunk` is a function of (R, K, N) alone: it reads no device
  property, and gives the pinned chunks at the training paths' shapes.
* The recurrent g_W's shifted raster, handed over as s0 and the spikes
  plane (no `cat`), gives the old `rec_g_w`'s result bit for bit.
* Under `auto`, g_w makes no occupancy call; under `always` it takes the
  sparse channel; the wrapper makes one C call with the planned split.
"""

import dataclasses
from contextlib import nullcontext
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.spikemm.ops import spikemm as jspikemm
from repro_torch.kernels import _build, common, registry
from repro_torch.kernels.lifrec.ops import rec_g_w
from repro_torch.kernels.spikemm import ops as spikemm_ops
from repro_torch.kernels.spikemm import wgrad
from repro_torch.kernels.spikemm.ref import (shifted_raster,
                                             spikemm_chain_ref, spikemm_ref,
                                             spikemm_wgrad_chain_ref,
                                             spikemm_wgrad_ref)
from repro_torch.kernels.spikemm.wgrad import (WGRAD_CTAS, WGRAD_MAX_CLUSTER,
                                               WGRAD_SUB, WGRAD_TILE_ROWS,
                                               wgrad_chunk, wgrad_chunks,
                                               wgrad_groups, wgrad_tile,
                                               wgrad_tiles)


def _tol():
    return registry.get("spikemm").tol


def _inputs(R, K, N, rate=0.15, seed=0):
    rng = np.random.default_rng(seed)
    s = (rng.random((R, K)) < rate).astype(np.float32)
    g = rng.standard_normal((R, N)).astype(np.float32)
    return s, g


# the training paths' g_w products (R = T B, K, N) and their pinned chunks
TRAIN_SHAPES = {(3200, 4, 64): 64, (3200, 64, 6): 64, (2880, 64, 20): 48,
                (3200, 64, 64): 64, (2880, 700, 256): 368,
                (2880, 700, 64): 368}
RAGGED = [(1, 8, 20), (33, 9, 33), (97, 3, 65), (300, 64, 6),
          (1000, 9, 33), (640, 40, 129), (257, 33, 1), (100, 1, 300)]


@pytest.mark.parametrize("R,K,N", RAGGED)
def test_chain_ref_matches_jax_vjp(R, K, N):
    """The split chain with the kernel's chunk is the JAX package's g_w
    (`jax.vjp` of its spikemm, on the same numpy inputs) within the
    family's tol."""
    s, g = _inputs(R, K, N)
    w = np.random.default_rng(1).standard_normal((K, N)).astype(np.float32)
    _, vjp = jax.vjp(jspikemm, jnp.asarray(s), jnp.asarray(w))
    want = np.asarray(vjp(jnp.asarray(g))[1])
    got = spikemm_wgrad_chain_ref(torch.from_numpy(s), torch.from_numpy(g),
                                  wgrad_chunk(R, K, N))
    np.testing.assert_allclose(got.numpy(), want, rtol=_tol(), atol=_tol())


@pytest.mark.parametrize("R,K,N", RAGGED)
def test_chain_ref_is_the_plain_version(R, K, N):
    """The split chain at its chunk and at many small chunks is the plain
    product `spikemm_wgrad_ref` within the family's tol."""
    s, g = (torch.from_numpy(a) for a in _inputs(R, K, N, seed=2))
    want = spikemm_wgrad_ref(s, g)
    for chunk in (wgrad_chunk(R, K, N), WGRAD_SUB):
        torch.testing.assert_close(spikemm_wgrad_chain_ref(s, g, chunk),
                                   want, rtol=_tol(), atol=_tol())


@pytest.mark.parametrize("R,K,N", [(0, 5, 7), (0, 1, 1)])
def test_no_rows_give_zeros(R, K, N):
    s, g = torch.zeros((R, K)), torch.zeros((R, N))
    got = spikemm_wgrad_chain_ref(s, g, wgrad_chunk(R, K, N))
    assert got.shape == (K, N) and torch.equal(
        got.view(torch.int32), torch.zeros((K, N), dtype=torch.int32))
    assert torch.equal(spikemm_wgrad_ref(s, g), torch.zeros((K, N)))
    assert wgrad_chunks(R, K, N) == 1


@pytest.mark.parametrize("R,K,N", RAGGED + [(2880, 7, 5)])
def test_one_chunk_is_spikemm_chain_ref(R, K, N):
    """With one chunk the split chain is `spikemm_chain_ref` on the
    transposed raster, bit for bit (the forward kernel's chain)."""
    s, g = (torch.from_numpy(a) for a in _inputs(R, K, N, seed=3))
    got = spikemm_wgrad_chain_ref(s, g, max(R, 1))
    want = spikemm_chain_ref(s.t().contiguous(), g)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("R,K,N", [(300, 16, 24), (1000, 9, 33)])
def test_chain_ref_adds_the_partials_in_chunk_order(R, K, N):
    """Each chunk's partial is its own chain from +0, and the partials are
    added in ascending chunk order, one rounded add each."""
    s, g = (torch.from_numpy(a) for a in _inputs(R, K, N, seed=4))
    chunk = 64
    parts = [spikemm_chain_ref(s[r:r + chunk].t(), g[r:r + chunk])
             for r in range(0, R, chunk)]
    want = parts[0]
    for p in parts[1:]:
        want = want + p
    assert torch.equal(spikemm_wgrad_chain_ref(s, g, chunk), want)


@pytest.mark.parametrize("shape,chunk", sorted(TRAIN_SHAPES.items()))
def test_wgrad_chunk_at_the_training_shapes(shape, chunk, monkeypatch):
    """The pinned split of each training g_w, computed with every device
    query refusing: a function of the shapes alone."""
    def refuse(*a, **k):
        raise AssertionError("the split asked the device")
    monkeypatch.setattr(common, "sm_count", refuse)
    monkeypatch.setattr(torch.cuda, "get_device_properties", refuse)
    monkeypatch.setattr(torch.cuda, "is_available", refuse)
    assert wgrad_chunk(*shape) == chunk


@pytest.mark.parametrize("R", (0, 1, 31, 32, 33, 100, 2880, 3200, 20000,
                               10 ** 6))
@pytest.mark.parametrize("K,N", [(1, 1), (4, 64), (64, 6), (64, 64),
                                 (700, 256), (33, 129), (8, 300)])
def test_wgrad_chunk_properties(R, K, N):
    """A multiple of WGRAD_SUB rows; a cluster of at most
    WGRAD_MAX_CLUSTER CTAs a tile, tiles x cluster about WGRAD_CTAS at
    most (a wave of CTAs), no more chunks than the cluster's groups, an
    allowed tile of whole warps a group, and no empty chunk."""
    chunk, chunks = wgrad_chunk(R, K, N), wgrad_chunks(R, K, N)
    kt, nt = wgrad_tiles(K, N)
    bm, cw, cluster = wgrad_tile(K, N)
    groups = wgrad_groups(bm, cw)
    assert chunk % WGRAD_SUB == 0 and chunk >= WGRAD_SUB
    assert 1 <= cluster <= WGRAD_MAX_CLUSTER and bm in WGRAD_TILE_ROWS[cw]
    assert 1 <= chunks <= cluster * groups and groups * (
        cw // (2 if cw <= 32 else cw // 16)) * (bm // 4) == 256
    assert cluster == WGRAD_MAX_CLUSTER
    assert (chunks - 1) * chunk < max(R, 1) <= chunks * chunk or R == 0
    assert bm * kt >= K and cw * nt >= N
    assert K <= 64 or (bm == 64 and cw >= min(N, 128))
    # halving the rows stopped at a wave or at the smallest tile
    assert kt * nt * WGRAD_MAX_CLUSTER >= WGRAD_CTAS or K > 64 or \
        bm == WGRAD_TILE_ROWS[cw][0] or bm < min(K, 64)
    assert wgrad_chunk(R, K, N) == chunk          # the same every call


def _old_rec_g_w(s0, spikes, gu):
    """`rec_g_w` before the weight-gradient kernel: the spike product on
    the concatenated, transposed raster."""
    T, B, N = spikes.shape
    shifted = torch.cat([s0[None].to(spikes.dtype), spikes[:-1]])
    raster = shifted.reshape(T * B, N).t().contiguous()
    return spikemm_ref(raster, gu.reshape(T * B, N))


@pytest.mark.parametrize("T,B,N", [(1, 1, 7), (5, 3, 7), (37, 3, 70),
                                   (20, 16, 64)])
def test_shifted_raster_without_cat_is_the_old_rec_g_w(T, B, N,
                                                       monkeypatch):
    """On the CPU the recurrent g_W from s0 and the spikes plane is the
    old concatenated product bit for bit, and its chain twin reads the
    same raster as the explicit [s0; s_0 .. s_{T-2}]."""
    monkeypatch.setenv("REPRO_SPIKEMM_SPARSE", "auto")
    rng = np.random.default_rng(T * 100 + N)
    spikes = torch.from_numpy((rng.random((T, B, N)) < 0.2).astype(
        np.float32))
    s0 = torch.from_numpy((rng.random((B, N)) < 0.3).astype(np.float32))
    gu = torch.from_numpy(rng.standard_normal((T, B, N)).astype(np.float32))
    assert torch.equal(rec_g_w(s0, spikes, gu),
                       _old_rec_g_w(s0, spikes, gu))
    flat, g2 = spikes.reshape(T * B, N), gu.reshape(T * B, N)
    explicit = torch.cat([s0, flat[:-B]])
    assert torch.equal(shifted_raster(flat, T * B, s0), explicit)
    chunk = wgrad_chunk(T * B, N, N)
    assert torch.equal(spikemm_wgrad_chain_ref(flat, g2, chunk, head=s0),
                       spikemm_wgrad_chain_ref(explicit, g2, chunk))


@pytest.mark.parametrize("recurrent", (False, True))
def test_auto_g_w_makes_no_occupancy_call(recurrent, monkeypatch):
    """Under `auto` the forward measures the raster's occupancy once (its
    router) and g_w never: it goes to the backward pair, whatever the
    raster's occupancy."""
    monkeypatch.setenv("REPRO_SPIKEMM_SPARSE", "auto")
    calls = []
    real = spikemm_ops.occupancy

    def counting(s):
        calls.append(tuple(s.shape))
        return real(s)
    monkeypatch.setattr(spikemm_ops, "occupancy", counting)
    rng = np.random.default_rng(7)
    if recurrent:
        spikes = torch.from_numpy((rng.random((9, 3, 20)) < 0.01).astype(
            np.float32))
        s0 = torch.zeros((3, 20))
        gu = torch.randn((9, 3, 20))
        rec_g_w(s0, spikes, gu)
        assert calls == []
        return
    s = torch.from_numpy((rng.random((50, 30)) < 0.01).astype(np.float32))
    w = torch.randn((30, 8), requires_grad=True)
    out = spikemm_ops.spikemm(s, w)
    assert calls == [(50, 30)]
    out.sum().backward()
    assert calls == [(50, 30)]
    torch.testing.assert_close(w.grad, s.t() @ torch.ones(50, 8))


@pytest.mark.parametrize("mode,route", [("never", "bwd"), ("auto", "bwd"),
                                        ("always", "spikemm_sparse")])
def test_g_w_routing(mode, route, monkeypatch):
    """g_w takes the backward pair under `never` and `auto`, and the
    sparse channel on the transposed raster under `always`, which pins
    that channel."""
    monkeypatch.setenv("REPRO_SPIKEMM_SPARSE", mode)
    spec = registry.get("spikemm")
    taken = []

    def select(*a, **kw):
        choice, measured = spec.select_channel(*a, **kw)
        taken.append(("spikemm" if choice is None else f"spikemm_{choice}",
                      tuple(a[0].shape)))
        return choice, measured

    def bwd(s, g, head=None):
        taken.append(("bwd", tuple(s.shape)))
        return spec.bwd.plain(s, g, head=head)
    monkeypatch.setattr(registry, "_REGISTRY", {
        **registry._REGISTRY, "spikemm": dataclasses.replace(
            spec, select_channel=select, bwd=dataclasses.replace(
                spec.bwd, plain=bwd))})
    s, g = (torch.from_numpy(a) for a in _inputs(40, 12, 5, seed=5))
    w = torch.randn((12, 5), requires_grad=True)
    spikemm_ops.spikemm(s, w).backward(g)
    g_w = taken[1:]
    assert g_w == ([("bwd", (40, 12))] if route == "bwd"
                   else [(route, (12, 40))])
    torch.testing.assert_close(w.grad, s.t() @ g, rtol=_tol(), atol=_tol())


@pytest.fixture
def stand_in_library(monkeypatch):
    """A recording stand-in for the kernel library (no card here)."""
    lib = mock.Mock(**{"spikemm_wgrad_f32.return_value": 0})
    monkeypatch.setattr(wgrad, "_check", lambda *a: None)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 7})())
    registry.reset_launches()
    yield lib
    registry.reset_launches()


@pytest.mark.parametrize("R,K,N,H", [(3200, 4, 64, 0), (3200, 64, 64, 16),
                                     (2880, 700, 256, 0), (20, 5, 3, 0),
                                     (0, 4, 4, 0)])
def test_wgrad_wrapper_passes_the_kernel_its_arguments(
        stand_in_library, R, K, N, H):
    """One C call, `spikemm_wgrad_f32`, with the raster's head and body
    as given (no copy), a (chunks, K, N) partial scratch where there is
    more than one chunk (else null), the planned split, tile and cluster
    and the stream; one launch counted; nothing else launched."""
    spikes, g = torch.zeros((R - H, K)), torch.zeros((R, N))
    head = torch.zeros((H, K)) if H else None
    out = wgrad.spikemm_wgrad_cuda(spikes, g, head=head)
    assert out.shape == (K, N)
    assert [c[0] for c in stand_in_library.method_calls] == [
        "spikemm_wgrad_f32"]
    a = stand_in_library.spikemm_wgrad_f32.call_args.args
    assert a[0] == (None if head is None else head.data_ptr())
    assert a[1:5] == (H, spikes.data_ptr(), g.data_ptr(), out.data_ptr())
    assert (a[5] is None) == (wgrad_chunks(R, K, N) == 1)
    assert a[6:] == (R, K, N, wgrad_chunk(R, K, N), *wgrad_tile(K, N), 7)
    bm, cw, cluster = wgrad_tile(K, N)
    assert wgrad_chunks(R, K, N) <= cluster * wgrad_groups(bm, cw)
    assert registry.launch_counts()["spikemm_wgrad"] == 1


@pytest.mark.parametrize("R,K,N", [(3200, 64, 64), (2880, 700, 256)])
def test_wgrad_wrapper_allocates_the_output_and_the_partials(
        stand_in_library, monkeypatch, R, K, N):
    """The wrapper allocates the (K, N) output and the (chunks, K, N)
    partials the cluster combines, and nothing else (no transposed or
    concatenated raster, no counter)."""
    sizes = []
    real = torch.empty

    def empty(*shape, **kw):
        sizes.append(tuple(shape[0]) if len(shape) == 1 else shape)
        return real(*shape, **kw)
    g, spikes = torch.zeros((R, N)), torch.zeros((R, K))
    monkeypatch.setattr(torch, "empty", empty)
    wgrad.spikemm_wgrad_cuda(spikes, g)
    assert sizes == [(K, N), (wgrad_chunks(R, K, N), K, N)]
