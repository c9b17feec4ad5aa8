"""Flash attention: the port held against the JAX package, on the CPU.

The port's `flash_attention` on CPU tensors runs its plain version
(`kernels/attention/ref.py`). On the same numpy inputs it is compared with
  * the JAX `attention_ref`, and
  * the JAX Pallas kernel in interpret mode
    (`flash_attention(..., bq=128, bk=128, force_pallas=True)`, as
    `tests/test_kernels.py` runs it),
on the JAX tests' grid of shapes and masks at rtol = atol = 2e-4, and in
bf16 at 5e-2 (the JAX tests' tolerances). Gradients of the parity loss
are held to `jax.grad` of the JAX entry within 2e-3, the family's tol.
Shapes where the JAX reference's padded Pallas path is wrong, and rows
with no allowed key, are held to `attention_ref` alone.

The CUDA kernel itself cannot run here (no card, no nvcc);
`chip_smoke.py` holds it against its plain version on the card. Here the
wrapper's refusals are checked, and `_FlashST`'s straight-through
backward with the plain version put in place of the launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import registry as jreg
from repro.kernels.attention import attention_ref as jattention_ref
from repro.kernels.attention import flash_attention as jflash_attention
from repro.kernels.parity import _loss as jloss
from repro_torch.kernels import registry
from repro_torch.kernels.attention import ops
from repro_torch.kernels.attention.ops import (_FlashST, flash_attention,
                                               flash_attention_cuda)
from repro_torch.kernels.attention.ref import attention_ref
from repro_torch.kernels.parity import _loss

TOL = 2e-4            # tests/test_kernels.py:187
BF16_TOL = 5e-2       # tests/test_kernels.py:200

# tests/test_kernels.py's grid; non-causal only where T == S, as there
GRID = [(T, S, d, causal, window)
        for T, S, d in [(256, 256, 64), (512, 512, 128), (384, 640, 64)]
        for causal, window in [(True, 0), (True, 128), (False, 0)]
        if causal or T == S]


def _inputs(BH, T, S, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((BH, T, d), np.float32),
            rng.standard_normal((BH, S, d), np.float32),
            rng.standard_normal((BH, S, d), np.float32))


def _port(q, k, v, **kw):
    return flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                           **kw).numpy()


def _jax(q, k, v, pallas, **kw):
    args = tuple(jnp.asarray(a) for a in (q, k, v))
    if pallas:
        return np.asarray(jflash_attention(*args, bq=128, bk=128,
                                           force_pallas=True, **kw))
    return np.asarray(jattention_ref(*args, **kw))


@pytest.mark.parametrize("pallas", [False, True], ids=["ref", "pallas"])
@pytest.mark.parametrize("T,S,d,causal,window", GRID)
def test_matches_reference_grid(T, S, d, causal, window, pallas):
    q, k, v = _inputs(4, T, S, d, seed=T + S)
    got = _port(q, k, v, causal=causal, window=window)
    want = _jax(q, k, v, pallas, causal=causal, window=window)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("pallas", [False, True], ids=["ref", "pallas"])
def test_bf16_matches_reference(pallas):
    q, k, v = _inputs(2, 256, 256, 64, seed=5)
    # both packages round the same fp32 values to bf16 (to nearest even)
    got = flash_attention(*(torch.from_numpy(a).bfloat16()
                            for a in (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    args = tuple(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = (jflash_attention(*args, causal=True, bq=128, bk=128,
                             force_pallas=True) if pallas
            else jattention_ref(*args, causal=True))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("pallas", [False, True], ids=["ref", "pallas"])
@pytest.mark.parametrize("d,window", [(64, 0), (16, 0), (16, 48)])
def test_make_inputs_shape_and_narrow_heads(d, window, pallas):
    """`_make_inputs`' (2, 160, 64), T not a multiple of the JAX tile, and
    d = 16, the smoke configs' head dim."""
    q, k, v = _inputs(2, 160, 160, d, seed=d)
    got = _port(q, k, v, causal=True, window=window)
    want = _jax(q, k, v, pallas, causal=True, window=window)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("T,S,causal,window", [
    (256, 160, True, 0),      # padded keys
    (256, 64, True, 32),      # rows t >= S + window - 1 allow no key
    (256, 64, False, 32),
])
def test_held_to_attention_ref_where_the_pallas_path_is_not(T, S, causal,
                                                            window):
    """Held to `attention_ref` alone. The JAX wrapper `_flash_fwd_raw`
    zero-pads K/V up to bk and leaves the padded keys unmasked for causal
    rows t >= S: at (2, 256, 160, 64) causal they score 0 and enter the
    softmax (its Pallas path differs from `attention_ref` by ~0.1 there,
    `test_the_reference_pallas_path_diverges_there`).
    Rows with no allowed key are the mean of v in `attention_ref` (a
    softmax over equal -1e30 scores) and 0 in the Pallas kernel."""
    q, k, v = _inputs(2, T, S, 64, seed=T + S)
    got = _port(q, k, v, causal=causal, window=window)
    want = _jax(q, k, v, False, causal=causal, window=window)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if window:
        none = np.arange(T) >= S + window - 1
        np.testing.assert_allclose(got[:, none],
                                   np.broadcast_to(v.mean(1)[:, None],
                                                   got[:, none].shape),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("T,S,window", [(256, 160, 0), (256, 64, 32)])
def test_the_reference_pallas_path_diverges_there(T, S, window):
    """Why the shapes above are held to `attention_ref` alone: on them the
    JAX Pallas path (bq = bk = 128) agrees with `attention_ref` on the rows
    t < S and is wrong on rows t >= S: by up to 0.135 at these inputs
    without a window (padded keys), and by up to 2.76 with one (padded keys
    for t < S + window - 1, then 0 in place of the mean of v)."""
    q, k, v = _inputs(2, T, S, 64, seed=T + S)
    err = np.abs(_jax(q, k, v, True, causal=True, window=window)
                 - _jax(q, k, v, False, causal=True, window=window)
                 ).max(axis=(0, 2))
    assert err[:S].max() <= TOL
    assert err[S:].max() > 0.05, err[S:].max()


def test_spec_matches_the_jax_family():
    spec, jspec = registry.get("attention"), jreg.get("attention")
    assert spec.tol == jspec.tol == 2e-3
    assert spec.diff_argnums == tuple(jspec.diff_argnums) == (0, 1, 2)
    g = torch.Generator().manual_seed(0)
    assert [tuple(a.shape) for a in spec.make_inputs(g)] == [
        tuple(a.shape) for a in jspec.make_inputs(jax.random.PRNGKey(0))]


@pytest.mark.parametrize("window", [0, 48])
def test_gradients_match_jax_grad(window):
    """d _loss / d(q, k, v) through the port's entry against `jax.grad`
    of the JAX entry (its straight-through VJP), at `_make_inputs`'
    shape, within the family's tol."""
    q, k, v = _inputs(2, 160, 160, 64, seed=3)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = torch.autograd.grad(
        _loss(flash_attention(tq, tk, tv, causal=True, window=window)),
        (tq, tk, tv))
    want = jax.grad(lambda *a: jloss(jflash_attention(
        *a, causal=True, window=window, bq=128, bk=128, force_pallas=True)),
        (0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3,
                                   atol=2e-3)


@pytest.mark.parametrize("call,err,match", [
    (lambda: flash_attention_cuda(torch.zeros(2, 8, 4), torch.zeros(2, 6, 4),
                                  torch.zeros(2, 6, 4)),
     ValueError, "CUDA tensors"),
    (lambda: flash_attention_cuda(torch.zeros(2, 8, 4, dtype=torch.float16),
                                  torch.zeros(2, 6, 4, dtype=torch.float16),
                                  torch.zeros(2, 6, 4, dtype=torch.float16)),
     TypeError, "dtype"),
    (lambda: flash_attention_cuda(torch.zeros(2, 8, 4),
                                  torch.zeros(2, 6, 4, dtype=torch.bfloat16),
                                  torch.zeros(2, 6, 4)),
     TypeError, "dtype"),
    (lambda: flash_attention_cuda(torch.zeros(2, 8, 4), torch.zeros(2, 6, 5),
                                  torch.zeros(2, 6, 5)),
     ValueError, "do not chain"),
    (lambda: flash_attention_cuda(torch.zeros(2, 8, 4), torch.zeros(3, 6, 4),
                                  torch.zeros(3, 6, 4)),
     ValueError, "do not chain"),
    (lambda: flash_attention_cuda(torch.zeros(2, 8, 4), torch.zeros(2, 6, 4),
                                  torch.zeros(2, 7, 4)),
     ValueError, "do not chain"),
    (lambda: flash_attention_cuda(torch.zeros(8, 4), torch.zeros(6, 4),
                                  torch.zeros(6, 4)),
     ValueError, "do not chain"),
    (lambda: flash_attention_cuda(torch.zeros(2, 8, 257),
                                  torch.zeros(2, 6, 257),
                                  torch.zeros(2, 6, 257)),
     ValueError, "head dim"),
    (lambda: flash_attention_cuda(torch.zeros(2, 4, 8).transpose(1, 2),
                                  torch.zeros(2, 6, 4), torch.zeros(2, 6, 4)),
     ValueError, "contiguous"),
])
def test_cuda_wrapper_refuses(call, err, match):
    """The wrapper never runs the plain version: CPU tensors, other dtypes,
    shapes that do not chain and head dims over 256 raise."""
    registry.reset_launches()
    with pytest.raises(err, match=match):
        call()
    assert registry.launch_counts()["attention"] == 0


@pytest.mark.parametrize("causal,window,need", [
    (True, 0, (True, True, True)), (True, 48, (True, False, True)),
    (False, 0, (False, True, False))])
def test_straight_through_backward_is_the_plain_vjp(monkeypatch, causal,
                                                    window, need):
    """With the plain version in place of the launch (no card here),
    `_FlashST`'s gradients equal autograd through the plain version, for
    the inputs that need them."""
    monkeypatch.setattr(ops, "_launch", lambda q, k, v, c, w: attention_ref(
        q, k, v, causal=c, window=w))
    q, k, v = _inputs(2, 160, 96, 32, seed=7)

    def grads(fn):
        ts = [torch.from_numpy(a).requires_grad_(n)
              for a, n in zip((q, k, v), need)]
        loss = _loss(fn(*ts))
        return torch.autograd.grad(loss, [t for t, n in zip(ts, need) if n])

    got = grads(lambda *a: _FlashST.apply(*a, causal, window))
    want = grads(lambda *a: attention_ref(*a, causal=causal, window=window))
    assert len(got) == sum(need)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# The tensor-core route's split over KV, on the CPU through its plain
# version `attention_split_ref`, held against the JAX `attention_ref` at
# fp32 (both compute in fp32; 2e-5 bounds their different sum orders and
# exp2 against exp). `tiles` are (bq, bk): the kernel's 128 and a small 32
# that gives each q tile more KV tiles to cut.
SPLIT_TOL = 2e-5
SPLIT_CASES = [
    (2, 384, 640, 64, True, 128),     # T != S, a window
    (2, 256, 256, 64, True, 0),       # causal: later splits of early tiles
    (2, 100, 77, 32, False, 20),      # non-causal window, T != S, ragged
    (2, 256, 64, 64, True, 32),       # rows with no allowed key
    (2, 256, 64, 16, False, 32),
    (2, 256, 160, 64, True, 0),       # padded keys: S not a tile multiple
    (3, 200, 330, 16, True, 64),      # T not a multiple of the tile
]


@pytest.mark.parametrize("tiles", [(128, 128), (32, 32)], ids=["128", "32"])
@pytest.mark.parametrize("nsplit", [1, 2, 3, 7])
@pytest.mark.parametrize("BH,T,S,d,causal,window", SPLIT_CASES)
def test_split_ref_matches_jax_attention_ref(BH, T, S, d, causal, window,
                                             nsplit, tiles):
    q, k, v = _inputs(BH, T, S, d, seed=T * 7 + S + nsplit)
    got = ops.attention_split_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                  nsplit, causal=causal, window=window,
                                  bq=tiles[0], bk=tiles[1]).numpy()
    want = _jax(q, k, v, False, causal=causal, window=window)
    np.testing.assert_allclose(got, want, rtol=SPLIT_TOL, atol=SPLIT_TOL)


def _split_key_ranges(T, S, causal, window, nsplit, bq, bk):
    """[(q rows, [(first key, end key) per split])] as the kernel cuts
    them (`ref._tile_range`, then split s takes tiles j_lo + s n / nsplit
    up to j_lo + (s + 1) n / nsplit)."""
    from repro_torch.kernels.attention.ref import _tile_range
    out = []
    for q0 in range(0, T, bq):
        t_last = min(q0 + bq, T) - 1
        lo, hi = _tile_range(q0, t_last, S, causal, window, bk)
        n = hi - lo + 1
        out.append((range(q0, t_last + 1), [
            ((lo + s * n // nsplit) * bk,
             min((lo + (s + 1) * n // nsplit) * bk, S))
            for s in range(nsplit)]))
    return out


@pytest.mark.parametrize("BH,T,S,d,causal,window,nsplit,tiles,what", [
    (2, 384, 640, 64, True, 128, 7, (32, 32), "masked"),
    (2, 256, 256, 64, True, 0, 7, (128, 128), "empty"),
    (2, 256, 64, 64, True, 32, 3, (32, 32), "none"),
])
def test_split_cases_reach_the_edges(BH, T, S, d, causal, window, nsplit,
                                     tiles, what):
    """The split cases above hold what the kernel must get right: a split
    whose keys are all masked for some of its rows (m = -1e30, l = 0), a
    split with no tile, and rows with no allowed key spread over splits."""
    ranges = _split_key_ranges(T, S, causal, window, nsplit, *tiles)
    found = False
    for rows, splits in ranges:
        for a, b in splits:
            if what == "empty":
                found |= b <= a
                continue
            for t in rows:
                keys = np.arange(a, b)
                ok = np.ones(len(keys), bool)
                if causal:
                    ok &= t - keys >= 0
                if window > 0:
                    ok &= t - keys < window
                none = window > 0 and t >= S + window - 1
                if what == "masked":
                    found |= len(keys) > 0 and not ok.any() and not none
                else:
                    found |= none and len(keys) > 0 and len(splits) > 1
    assert found
    q, k, v = _inputs(BH, T, S, d, seed=11)
    got = ops.attention_split_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                  nsplit, causal=causal, window=window,
                                  bq=tiles[0], bk=tiles[1]).numpy()
    np.testing.assert_allclose(got, _jax(q, k, v, False, causal=causal,
                                         window=window),
                               rtol=SPLIT_TOL, atol=SPLIT_TOL)


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("BH,T,S,d,dtype,sms,route,nsplit", [
    (12, 32768, 32768, 128, BF16, 132, ops.TENSOR_CORES, 1),   # qwen2_32k
    (32, 32768, 32768, 64, BF16, 132, ops.TENSOR_CORES, 1),    # zamba2
    (17, 128, 1 << 20, 128, BF16, 132, ops.TENSOR_CORES, 16),  # int64
    (2, 256, 256, 64, BF16, 132, ops.TENSOR_CORES, 2),   # one split a tile
    (2, 256, 64, 64, BF16, 132, ops.TENSOR_CORES, 1),    # one KV tile
    (4, 512, 512, 128, BF16, 132, ops.TENSOR_CORES, 4),
    (132, 128, 4096, 64, BF16, 132, ops.TENSOR_CORES, 2),
    (264, 128, 4096, 64, BF16, 132, ops.TENSOR_CORES, 1),  # 2 CTAs an SM
    (1, 128, 1 << 24, 128, BF16, 132, ops.TENSOR_CORES, ops.MAX_SPLITS),
    (17, 128, 1 << 20, 128, BF16, 66, ops.TENSOR_CORES, 8),  # half the SMs
    (4, 1024, 1024, 64, F32, 132, ops.CUDA_CORES, 1),      # bench
    (2, 256, 256, 64, F32, 132, ops.CUDA_CORES, 1),
    (2, 256, 256, 96, BF16, 132, ops.CUDA_CORES, 1),       # other d
    (2, 160, 160, 16, BF16, 132, ops.CUDA_CORES, 1),
    (2, 130, 130, 256, BF16, 132, ops.CUDA_CORES, 1),
    (2, 70, 70, 1, BF16, 132, ops.CUDA_CORES, 1),
    (2, 8, 0, 64, BF16, 132, ops.CUDA_CORES, 1),           # no key
])
def test_route_and_split_plan(BH, T, S, d, dtype, sms, route, nsplit):
    """`plan_call` is a pure function of the shapes, the dtype and the SM
    count: the tensor cores for bf16 at d = 64 or 128, split while the
    grid is under two CTAs an SM, at most a chunk per KV tile."""
    plan = ops.plan_call(BH, T, S, d, dtype, sms)
    assert plan == ops.AttentionPlan(route, nsplit)
    assert ops.pick_route(dtype, d, S) == route
    if route == ops.TENSOR_CORES:
        assert ops.plan_split(BH, T, S, sms) == nsplit


def test_tile_constants_are_the_kernels():
    """The planner's tiles are the tensor-core kernel's."""
    src = (ops._build.CSRC / "flash_attention.cu").read_text()
    assert f"constexpr int TC_BQ = {ops.TC_BLOCK_Q};" in src
    assert f"constexpr int TC_BK = {ops.TC_BLOCK_K};" in src


@pytest.mark.parametrize("shape,dtype,want", [
    ((2, 256, 256, 64), BF16, ["flash_attention_bf16_tc",
                               "flash_attention_combine_bf16"]),
    ((12, 4096, 1024, 128), BF16, ["flash_attention_bf16_tc"]),
    ((2, 256, 256, 96), BF16, ["flash_attention_bf16"]),
    ((2, 256, 256, 64), F32, ["flash_attention_f32"]),
])
def test_wrapper_launches_the_planned_route(monkeypatch, shape, dtype,
                                            want):
    """With a recording stand-in for the library (no card here), a call
    makes the planned C calls, counts one launch each on the registry and
    on its route, and hands a split its scratch: (nsplit, BH, T, d) and
    (nsplit, BH, T, 2) fp32."""
    from contextlib import nullcontext
    from unittest import mock
    lib = mock.Mock(**{f"{n}.return_value": 0 for n in (
        "flash_attention_bf16_tc", "flash_attention_combine_bf16",
        "flash_attention_bf16", "flash_attention_f32")})
    monkeypatch.setattr(ops, "_check", lambda *a: None)
    monkeypatch.setattr(ops, "sm_count", lambda dev: 132)
    monkeypatch.setattr(ops._build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("S", (), {"cuda_stream": 0})())
    BH, T, S, d = shape
    q, k, v = (torch.zeros((BH, n, d), dtype=dtype) for n in (T, S, S))
    registry.reset_launches()
    before = ops.route_launch_counts()
    ops._launch(q, k, v, True, 0)
    calls = [(c[0], c.args) for c in lib.method_calls]
    assert [name for name, _ in calls] == want
    assert registry.launch_counts()["attention"] == len(want)
    after = ops.route_launch_counts()
    kinds = {"flash_attention_bf16_tc": ops.TENSOR_CORES,
             "flash_attention_combine_bf16": ops.COMBINE,
             "flash_attention_bf16": ops.CUDA_CORES,
             "flash_attention_f32": ops.CUDA_CORES}
    for kind in (ops.TENSOR_CORES, ops.CUDA_CORES, ops.COMBINE):
        assert after[kind] - before[kind] == sum(kinds[n] == kind
                                                 for n in want)
    if len(want) == 2:
        nsplit = ops.plan_split(BH, T, S, 132)
        tc_args, comb_args = calls[0][1], calls[1][1]
        assert tc_args[-2] == comb_args[-2] == nsplit > 1
        assert tc_args[4] == comb_args[0] and tc_args[5] == comb_args[1]
        assert comb_args[3] == BH * T and comb_args[4] == d
    registry.reset_launches()
