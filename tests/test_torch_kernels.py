"""Port kernels held against the JAX package, on the CPU.

For `block_occupancy`, `spikemm`, `linrec` and `lif` (both resets), the
port's plain version (what `repro_torch` dispatch runs for CPU tensors)
is compared on the same numpy inputs with
  * the JAX reference, through `repro.kernels.registry.dispatch`, which
    picks the XLA reference off-TPU, and
  * the JAX Pallas kernel in interpret mode (`force_pallas=True`).
Shapes: the JAX `_make_inputs` shapes, plus a prime T=37 for the time
kernels. Tolerance: the family's `KernelSpec.tol` (1e-4) in both
packages. `block_occupancy` must match exactly.

The hand CUDA kernels themselves cannot run here (no card, no nvcc);
`chip_smoke.py` holds each one against its plain version on the card.
"""

import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import registry as jreg
from repro.kernels.common import pad_axis as jpad
from repro.kernels.spikemm.ops import block_occupancy as jblock_occupancy
from repro_torch.kernels import _build, registry
from repro_torch.kernels.lif.ops import lif_cuda, lif_scan
from repro_torch.kernels.linrec.ops import linrec, linrec_cuda
from repro_torch.kernels.spikemm.ops import (block_occupancy, spikemm,
                                             spikemm_cuda)

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


def test_registry_make_inputs_run_plain_on_cpu():
    """Every family's make_inputs runs through dispatch on the CPU, and the
    CPU path never counts a kernel launch."""
    registry.reset_launches()
    g = torch.Generator().manual_seed(0)
    for name in registry.names():
        out = registry.dispatch(name, registry.get(name).make_inputs(g))
        for o in (out if isinstance(out, tuple) else (out,)):
            assert torch.isfinite(o).all()
    assert registry.launch_counts() == {"lif": 0, "linrec": 0, "spikemm": 0}


def test_dispatch_rejects_mixed_devices():
    with pytest.raises(ValueError, match="span devices"):
        registry.on_cuda((torch.zeros(2), torch.zeros(2, device="meta")))


@pytest.mark.parametrize("call", [
    lambda: spikemm_cuda(torch.zeros(4, 3), torch.zeros(3, 2)),
    lambda: linrec_cuda(torch.ones(4), torch.zeros(5, 2, 4),
                        torch.zeros(2, 4)),
    lambda: lif_cuda(torch.zeros(5, 2, 4), torch.ones(4), torch.zeros(2, 4)),
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
    """Every source is compiled and linked for sm_90a by one `nvcc -shared`
    call into the digest directory; an unchanged tree reuses the build."""
    nvcc, calls = _fake_nvcc(tmp_path, 0)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    lib = _build.build()
    argv, = [json.loads(line) for line in calls.read_text().splitlines()]
    assert "-shared" in argv and "arch=compute_90a,code=sm_90a" in argv
    assert [a for a in argv if a.endswith(".cu")] == \
        [str(s) for s in _build.sources()]
    assert lib.parent.parent == tmp_path / "build" and lib.exists()
    assert {s.name for s in _build.sources()} >= {"spikemm.cu", "linrec.cu",
                                                  "lif.cu"}
    assert _build.build() == lib
    assert len(calls.read_text().splitlines()) == 1


def test_build_failure_raises(tmp_path, monkeypatch):
    nvcc, calls = _fake_nvcc(tmp_path, 1)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc exited 1"):
        _build.build()
    assert not list((tmp_path / "build").rglob(_build.LIB_NAME))


def test_build_root_is_the_checkout_or_a_user_cache(tmp_path, monkeypatch):
    """A checkout builds into its own git-ignored `build/`; an installed
    copy builds into the user's cache, never beside site-packages."""
    root = Path(__file__).resolve().parents[1]
    assert _build.build_root() == root / "build" / "repro_torch"
    monkeypatch.setattr(_build, "PKG", tmp_path / "site-packages" / "repro_torch")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert _build.build_root() == tmp_path / "cache" / "repro_torch"
