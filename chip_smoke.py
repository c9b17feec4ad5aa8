"""Chip smoke test: serve the SHD DH-SNN through `repro_torch` on one H100.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA device of compute capability 9.0 and `nvcc`; it builds
the hand kernels from `src/repro_torch/csrc/` and runs these phases. Any
failure raises and the script exits non-zero; no phase catches and
continues, and nothing falls back to the CPU.

1. device   the card, its compute capability, and its name and power limit
            as `nvidia-smi` reports them. TF32 is switched off for every
            PyTorch matmul and convolution before any comparison, so the
            plain versions run in full fp32.
2. build    `kernels/_build.py` compiles and links every CUDA source with
            one `nvcc -shared` call; prints the seconds and what ptxas
            reports of each kernel.
3. kernels  each kernel against its plain PyTorch version on the card, at
            the serving shapes of one window (window 32 x 64 sessions) and
            at ragged shapes (T=37, B=3, N=130, `lif` with both resets;
            spikemm 1000 x 700 x 257); no output may be all zero.
            `lif` and `linrec` must match bit for bit; `spikemm` within
            rtol = atol = 1e-5 (the fp32 sum order differs). Times each with
            CUDA events after warm-up: the kernel, its plain version and,
            for spikemm, `torch.matmul` as a yardstick (`library_ms`).
4. slice    serves `make_dhsnn_shd` at 700 -> 64 (x4 branches) -> 20 with
            weights from torch.Generator seed 0, EngineConfig(window=32,
            capacity=64), 128 sessions of SHD-like rasters (96..152 steps,
            ragged chunks 17/23/31/40). Checks:
            * every launch counter grew by launches-per-window x windows;
            * the engine's outputs equal a one-shot `plan.run` of all
              sessions on the card bit for bit (cohorts, windows, packing
              and the state cache change nothing);
            * the card against the CPU (plain versions, same weights):
              hidden spike trains under the threshold-tie rule (a lane may
              differ only from a step where the CPU reference's pre-reset
              membrane lies within 1e-5 of threshold, computed here in
              float64), readouts within 1e-4 before each session's first
              divergence, for `plan.run` and for the engine; the hidden
              layer must fire in at least 1 % of its lane-steps, and the
              final states of the rows that never diverged agree within
              1e-4 (rtol and atol);
            * one session solo against packed: bit-identical on the card;
            then the homogeneous ablation (dendritic=False), briefly, with
            32 sessions. With these weights it is almost silent on SHD-like
            rasters (about 0.03 % of lane-steps fire), so it is fed i.i.d.
            Bernoulli rasters at rate 0.2 (numpy seed 0), on which it fires
            in about 4 %; the same 1 % floor holds.
            Latency and sessions/s pool REPLAYS timed replays of the trace
            (fresh engines); the launch counts come from the first.
5. result   prints `{"kernels": [...]}`, `{"slice": {...}}` and, last,
            `{"ok": true, "device": {...}}`.

Bounds (`bound_ms`) are computed from this run's inputs against the H100
SXM's published peaks: 67 TFLOP/s fp32 (CUDA cores) and 3.35 TB/s HBM,
each input byte read once and each output byte written once. spikemm's
operations are what its product needs on this run's raster, 2 * nnz * N,
whatever tiling a kernel chooses; `bound_dense_ms` beside it counts the
dense product, 2 * M * K * N. The kernel table is held to `bound_ms`.
For linrec and lif, whose work does not depend on the data, the two
bounds are the same.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
WINDOW, CAPACITY = 32, 64
N_IN, N_HIDDEN, N_OUT, N_BRANCHES = 700, 64, 20, 4
N_SESSIONS = 128
REPLAYS = 5            # timed replays of the trace pooled for latency
SPIKEMM_TOL = 1e-5
READOUT_TOL = 1e-4
# the least share of hidden lane-steps that must fire for a card-vs-CPU
# comparison of a layer to count as a check
MIN_HIDDEN_RATE = 0.01
# the homogeneous ablation's input: i.i.d. Bernoulli spikes at this rate
# (it is almost silent on SHD-like rasters)
HOMOGENEOUS_INPUT_RATE = 0.2

SOURCES = {
    "spikemm": ("src/repro_torch/csrc/spikemm.cu",
                "src/repro/kernels/spikemm/kernel.py:52"),
    "linrec": ("src/repro_torch/csrc/linrec.cu",
               "src/repro/kernels/linrec/kernel.py:68"),
    "lif": ("src/repro_torch/csrc/lif.cu",
            "src/repro/kernels/lif/kernel.py:61"),
}


def log(*a):
    print(*a, flush=True)


def sync():
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA device")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability (9, 0) for "
                         f"sm_90a, got {cap}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
        f"capability {cap}; TF32 off for matmul and cuDNN")
    log(smi)
    return smi


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    secs = time.perf_counter() - t0
    log(f"build: {secs:.1f} s ({len(_build.sources())} sources, one nvcc "
        f"call, {lib.parent})")
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "registers" in line or "bytes stack" in line or "error" in line:
            log("  " + line.strip())
    return secs


# ---------------------------------------------------------------------------
# 3. kernels
# ---------------------------------------------------------------------------


_SLEEP_CYCLES_PER_MS = None


def sleep_cycles_per_ms():
    """How many `torch.cuda._sleep` cycles the card spins per millisecond,
    measured once with CUDA events."""
    global _SLEEP_CYCLES_PER_MS
    if _SLEEP_CYCLES_PER_MS is None:
        cycles = 10_000_000
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        sync()
        _SLEEP_CYCLES_PER_MS = cycles / start.elapsed_time(end)
    return _SLEEP_CYCLES_PER_MS


def cuda_ms(fn, iters, warmup=3):
    """Device ms per call of `fn`, from CUDA events.

    The calls are queued behind a `torch.cuda._sleep` that outlasts the
    host's time to issue all of them, so the events bracket the card's own
    work (for a wrapper, every kernel it launches) with no host gaps
    between calls. The sleep's length comes from its measured rate and the
    host's measured issue time."""
    for _ in range(warmup):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    issue_ms = (time.perf_counter() - t0) * 1e3
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * issue_ms * sleep_cycles_per_ms()) + 1000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


def bound(bytes_, flops):
    t_bytes = bytes_ / PEAK_HBM_BYTES * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def serving_inputs(params):
    """The tensors one cold serving window hands each kernel: a 32-step
    window of 64 SHD-like sessions through the DH-SNN, chained through the
    kernels themselves."""
    from repro_torch.data.spikes import gen_shd_spikes
    from repro_torch.kernels.lif.ops import lif_cuda
    from repro_torch.kernels.linrec.ops import linrec_cuda
    from repro_torch.kernels.spikemm.ops import spikemm_cuda
    dev = DEV
    x = gen_shd_spikes(CAPACITY, T=WINDOW, seed=7,
                       n_in=N_IN)[0].transpose(1, 0, 2)
    s_in = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    s_in = s_in.reshape(WINDOW * CAPACITY, N_IN)
    w = params["hidden"]["w_input"]
    w2 = w.permute(1, 0, 2).reshape(N_IN, N_BRANCHES * N_HIDDEN).contiguous()
    nb = params["hidden"]["neuron"]
    tau_d = torch.sigmoid(nb["w_tau_d"]).reshape(-1)
    tau_s = torch.sigmoid(nb["w_tau_s"]).contiguous()
    cur = spikemm_cuda(s_in, w2).reshape(WINDOW, CAPACITY, -1)
    a_br = tau_d.expand(cur.shape)
    h0_br = torch.zeros(CAPACITY, N_BRANCHES * N_HIDDEN, device=dev)
    d, _ = linrec_cuda(a_br, cur, h0_br)
    d4 = d.reshape(WINDOW, CAPACITY, N_BRANCHES, N_HIDDEN)
    soma = d4[:, :, 0]
    for k in range(1, N_BRANCHES):
        soma = soma + d4[:, :, k]
    soma = soma.contiguous()
    v0 = torch.zeros(CAPACITY, N_HIDDEN, device=dev)
    spk, _ = lif_cuda(soma, tau_s, v0, 1.0, "zero")
    s_h = spk.reshape(WINDOW * CAPACITY, N_HIDDEN)
    w_out = params["readout"]["w_hidden"]
    cur_o = spikemm_cuda(s_h, w_out).reshape(WINDOW, CAPACITY, N_OUT)
    a_o = torch.full((N_OUT,), 0.97, device=dev).expand(cur_o.shape)
    h0_o = torch.zeros(CAPACITY, N_OUT, device=dev)
    g = torch.Generator().manual_seed(3)
    ragged_s = (torch.rand((1000, N_IN), generator=g) < 0.012).float()
    ragged_lif = ((0.6 * torch.randn((37, 3, 130), generator=g)).to(dev),
                  (0.7 + 0.28 * torch.rand((130,), generator=g)).to(dev),
                  torch.zeros((3, 130), device=dev))
    return {
        "spikemm": [("hidden INTEG", (s_in, w2)),
                    ("readout INTEG", (s_h, w_out)),
                    ("ragged", (ragged_s.to(dev),
                                torch.randn((N_IN, 257), generator=g).to(dev)))],
        "linrec": [("DH-LIF branches", (a_br, cur, h0_br)),
                   ("LI readout", (a_o, cur_o, h0_o)),
                   ("ragged, full decay plane", (
                       (0.5 + 0.49 * torch.rand((37, 3, 130), generator=g)
                        ).to(dev),
                       torch.randn((37, 3, 130), generator=g).to(dev),
                       torch.randn((3, 130), generator=g).to(dev)))],
        "lif": [("DH-LIF soma", (soma, tau_s, v0)),
                ("ragged, zero reset", (*ragged_lif, 1.0, "zero")),
                ("ragged, subtract reset", (*ragged_lif, 1.0, "subtract"))],
    }


def work(name, args):
    """(bytes moved, fp32 operations) one call needs on these inputs.

    spikemm: each nonzero spike adds one row of w into its output row, so
    the product needs 2 * nnz * N operations (one multiply-add per term;
    an add alone takes the same issue slot at the fp32 peak), whatever
    blocking a kernel chooses."""
    if name == "spikemm":
        s, w = args
        M, K = s.shape
        N = w.shape[1]
        nnz = int(torch.count_nonzero(s))
        return 4 * (M * K + K * N + M * N), 2 * nnz * N
    if name == "linrec":
        a, x, h0 = args
        a_bytes = 4 * int(np.prod([n for n, st in zip(a.shape, a.stride())
                                   if st != 0]))
        return a_bytes + 4 * (2 * x.numel() + 2 * h0.numel()), 2 * x.numel()
    cur, tau, v0 = args[:3]                      # lif: mul, add, compare, reset
    return 4 * (2 * cur.numel() + tau.numel() + 2 * v0.numel()), \
        4 * cur.numel()


def dense_ops(name, args):
    """Operations of the same call with the data ignored: for spikemm the
    dense product, 2 * M * K * N; for linrec and lif, `work`'s count."""
    if name == "spikemm":
        s, w = args
        return 2 * s.shape[0] * s.shape[1] * w.shape[1]
    return work(name, args)[1]


def phase_kernels(params):
    from repro_torch.kernels.lif.ops import lif_cuda, lif_scan_ref
    from repro_torch.kernels.linrec.ops import linrec_cuda, linrec_ref
    from repro_torch.kernels.spikemm.ops import spikemm_cuda, spikemm_ref
    cuda = {"spikemm": spikemm_cuda, "linrec": linrec_cuda, "lif": lif_cuda}
    plain = {"spikemm": spikemm_ref, "linrec": linrec_ref,
             "lif": lif_scan_ref}
    inputs = serving_inputs(params)
    results = {}
    for name, cases in inputs.items():
        calls, max_err = [], 0.0
        for label, args in cases:
            got = cuda[name](*args)
            ref = plain[name](*args)
            sync()
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            for g, r in zip(got, ref):
                if not torch.isfinite(g).all():
                    raise AssertionError(f"{name} [{label}]: non-finite")
                if not g.abs().sum() > 0:
                    raise AssertionError(f"{name} [{label}]: all zero, the "
                                         "comparison would be vacuous")
                err = float((g - r).abs().max())
                max_err = max(max_err, err)
                if name == "spikemm":
                    torch.testing.assert_close(g, r, rtol=SPIKEMM_TOL,
                                               atol=SPIKEMM_TOL)
                elif not torch.equal(g, r):
                    raise AssertionError(
                        f"{name} [{label}]: not bit-identical to its plain "
                        f"version (max abs err {err:.3e})")
            if label.startswith("ragged"):
                shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
                log(f"kernel {name} [{label}] {shapes}: "
                    f"matches plain (max abs err {max_err:.3e})")
                continue
            ms = cuda_ms(lambda: cuda[name](*args), iters=200)
            p_ms = cuda_ms(lambda: plain[name](*args), iters=20)
            lib = (cuda_ms(lambda: torch.matmul(*args), iters=200)
                   if name == "spikemm" else None)
            nbytes, flops = work(name, args)
            b_ms, b_by = bound(nbytes, flops)
            d_ms, d_by = bound(nbytes, dense_ops(name, args))
            calls.append({"call": label,
                          "shape": [list(a.shape) for a in args],
                          "ms": ms, "plain_ms": p_ms,
                          "library_ms": lib,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "bound_dense_ms": d_ms, "bound_dense_by": d_by,
                          "bytes": nbytes, "flops": flops})
            log(f"kernel {name} [{label}]: {ms:.4f} ms on the card "
                f"(plain {p_ms:.4f}, "
                f"library {lib if lib is None else round(lib, 4)}, bound "
                f"{b_ms:.5f} by {b_by}, dense bound {d_ms:.5f} by {d_by}); "
                f"max abs err so far {max_err:.3e}")
        src, rep = SOURCES[name]
        top = max(calls, key=lambda c: c["bound_ms"])
        results[name] = {
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": None, "max_abs_err": max_err,
            "ms": sum(c["ms"] for c in calls),
            "plain_ms": sum(c["plain_ms"] for c in calls),
            "bound_ms": sum(c["bound_ms"] for c in calls),
            "bound_by": top["bound_by"],
            "bound_dense_ms": sum(c["bound_dense_ms"] for c in calls),
            "library_ms": (sum(c["library_ms"] for c in calls)
                           if name == "spikemm" else None),
            "per_window_calls": calls}
    return results


# ---------------------------------------------------------------------------
# 4. slice
# ---------------------------------------------------------------------------


def make_model(dendritic, device):
    """The SHD model at the published widths, weights from seed 0 (drawn on
    the CPU, so every device gets the same ones)."""
    from repro_torch.core.snn_layers import make_dhsnn_shd
    return make_dhsnn_shd(torch.Generator().manual_seed(0), n_in=N_IN,
                          n_hidden=N_HIDDEN, n_out=N_OUT,
                          n_branches=N_BRANCHES, dendritic=dendritic,
                          device=device)


def make_trace(n_sessions, seed=0, rate=None):
    """[(round, sid, chunk)]: session i arrives at round i % 8 and submits
    one chunk per round (sizes cycling 17/23/31/40) of its 96 + 8 * (i % 8)
    step raster: SHD-like (`gen_shd_spikes`), or i.i.d. Bernoulli(`rate`)
    spikes from numpy's generator with `seed`."""
    from repro_torch.data.spikes import gen_shd_spikes
    if rate is None:
        x, _ = gen_shd_spikes(n_sessions, T=152, seed=seed, n_in=N_IN)
    else:
        x = (np.random.default_rng(seed).random((n_sessions, 152, N_IN))
             < rate).astype(np.float32)
    sizes = (17, 23, 31, 40)
    ev, streams = [], {}
    for i in range(n_sessions):
        sid = f"s{i}"
        total = 96 + 8 * (i % 8)
        streams[sid] = x[i, :total]
        off, r = 0, i % 8
        while off < total:
            n = min(sizes[(i + r) % len(sizes)], total - off)
            ev.append((r, sid, streams[sid][off:off + n]))
            off += n
            r += 1
    ev.sort(key=lambda e: e[0])
    return ev, streams


def replay(eng, trace, latencies=None):
    """Drive the trace through an engine (a window per round boundary,
    then drain); per-window host latency of each step() that served a
    cohort, synchronized with the card, goes into `latencies`."""
    last = {}
    for r, sid, _ in trace:
        last[sid] = max(last.get(sid, -1), r)

    def step():
        t0 = time.perf_counter()
        n = eng.step()
        if eng.device.type == "cuda":
            sync()
        if n and latencies is not None:
            latencies.append(time.perf_counter() - t0)
        return n

    cur = 0
    for r, sid, chunk in trace:
        while r > cur:
            step()
            cur += 1
        if sid not in eng.scheduler.sessions:
            eng.open(sid)
        if not eng.submit(sid, chunk):
            raise AssertionError(f"submit rejected for {sid}")
        if last[sid] == r:
            eng.close(sid)
    while step():
        pass
    return eng


def per_window_launches(dendritic):
    return ({"spikemm": 2, "linrec": 2, "lif": 1} if dendritic
            else {"spikemm": 2, "linrec": 1, "lif": 1})


def device_profile(eng_factory, trace):
    """Card time per window, by kernel, over one replay traced with
    torch.profiler: (total ms per window, {kernel: ms per window}), or
    (None, {}) when the trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    eng = eng_factory()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        replay(eng, trace)
        sync()
    wins = eng.metrics.windows_run
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + \
                ev.device_time_total / 1e3 / wins
    if not by_name:
        return None, {}
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:10])
    return sum(by_name.values()), top


def host_breakdown(eng, trace):
    """Mean ms per served window in each host-side stage of
    `engine.step()`, from spans recorded around the calls into each layer
    (each span synchronizes the card, so stages do not overlap here as
    they may in the untraced run). "other" is the rest of step()."""
    from repro_torch.core import plan as plan_mod
    spans, total = {}, []

    def span(name, fn):
        def timed(*a, **k):
            sync()
            t0 = time.perf_counter()
            r = fn(*a, **k)
            sync()
            spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0
            return r
        return timed

    saved = {n: getattr(plan_mod, n) for n in ("pack_states", "run",
                                               "unpack_state")}
    try:
        for n, fn in saved.items():
            setattr(plan_mod, n, span(f"plan.{n}", fn))
        eng._window = span("input window to card", eng._window)
        eng.cache.get = span("cache.get", eng.cache.get)
        eng.cache.put = span("cache.put", eng.cache.put)
        eng.scheduler.next_cohort = span("scheduler.next_cohort",
                                         eng.scheduler.next_cohort)
        replay(eng, trace, total)
    finally:
        for n, fn in saved.items():
            setattr(plan_mod, n, fn)
    wins = eng.metrics.windows_run
    out = {k: v * 1e3 / wins for k, v in spans.items()}
    out["step total"] = sum(total) * 1e3 / wins
    out["other"] = out["step total"] - sum(v for k, v in out.items()
                                           if k != "step total")
    return out


def load_tie_rule():
    """The threshold-tie helper the tests use, `tests/_torch_parity.py`,
    loaded from the checkout by path (a top-level `tests` package installed
    elsewhere would shadow the repo's `tests` directory)."""
    path = ROOT / "tests" / "_torch_parity.py"
    spec = importlib.util.spec_from_file_location("_torch_parity", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_slice(dendritic, n_sessions, smi, timed=True):
    from repro_torch.core import plan
    from repro_torch.kernels import registry
    from repro_torch.serve import EngineConfig, make_engine
    from repro_torch.weights import params_to_numpy
    tie = load_tie_rule()
    hidden_membrane, max_err_before, tie_rule = (
        tie.hidden_membrane, tie.max_err_before, tie.tie_rule)

    tag = "dendritic" if dendritic else "homogeneous"
    nodes, params = make_model(dendritic, DEV)
    nodes_c, params_c = make_model(dendritic, "cpu")
    cfg = EngineConfig(window=WINDOW, capacity=CAPACITY, queue_limit=None)
    trace, streams = make_trace(
        n_sessions, rate=None if dendritic else HOMOGENEOUS_INPUT_RATE)

    # warm-up outside the measured run: CUDA context, allocator, kernels
    replay(make_engine(nodes, params, cfg, device=DEV),
           make_trace(4, seed=1)[0])
    sync()

    # -- the main path: launch counters from 0 --------------------------------
    registry.reset_launches()
    lat, walls = [], []

    def timed_replay():
        t0 = time.perf_counter()
        e = replay(make_engine(nodes, params, cfg, device=DEV), trace, lat)
        sync()
        walls.append(time.perf_counter() - t0)
        return e

    eng = timed_replay()
    counts = registry.launch_counts()
    wins = eng.metrics.windows_run
    want = {k: v * wins for k, v in per_window_launches(dendritic).items()}
    if counts != want:
        raise AssertionError(f"[{tag}] launch counts {counts} != "
                             f"launches-per-window x {wins} windows {want}")
    log(f"slice [{tag}]: {n_sessions} sessions, {wins} windows, launches "
        f"{counts} ({per_window_launches(dendritic)} per window)")

    # -- the engine equals a one-shot plan.run of every session ---------------
    T = max(len(s) for s in streams.values())
    sids = sorted(streams, key=lambda s: int(s[1:]))
    x = np.zeros((T, len(sids), N_IN), np.float32)
    for b, sid in enumerate(sids):
        x[:len(streams[sid]), b] = streams[sid]
    xt = torch.from_numpy(x)
    st_gpu, o_gpu, r_gpu = plan.run(nodes, params, xt.to(DEV),
                                    record=("hidden",), device=DEV)
    st_cpu, o_cpu, r_cpu = plan.run(nodes_c, params_c, xt,
                                    record=("hidden",), device="cpu")
    o_gpu, o_cpu = o_gpu.cpu().numpy(), o_cpu.numpy()
    for b, sid in enumerate(sids):
        n = len(streams[sid])
        got = eng.outputs(sid)
        if got.shape != (n, N_OUT) or not np.all(np.isfinite(got)):
            raise AssertionError(f"[{tag}] {sid}: outputs {got.shape}, "
                                 f"expected finite ({n}, {N_OUT})")
        if not np.array_equal(got, o_gpu[:n, b]):
            raise AssertionError(f"[{tag}] {sid}: engine outputs differ from "
                                 "the one-shot plan.run on the card")

    # -- the card against the CPU, under the tie rule -------------------------
    s_cpu = r_cpu["hidden"].numpy()
    if not s_cpu.mean() >= MIN_HIDDEN_RATE:
        raise AssertionError(
            f"[{tag}] hidden layer fires in {s_cpu.mean():.4%} of its "
            f"lane-steps, under {MIN_HIDDEN_RATE:.0%}: the comparison "
            "would be vacuous")
    u = hidden_membrane(nodes_c[0], params_to_numpy(params_c)["hidden"], x,
                        s_cpu)
    first_div, n_ties = tie_rule(s_cpu, r_gpu["hidden"].cpu().numpy(), u,
                                 nodes[0].neuron.program.threshold.base)
    err_plan = max_err_before(o_cpu, o_gpu, first_div)
    if err_plan > READOUT_TOL:
        raise AssertionError(f"[{tag}] plan.run readout card vs CPU "
                             f"{err_plan:.3e} > {READOUT_TOL}")
    # final states (membranes, branch currents, readout) of the rows whose
    # hidden spikes never diverged: these carry every input of the run,
    # also where the hidden layer barely fires
    rows = torch.from_numpy(first_div >= T)
    err_state = 0.0
    for node in st_cpu:
        for k, ref in st_cpu[node].items():
            got = st_gpu[node][k].cpu()
            got, ref = (got[:, rows], ref[:, rows]) if k == "ring" else \
                (got[rows], ref[rows])
            torch.testing.assert_close(got, ref, rtol=READOUT_TOL,
                                       atol=READOUT_TOL,
                                       msg=lambda m: f"[{tag}] state "
                                       f"{node}.{k} card vs CPU: {m}")
            if got.numel():
                err_state = max(err_state, float((got - ref).abs().max()))
    eng_c = replay(make_engine(nodes_c, params_c, cfg, device="cpu"), trace)
    err_eng = 0.0
    for b, sid in enumerate(sids):
        t0_ = min(int(first_div[b]), len(streams[sid]))
        if t0_:
            err_eng = max(err_eng, float(np.max(np.abs(
                eng.outputs(sid)[:t0_] - eng_c.outputs(sid)[:t0_]))))
    if err_eng > READOUT_TOL:
        raise AssertionError(f"[{tag}] engine readout card vs CPU "
                             f"{err_eng:.3e} > {READOUT_TOL}")
    log(f"slice [{tag}]: card vs CPU: hidden spikes {int(s_cpu.sum())} "
        f"(rate {s_cpu.mean():.4f}), {n_ties} lanes flipped at threshold "
        f"ties, readout max abs err {err_plan:.3e} (plan.run), "
        f"{err_eng:.3e} (engine); final states of {int(rows.sum())} "
        f"undiverged rows max abs err {err_state:.3e}")

    # -- one session solo against packed --------------------------------------
    solo_sid = sids[0]
    solo = replay(make_engine(nodes, params, cfg, device=DEV),
                  [e for e in trace if e[1] == solo_sid])
    if not np.array_equal(solo.outputs(solo_sid), eng.outputs(solo_sid)):
        raise AssertionError(f"[{tag}] {solo_sid}: solo != packed outputs")
    st_solo, st_packed = solo.state_of(solo_sid), eng.state_of(solo_sid)
    for node in st_solo:
        for k in st_solo[node]:
            if not torch.equal(st_solo[node][k], st_packed[node][k]):
                raise AssertionError(f"[{tag}] {solo_sid}: solo != packed "
                                     f"state {node}.{k}")
    log(f"slice [{tag}]: {solo_sid} solo == packed, bit for bit")

    out = {"model": f"dhsnn_shd {N_IN}->{N_HIDDEN}x{N_BRANCHES}->{N_OUT}"
                    if dendritic else
                    f"dhsnn_shd homogeneous {N_IN}->{N_HIDDEN}->{N_OUT}",
           "window": WINDOW, "capacity": CAPACITY, "sessions": n_sessions,
           "windows": wins, "launches": counts,
           "input": ("gen_shd_spikes" if dendritic else
                     f"bernoulli({HOMOGENEOUS_INPUT_RATE})"),
           "hidden_spikes": int(s_cpu.sum()),
           "hidden_rate": float(s_cpu.mean()), "tie_flips": n_ties,
           "readout_max_abs_err": max(err_plan, err_eng),
           "state_max_abs_err": err_state}
    if timed:
        for _ in range(REPLAYS - 1):
            timed_replay()
        wall = float(np.median(walls))
        dev_ms, top = device_profile(
            lambda: make_engine(nodes, params, cfg, device=DEV), trace)
        host = host_breakdown(make_engine(nodes, params, cfg, device=DEV),
                              trace)
        steps = sum(len(s) for s in streams.values())
        mean_ms = float(np.mean(lat)) * 1e3
        out.update({
            "replays": len(walls), "window_samples": len(lat),
            "p50_window_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_window_ms": float(np.percentile(lat, 99)) * 1e3,
            "mean_window_ms": mean_ms,
            "sessions_per_s": n_sessions / wall,
            "steps_per_s": steps / wall,
            "median_replay_wall_s": wall,
            "device_ms_per_window": dev_ms,
            "device_busy_share": (None if dev_ms is None
                                  else dev_ms / mean_ms),
            "device_ms_per_window_by_kernel": top,
            "host_ms_per_window_by_stage": host,
            "card": smi})
    return out, counts


def main():
    smi = phase_device()
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    build_s = phase_build()
    _, params = make_model(True, DEV)
    kernels = phase_kernels(params)
    slice_d, counts = phase_slice(True, N_SESSIONS, smi)
    slice_h, _ = phase_slice(False, 32, smi, timed=False)
    for name, k in kernels.items():
        k["launches"] = counts[name]
        k["launches_per_window"] = per_window_launches(True)[name]
    slice_d["build_s"] = build_s
    slice_d["homogeneous"] = slice_h
    log(json.dumps({"kernels": list(kernels.values())}))
    log(json.dumps({"slice": slice_d}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
