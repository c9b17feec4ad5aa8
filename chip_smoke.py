"""Chip smoke test: serve the paper's SNNs through `repro_torch` on one H100.

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
            the shapes one serving window of each path hands it (window
            32 x 64 sessions: the SHD DH-SNN's, the ECG SRNN's with a state
            ten windows into ECG records, and the ALIF feed-forward run's
            (250, 64, 64)) and at ragged shapes (T=37, B=3, N=130, `lif`
            with both resets; `lifrec`, `alif` and `alifrec` also at N=300
            and N=1024, from nonzero v0/a0/s0, so W_rec is held in shared
            memory at N=130 and read through L2 above, and N=1024 is the
            largest batch row the recurrent kernels take; spikemm
            1000 x 700 x 257);
            no output may be all zero. The time kernels must match bit for
            bit; `spikemm` within rtol = atol = 1e-5 (the fp32 sum order
            differs). Times each with CUDA events after warm-up: the
            kernel, its plain version and, for spikemm, `torch.matmul` as
            a yardstick (`library_ms`).
4. paths    each path served through the engine, with every launch counter
            set to 0 just before its run and read just after:
            * shd: `make_dhsnn_shd` at 700 -> 64 (x4 branches) -> 20, 128
              sessions of SHD-like rasters (96..152 steps);
            * shd_homogeneous: its LIF ablation, 32 sessions of
              Bernoulli(0.2) rasters (it is almost silent on SHD-like
              input), untimed;
            * ecg: `make_srnn_ecg` at 4 -> 64 self-recurrent ALIF -> 6 LI,
              128 sessions of `gen_ecg_qtdb` records, 1301 steps each;
            * ecg_homogeneous: its recurrent-LIF ablation, 32 sessions.
            Weights from torch.Generator seed 0, EngineConfig(window=32,
            capacity=64), ragged chunks 17/23/31/40 arriving over rounds.
            Checks for each:
            * every launch counter grew by launches-per-window x windows,
              and the other kernels' stayed at 0;
            * the engine's outputs equal a one-shot `plan.run` of all
              sessions on the card bit for bit (cohorts, windows, packing,
              the recurrence carried through state["out"] and the state
              cache change nothing);
            * the card against the CPU (plain versions, same weights):
              hidden spike trains under the threshold-tie rule (a lane may
              differ only from a step where the CPU reference's pre-reset
              membrane lies within 1e-5 of its threshold, computed here in
              float64; row-wise for the self-recurrent layers, where a
              flipped lane reaches the whole row through W_rec), readouts
              within 1e-4 before each session's first divergence, for
              `plan.run` and for the engine; the hidden layer must fire in
              at least 1 % of its lane-steps, and the final states of the
              rows that never diverged agree within 1e-4 (rtol and atol);
            * one session solo against packed: bit-identical on the card.
            Latency and sessions/s pool REPLAYS timed replays of the trace
            (fresh engines); the launch counts come from the first.
5. alif_ff  `benchmarks/bench_snn_engine.py`'s `shd_alif_ff` program
            (700 -> 64 ALIF(beta=0.5) -> 20 LI(tau=0.97)) through one
            `plan.run` of Bernoulli(0.2) input at T=250, B=64: the launch
            counters (`alif` among them), and the card against the CPU
            under the per-lane tie rule with the 1 % floor.
6. result   prints `{"kernels": [...]}`, one `{"slice": {...}}` line per
            path, the card's name and power limit and, last,
            `{"ok": true, "device": {...}}`.

Bounds (`bound_ms`) are computed from this run's inputs against the H100
SXM's published peaks: 67 TFLOP/s fp32 (CUDA cores) and 3.35 TB/s HBM,
each input byte read once and each output byte written once. spikemm's
operations are what its product needs on this run's raster, 2 * nnz * N,
whatever tiling a kernel chooses; the recurrent kernels' are their
elementwise steps plus 2 * nnz(s_{t-1}) * N for the spikes that feed the
next step. `bound_dense_ms` beside it counts the dense products instead,
2 * M * K * N and 2 * T * B * N * N. The kernel table is held to
`bound_ms`. For linrec, lif and alif, whose work does not depend on the
data, the two bounds are the same.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
WINDOW, CAPACITY = 32, 64
N_IN, N_HIDDEN, N_OUT, N_BRANCHES = 700, 64, 20, 4      # SHD DH-SNN
ECG_IN, ECG_HIDDEN, ECG_OUT, ECG_T = 4, 64, 6, 1301      # ECG SRNN
# ALIF feed-forward. The bench feeds Bernoulli(0.08), on which these
# weights fire in 1.01 % of hidden lane-steps, just over the floor below;
# at 0.2 (the rate of the SHD ablation's input) they fire in 2.11 %.
ALIF_T, ALIF_B, ALIF_RATE = 250, 64, 0.2
N_SESSIONS = 128
REPLAYS = 5            # timed replays of the trace pooled for latency
SPIKEMM_TOL = 1e-5
READOUT_TOL = 1e-4
# the least share of hidden lane-steps that must fire for a card-vs-CPU
# comparison of a layer to count as a check
MIN_HIDDEN_RATE = 0.01
# the SHD model's homogeneous ablation reads i.i.d. Bernoulli spikes at
# this rate (it is almost silent on SHD-like rasters)
HOMOGENEOUS_INPUT_RATE = 0.2

SOURCES = {
    "spikemm": ("src/repro_torch/csrc/spikemm.cu",
                "src/repro/kernels/spikemm/kernel.py:61"),
    "linrec": ("src/repro_torch/csrc/linrec.cu",
               "src/repro/kernels/linrec/kernel.py:79"),
    "lif": ("src/repro_torch/csrc/lif.cu",
            "src/repro/kernels/lif/kernel.py:70"),
    "lifrec": ("src/repro_torch/csrc/lifrec.cu",
               "src/repro/kernels/lifrec/kernel.py:76"),
    "alif": ("src/repro_torch/csrc/alifrec.cu",
             "src/repro/kernels/alifrec/kernel.py:77"),
    "alifrec": ("src/repro_torch/csrc/alifrec.cu",
                "src/repro/kernels/alifrec/kernel.py:159"),
}
# the path whose serving calls make up a kernel's row in the kernel table
HOME = {"spikemm": "shd", "linrec": "shd", "lif": "shd",
        "lifrec": "ecg_homogeneous", "alifrec": "ecg", "alif": "alif_ff"}
# elementwise fp32 operations per lane-step of the time kernels
LANE_OPS = {"lif": 4, "lifrec": 6, "alif": 9, "alifrec": 10}


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
# models and inputs
# ---------------------------------------------------------------------------


def make_shd(dendritic, device):
    """The SHD model at the published widths, weights from seed 0 (drawn on
    the CPU, so every device gets the same ones)."""
    from repro_torch.core.snn_layers import make_dhsnn_shd
    return make_dhsnn_shd(torch.Generator().manual_seed(0), n_in=N_IN,
                          n_hidden=N_HIDDEN, n_out=N_OUT,
                          n_branches=N_BRANCHES, dendritic=dendritic,
                          device=device)


def make_ecg(heterogeneous, device):
    """The ECG SRNN at the published widths (the `make_srnn_ecg`
    defaults), weights from seed 0."""
    from repro_torch.core.snn_layers import make_srnn_ecg
    return make_srnn_ecg(torch.Generator().manual_seed(0), n_in=ECG_IN,
                         n_hidden=ECG_HIDDEN, n_out=ECG_OUT,
                         heterogeneous=heterogeneous, device=device)


def make_alif_ff(device):
    """`benchmarks/bench_snn_engine.py`'s `shd_alif_ff` program at its
    widths, 700 -> 64 ALIF(beta=0.5) -> 20 LI(tau=0.97), with weights drawn
    as the bench draws them, from torch.Generator seed 0."""
    from repro_torch.core import events
    from repro_torch.core.neuron import ALIF, LI
    from repro_torch.core.snn_layers import ff_integrate
    from repro_torch.kernels.common import tree_to
    g = torch.Generator().manual_seed(0)
    nodes = [events.LayerNode("hidden", ALIF(beta=0.5), ff_integrate,
                              ("input",), N_HIDDEN),
             events.LayerNode("readout", LI(tau=0.97), ff_integrate,
                              ("hidden",), N_OUT)]
    params = {"hidden": {"w_input": torch.randn((N_IN, N_HIDDEN), generator=g)
                         / math.sqrt(N_IN),
                         "neuron": ALIF().param_init(g, (N_HIDDEN,))},
              "readout": {"w_hidden": torch.randn((N_HIDDEN, N_OUT),
                                                  generator=g) / 8.0}}
    return nodes, tree_to(params, device)


def shd_streams(n_sessions, seed=0, rate=None):
    """{sid: (steps, 700)}: session i streams 96 + 8 * (i % 8) steps of an
    SHD-like raster (`gen_shd_spikes`), or of i.i.d. Bernoulli(`rate`)
    spikes from numpy's generator with `seed`."""
    from repro_torch.data.spikes import gen_shd_spikes
    if rate is None:
        x, _ = gen_shd_spikes(n_sessions, T=152, seed=seed, n_in=N_IN)
    else:
        x = (np.random.default_rng(seed).random((n_sessions, 152, N_IN))
             < rate).astype(np.float32)
    return {f"s{i}": x[i, :96 + 8 * (i % 8)] for i in range(n_sessions)}


def ecg_streams(n_sessions, seed=0):
    """{sid: (1301, 4)}: one level-crossing-coded ECG record per session."""
    from repro_torch.data.spikes import gen_ecg_qtdb
    x, _ = gen_ecg_qtdb(n_sessions, seed=seed, T=ECG_T)
    return {f"s{i}": x[i] for i in range(n_sessions)}


def make_trace(streams):
    """[(round, sid, chunk)]: session i arrives at round i % 8 and submits
    one chunk per round, sizes cycling 17/23/31/40."""
    sizes = (17, 23, 31, 40)
    ev = []
    for i, (sid, x) in enumerate(streams.items()):
        off, r = 0, i % 8
        while off < len(x):
            n = min(sizes[(i + r) % len(sizes)], len(x) - off)
            ev.append((r, sid, x[off:off + n]))
            off += n
            r += 1
    ev.sort(key=lambda e: e[0])
    return ev


def side_by_side(streams, n_in):
    """(T_max, n_sessions, n_in) input of every session, zero-padded."""
    T = max(len(v) for v in streams.values())
    x = np.zeros((T, len(streams), n_in), np.float32)
    for b, v in enumerate(streams.values()):
        x[:len(v), b] = v
    return x


@dataclasses.dataclass(frozen=True)
class ServePath:
    name: str
    model: str
    make_model: Callable
    streams: Callable[[], Dict[str, np.ndarray]]
    per_window: Dict[str, int]
    input: str
    timed: bool = True


PATHS = (
    ServePath("shd", f"dhsnn_shd {N_IN}->{N_HIDDEN}x{N_BRANCHES}->{N_OUT}",
              lambda dev: make_shd(True, dev),
              lambda: shd_streams(N_SESSIONS),
              {"spikemm": 2, "linrec": 2, "lif": 1}, "gen_shd_spikes"),
    ServePath("shd_homogeneous",
              f"dhsnn_shd homogeneous {N_IN}->{N_HIDDEN}->{N_OUT}",
              lambda dev: make_shd(False, dev),
              lambda: shd_streams(32, rate=HOMOGENEOUS_INPUT_RATE),
              {"spikemm": 2, "linrec": 1, "lif": 1},
              f"bernoulli({HOMOGENEOUS_INPUT_RATE})", timed=False),
    ServePath("ecg", f"srnn_ecg {ECG_IN}->{ECG_HIDDEN} recurrent "
              f"ALIF->{ECG_OUT}", lambda dev: make_ecg(True, dev),
              lambda: ecg_streams(N_SESSIONS),
              {"spikemm": 2, "alifrec": 1, "linrec": 1}, "gen_ecg_qtdb"),
    ServePath("ecg_homogeneous", f"srnn_ecg homogeneous {ECG_IN}->"
              f"{ECG_HIDDEN} recurrent LIF->{ECG_OUT}",
              lambda dev: make_ecg(False, dev), lambda: ecg_streams(32),
              {"spikemm": 2, "lifrec": 1, "linrec": 1}, "gen_ecg_qtdb"),
)


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


def _decays(params):
    nb = params["hidden"]["neuron"]
    return (torch.sigmoid(nb["w_tau"]).contiguous(),
            torch.sigmoid(nb["w_rho"]).contiguous())


def shd_window(params):
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
    return {
        "spikemm": [("hidden INTEG", (s_in, w2)),
                    ("readout INTEG", (s_h, w_out))],
        "linrec": [("DH-LIF branches", (a_br, cur, h0_br)),
                   ("LI readout", (a_o, cur_o, h0_o))],
        "lif": [("DH-LIF soma", (soma, tau_s, v0))]}


def ecg_window(heterogeneous):
    """What the 11th 32-step window of 64 ECG records hands each kernel:
    the state after 10 windows of `plan.run` on the card, then the
    window's INTEG, hidden layer and readout chained through the
    kernels."""
    from repro_torch.core import plan
    from repro_torch.kernels.alifrec.ops import alifrec_cuda
    from repro_torch.kernels.lifrec.ops import lifrec_cuda
    from repro_torch.kernels.spikemm.ops import spikemm_cuda
    nodes, params = make_ecg(heterogeneous, DEV)
    x = torch.from_numpy(side_by_side(ecg_streams(CAPACITY, seed=5),
                                      ECG_IN)[:11 * WINDOW]).to(DEV)
    st, _, _ = plan.run(nodes, params, x[:10 * WINDOW], device=DEV)
    hp = params["hidden"]
    s_in = x[10 * WINDOW:].reshape(WINDOW * CAPACITY, ECG_IN).contiguous()
    cur = spikemm_cuda(s_in, hp["w_input"]).reshape(WINDOW, CAPACITY, -1)
    h = st["hidden"]
    if heterogeneous:
        tau, rho = _decays(params)
        name = "alifrec"
        args = (cur, hp["w_self"], tau, rho, h["v"], h["a"], h["out"], 1.0,
                0.5)
        spk = alifrec_cuda(*args)[0]
    else:
        tau = torch.full((ECG_HIDDEN,), 0.9, device=DEV)
        name = "lifrec"
        args = (cur, hp["w_self"], tau, h["v"], h["out"], 1.0)
        spk = lifrec_cuda(*args)[0]
    s_h = spk.reshape(WINDOW * CAPACITY, ECG_HIDDEN)
    w_out = params["readout"]["w_hidden"]
    cur_o = spikemm_cuda(s_h, w_out).reshape(WINDOW, CAPACITY, ECG_OUT)
    a_o = torch.full((ECG_OUT,), 0.95, device=DEV).expand(cur_o.shape)
    return {name: [("ECG hidden", args)],
            "spikemm": [("ECG input INTEG, K=4", (s_in, hp["w_input"])),
                        ("ECG readout INTEG, N=6", (s_h, w_out))],
            "linrec": [("ECG LI readout", (a_o, cur_o,
                                           st["readout"]["v"]))]}


def alif_ff_run_inputs():
    """The `alif` call of the ALIF feed-forward path: the hidden layer of
    one `plan.run` of Bernoulli(ALIF_RATE) input at T=250, B=64, from
    cold."""
    from repro_torch.kernels.spikemm.ops import spikemm_cuda
    _, params = make_alif_ff(DEV)
    x = torch.from_numpy(alif_ff_input()).to(DEV)
    cur = spikemm_cuda(x.reshape(ALIF_T * ALIF_B, N_IN),
                       params["hidden"]["w_input"]).reshape(
        ALIF_T, ALIF_B, N_HIDDEN)
    tau, rho = _decays(params)
    z = torch.zeros(ALIF_B, N_HIDDEN, device=DEV)
    return (cur, tau, rho, z, z.clone(), 1.0, 0.5)


def alif_ff_input():
    return (np.random.default_rng(0).random((ALIF_T, ALIF_B, N_IN))
            < ALIF_RATE).astype(np.float32)


def ragged_cases():
    """Shapes no serving window has: T=37, B=3, N=130, N=300 and N=1024
    from a nonzero state (both W_rec storage paths of the recurrent
    kernels, and the largest batch row they take)."""
    g = torch.Generator().manual_seed(3)

    def rnd(*shape, lo=0.0, hi=1.0):
        return (lo + (hi - lo) * torch.rand(shape, generator=g)).to(DEV)

    cases = {"spikemm": [("ragged", (
        (torch.rand((1000, N_IN), generator=g) < 0.012).float().to(DEV),
        torch.randn((N_IN, 257), generator=g).to(DEV)))],
        "linrec": [("ragged, full decay plane", (
            rnd(37, 3, 130, lo=0.5, hi=0.99),
            torch.randn((37, 3, 130), generator=g).to(DEV),
            torch.randn((3, 130), generator=g).to(DEV)))],
        "lif": [], "lifrec": [], "alif": [], "alifrec": []}
    cur130 = (0.6 * torch.randn((37, 3, 130), generator=g)).to(DEV)
    tau130 = rnd(130, lo=0.7, hi=0.98)
    z130 = torch.zeros((3, 130), device=DEV)
    cases["lif"] = [("ragged, zero reset", (cur130, tau130, z130, 1.0,
                                            "zero")),
                    ("ragged, subtract reset", (cur130, tau130, z130, 1.0,
                                                "subtract"))]
    for n in (130, 300, 1024):
        cur = (0.8 * torch.randn((37, 3, n), generator=g)).to(DEV)
        w = (0.4 / math.sqrt(n) * torch.randn((n, n), generator=g)).to(DEV)
        tau, rho = rnd(n, lo=0.7, hi=0.98), rnd(n, lo=0.85, hi=0.99)
        v0, a0 = rnd(3, n, lo=-0.5, hi=0.9), rnd(3, n, hi=2.0)
        s0 = (torch.rand((3, n), generator=g) < 0.3).float().to(DEV)
        label = f"ragged N={n}"
        cases["lifrec"].append((label, (cur, w, tau, v0, s0, 1.0)))
        cases["alif"].append((label, (cur, tau, rho, v0, a0, 1.0, 1.8)))
        cases["alifrec"].append((label, (cur, w, tau, rho, v0, a0, s0, 1.0,
                                         0.5)))
    return cases


def work(name, args, out):
    """(bytes moved, fp32 operations on this run's data, the operations of
    the dense products) of one call with inputs `args` and outputs `out`.

    spikemm: each nonzero spike adds one row of w into its output row, so
    the product needs 2 * nnz * N operations (one multiply-add per term;
    an add alone takes the same issue slot at the fp32 peak), whatever
    blocking a kernel chooses; dense 2 * M * K * N. The recurrent kernels
    add one W_rec row per spike of the previous step, 2 * nnz(s_{t-1}) * N
    (s_{-1} = s0), against the dense 2 * T * B * N * N."""
    tensors = [a for a in args if torch.is_tensor(a)]
    if name == "spikemm":
        s, w = args
        M, K = s.shape
        N = w.shape[1]
        nnz = int(torch.count_nonzero(s))
        return 4 * (M * K + K * N + M * N), 2 * nnz * N, 2 * M * K * N
    if name == "linrec":
        a, x, h0 = args
        a_bytes = 4 * int(np.prod([n for n, st in zip(a.shape, a.stride())
                                   if st != 0]))
        ops = 2 * x.numel()
        return a_bytes + 4 * (2 * x.numel() + 2 * h0.numel()), ops, ops
    T, B, N = args[0].shape
    nbytes = 4 * (sum(t.numel() for t in tensors)
                  + sum(o.numel() for o in out))
    ops = LANE_OPS[name] * T * B * N
    if name in ("lifrec", "alifrec"):
        s0 = args[4] if name == "lifrec" else args[6]
        nnz = int(torch.count_nonzero(s0)) + int(torch.count_nonzero(
            out[0][:-1]))
        return nbytes, ops + 2 * nnz * N, ops + 2 * T * B * N * N
    return nbytes, ops, ops


def phase_kernels(shd_params):
    from repro_torch.kernels.alifrec.ops import (alif_cuda, alif_scan_ref,
                                                 alifrec_cuda,
                                                 alifrec_scan_ref)
    from repro_torch.kernels.lif.ops import lif_cuda, lif_scan_ref
    from repro_torch.kernels.common import w_in_smem
    from repro_torch.kernels.lifrec.ops import lifrec_cuda, lifrec_scan_ref
    from repro_torch.kernels.linrec.ops import linrec_cuda, linrec_ref
    from repro_torch.kernels.spikemm.ops import spikemm_cuda, spikemm_ref
    cuda = {"spikemm": spikemm_cuda, "linrec": linrec_cuda, "lif": lif_cuda,
            "lifrec": lifrec_cuda, "alif": alif_cuda,
            "alifrec": alifrec_cuda}
    plain = {"spikemm": spikemm_ref, "linrec": linrec_ref,
             "lif": lif_scan_ref, "lifrec": lifrec_scan_ref,
             "alif": alif_scan_ref, "alifrec": alifrec_scan_ref}
    cases = {name: [] for name in cuda}
    # the homogeneous ECG window's spikemm and linrec calls have the
    # heterogeneous one's shapes; only its hidden layer is new
    for path, window in (("shd", shd_window(shd_params)),
                         ("ecg", ecg_window(True)),
                         ("ecg_homogeneous",
                          {"lifrec": ecg_window(False)["lifrec"]}),
                         ("alif_ff", {"alif": [("ALIF-ff hidden",
                                                alif_ff_run_inputs())]})):
        for name, calls in window.items():
            cases[name] += [(label, path, args) for label, args in calls]
    for name, calls in ragged_cases().items():
        cases[name] += [(label, None, args) for label, args in calls]

    results = {}
    for name, calls_in in cases.items():
        calls, max_err = [], 0.0
        for label, path, args in calls_in:
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
            shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
            if path is None:
                where = ""
                if name in ("lifrec", "alifrec"):
                    n = args[0].shape[2]
                    smem = w_in_smem(n)
                    if smem != (n <= 130):
                        raise AssertionError(
                            f"{name} [{label}]: W_rec in shared memory is "
                            f"{smem}; this case is to run the "
                            f"{'shared' if n <= 130 else 'L2'} path")
                    where = (", W_rec in shared memory" if smem
                             else ", W_rec through L2")
                log(f"kernel {name} [{label}] {shapes}{where}: matches "
                    f"plain (max abs err {max_err:.3e})")
                continue
            heavy = name in ("lifrec", "alifrec", "alif")
            ms = cuda_ms(lambda: cuda[name](*args), iters=200)
            p_ms = cuda_ms(lambda: plain[name](*args),
                           iters=10 if heavy else 20)
            lib = (cuda_ms(lambda: torch.matmul(*args), iters=200)
                   if name == "spikemm" else None)
            nbytes, flops, dense = work(name, args, got)
            b_ms, b_by = bound(nbytes, flops)
            d_ms, d_by = bound(nbytes, dense)
            T = args[1].shape[0] if name == "linrec" else (
                args[0].shape[0] if name != "spikemm" else None)
            calls.append({"call": label, "path": path, "shape": shapes,
                          "ms": ms, "plain_ms": p_ms, "library_ms": lib,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "bound_dense_ms": d_ms, "bound_dense_by": d_by,
                          "ms_per_step": None if T is None else ms / T,
                          "bytes": nbytes, "flops": flops,
                          "dense_flops": dense})
            log(f"kernel {name} [{label}] {shapes}: {ms:.4f} ms on the card"
                f"{'' if T is None else f' ({ms / T * 1e3:.3f} us/step)'} "
                f"(plain {p_ms:.4f}, "
                f"library {lib if lib is None else round(lib, 4)}, bound "
                f"{b_ms:.5f} by {b_by}, dense bound {d_ms:.5f} by {d_by}); "
                f"max abs err so far {max_err:.3e}")
        src, rep = SOURCES[name]
        home = [c for c in calls if c["path"] == HOME[name]]
        top = max(home, key=lambda c: c["bound_ms"])
        per_step = [c["ms_per_step"] for c in home
                    if c["ms_per_step"] is not None]
        results[name] = {
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": None, "max_abs_err": max_err,
            "path": HOME[name],
            "ms": sum(c["ms"] for c in home),
            "ms_per_step": sum(per_step) if per_step else None,
            "plain_ms": sum(c["plain_ms"] for c in home),
            "bound_ms": sum(c["bound_ms"] for c in home),
            "bound_by": top["bound_by"],
            "bound_dense_ms": sum(c["bound_dense_ms"] for c in home),
            "library_ms": (sum(c["library_ms"] for c in home)
                           if name == "spikemm" else None),
            "calls": calls}
    return results


# ---------------------------------------------------------------------------
# 4. paths through the engine
# ---------------------------------------------------------------------------


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


def counted(tag, per_run, runs, counts):
    """Raise unless `counts` holds exactly `per_run` x `runs` launches of
    each kernel (0 for the kernels not named)."""
    from repro_torch.kernels import registry
    want = {n: per_run.get(n, 0) * runs for n in registry.names()}
    if counts != want:
        raise AssertionError(f"[{tag}] launch counts {counts} != {want} "
                             f"({per_run} per run x {runs})")


def card_vs_cpu(tag, nodes_c, params_c, x, st_gpu, o_gpu, r_gpu):
    """Hold a card run of `plan.run` against the CPU's on the same input
    (T, B, n_in): hidden spikes under the tie rule (row-wise for a
    self-recurrent layer), the 1 % floor, readouts before each row's first
    divergence and the final states of the rows that never diverged.
    Returns (CPU hidden spikes, first divergence per row, tie flips,
    readout error, state error, CPU outputs)."""
    from repro_torch.core import plan
    from repro_torch.weights import params_to_numpy
    tie = load_tie_rule()
    T = x.shape[0]
    st_cpu, o_cpu, r_cpu = plan.run(nodes_c, params_c, torch.from_numpy(x),
                                    record=("hidden",), device="cpu")
    o_cpu = o_cpu.numpy()
    s_cpu = r_cpu["hidden"].numpy()
    if not s_cpu.mean() >= MIN_HIDDEN_RATE:
        raise AssertionError(
            f"[{tag}] hidden layer fires in {s_cpu.mean():.4%} of its "
            f"lane-steps, under {MIN_HIDDEN_RATE:.0%}: the comparison "
            "would be vacuous")
    u, th = tie.hidden_membrane(nodes_c[0], params_to_numpy(params_c)[
        "hidden"], x, s_cpu)
    first_div, n_ties = tie.tie_rule(s_cpu, r_gpu["hidden"].cpu().numpy(),
                                     u, th,
                                     rowwise=tie.is_recurrent(nodes_c[0]))
    err_plan = tie.max_err_before(o_cpu, o_gpu, first_div)
    if err_plan > READOUT_TOL:
        raise AssertionError(f"[{tag}] plan.run readout card vs CPU "
                             f"{err_plan:.3e} > {READOUT_TOL}")
    # final states (membranes, adaptation, branch currents, the recurrent
    # `out`, readout) of the rows whose hidden spikes never diverged: these
    # carry every input of the run, also where the hidden layer barely fires
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
    return s_cpu, first_div, n_ties, err_plan, err_state, rows


def phase_path(path: ServePath, smi):
    from repro_torch.core import plan
    from repro_torch.kernels import registry
    from repro_torch.serve import EngineConfig, make_engine

    tag = path.name
    nodes, params = path.make_model(DEV)
    nodes_c, params_c = path.make_model("cpu")
    cfg = EngineConfig(window=WINDOW, capacity=CAPACITY, queue_limit=None)
    streams = path.streams()
    trace = make_trace(streams)
    n_in = next(iter(streams.values())).shape[1]

    # warm-up outside the measured run: CUDA context, allocator, kernels
    replay(make_engine(nodes, params, cfg, device=DEV),
           make_trace({k: v[:96] for k, v in list(streams.items())[:4]}))
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
    counted(tag, path.per_window, wins, counts)
    log(f"path [{tag}]: {len(streams)} sessions, {wins} windows, launches "
        f"{counts} ({path.per_window} per window)")

    # -- the engine equals a one-shot plan.run of every session ---------------
    x = side_by_side(streams, n_in)
    T = x.shape[0]
    st_gpu, o_gpu, r_gpu = plan.run(nodes, params, torch.from_numpy(x).to(DEV),
                                    record=("hidden",), device=DEV)
    o_gpu = o_gpu.cpu().numpy()
    n_out = nodes[-1].out_dim
    for b, (sid, v) in enumerate(streams.items()):
        got = eng.outputs(sid)
        if got.shape != (len(v), n_out) or not np.all(np.isfinite(got)):
            raise AssertionError(f"[{tag}] {sid}: outputs {got.shape}, "
                                 f"expected finite ({len(v)}, {n_out})")
        if not np.array_equal(got, o_gpu[:len(v), b]):
            raise AssertionError(f"[{tag}] {sid}: engine outputs differ from "
                                 "the one-shot plan.run on the card")

    # -- the card against the CPU, under the tie rule -------------------------
    s_cpu, first_div, n_ties, err_plan, err_state, rows = card_vs_cpu(
        tag, nodes_c, params_c, x, st_gpu, o_gpu, r_gpu)
    eng_c = replay(make_engine(nodes_c, params_c, cfg, device="cpu"), trace)
    err_eng = 0.0
    for b, (sid, v) in enumerate(streams.items()):
        t0_ = min(int(first_div[b]), len(v))
        if t0_:
            err_eng = max(err_eng, float(np.max(np.abs(
                eng.outputs(sid)[:t0_] - eng_c.outputs(sid)[:t0_]))))
    if err_eng > READOUT_TOL:
        raise AssertionError(f"[{tag}] engine readout card vs CPU "
                             f"{err_eng:.3e} > {READOUT_TOL}")
    log(f"path [{tag}]: card vs CPU: hidden spikes {int(s_cpu.sum())} "
        f"(rate {s_cpu.mean():.4f}), {n_ties} lanes flipped at threshold "
        f"ties, {int((first_div < T).sum())} rows diverged, readout max abs "
        f"err {err_plan:.3e} (plan.run), {err_eng:.3e} (engine); final "
        f"states of {int(rows.sum())} undiverged rows max abs err "
        f"{err_state:.3e}")

    # -- one session solo against packed --------------------------------------
    solo_sid = next(iter(streams))
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
    log(f"path [{tag}]: {solo_sid} solo == packed, bit for bit")

    out = {"path": tag, "model": path.model, "window": WINDOW,
           "capacity": CAPACITY, "sessions": len(streams), "windows": wins,
           "launches": counts, "launches_per_window": path.per_window,
           "input": path.input, "hidden_spikes": int(s_cpu.sum()),
           "hidden_rate": float(s_cpu.mean()), "tie_flips": n_ties,
           "rows_diverged": int((first_div < T).sum()),
           "readout_max_abs_err": max(err_plan, err_eng),
           "state_max_abs_err": err_state}
    if path.timed:
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
            "sessions_per_s": len(streams) / wall,
            "steps_per_s": steps / wall,
            "median_replay_wall_s": wall,
            "device_ms_per_window": dev_ms,
            "device_busy_share": (None if dev_ms is None
                                  else dev_ms / mean_ms),
            "device_ms_per_window_by_kernel": top,
            "host_ms_per_window_by_stage": host,
            "card": smi})
    return out


# ---------------------------------------------------------------------------
# 5. the ALIF feed-forward path
# ---------------------------------------------------------------------------


def phase_alif_ff(smi):
    """One `plan.run` of the bench's `shd_alif_ff` program on the card."""
    from repro_torch.core import plan
    from repro_torch.kernels import registry
    tag = "alif_ff"
    nodes, params = make_alif_ff(DEV)
    nodes_c, params_c = make_alif_ff("cpu")
    x = alif_ff_input()
    xg = torch.from_numpy(x).to(DEV)
    plan.run(nodes, params, xg[:8], device=DEV)          # warm-up
    sync()
    registry.reset_launches()
    st_gpu, o_gpu, r_gpu = plan.run(nodes, params, xg, record=("hidden",),
                                    device=DEV)
    sync()
    counts = registry.launch_counts()
    per_run = {"spikemm": 2, "alif": 1, "linrec": 1}
    counted(tag, per_run, 1, counts)
    o_gpu = o_gpu.cpu().numpy()
    if o_gpu.shape != (ALIF_T, ALIF_B, N_OUT) or \
            not np.all(np.isfinite(o_gpu)):
        raise AssertionError(f"[{tag}] outputs {o_gpu.shape}, expected "
                             f"finite {(ALIF_T, ALIF_B, N_OUT)}")
    s_cpu, first_div, n_ties, err_plan, err_state, rows = card_vs_cpu(
        tag, nodes_c, params_c, x, st_gpu, o_gpu, r_gpu)
    run_ms = []
    for _ in range(REPLAYS):
        t0 = time.perf_counter()
        plan.run(nodes, params, xg, device=DEV)
        sync()
        run_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"path [{tag}]: launches {counts}; card vs CPU: hidden spikes "
        f"{int(s_cpu.sum())} (rate {s_cpu.mean():.4f}), {n_ties} lanes "
        f"flipped at threshold ties, readout max abs err {err_plan:.3e}, "
        f"final states of {int(rows.sum())} undiverged rows max abs err "
        f"{err_state:.3e}; plan.run {np.median(run_ms):.3f} ms")
    return {"path": tag, "model": "bench_snn_engine shd_alif_ff "
            f"{N_IN}->{N_HIDDEN} ALIF->{N_OUT}", "T": ALIF_T, "batch": ALIF_B,
            "input": f"bernoulli({ALIF_RATE})", "launches": counts,
            "launches_per_run": per_run, "hidden_spikes": int(s_cpu.sum()),
            "hidden_rate": float(s_cpu.mean()), "tie_flips": n_ties,
            "rows_diverged": int((first_div < ALIF_T).sum()),
            "readout_max_abs_err": err_plan, "state_max_abs_err": err_state,
            "plan_run_ms_median": float(np.median(run_ms)),
            "plan_run_ms": run_ms, "card": smi}


def main():
    smi = phase_device()
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)

    build_s = phase_build()
    kernels = phase_kernels(make_shd(True, DEV)[1])
    slices = [phase_path(p, smi) for p in PATHS]
    slices.append(phase_alif_ff(smi))
    for name, k in kernels.items():
        by_path = {s["path"]: s["launches"][name] for s in slices
                   if s["launches"][name]}
        if not by_path:
            raise AssertionError(f"kernel {name} launched on no path")
        k["launches"] = sum(by_path.values())
        k["launches_by_path"] = by_path
        # per served window; for alif_ff, per plan.run of its 250 steps
        k["launches_per_window"] = {
            s["path"]: s.get("launches_per_window",
                             s.get("launches_per_run"))[name]
            for s in slices if s["path"] in by_path}
    slices[0]["build_s"] = build_s
    log(json.dumps({"kernels": list(kernels.values())}))
    for s in slices:
        log(json.dumps({"slice": s}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
