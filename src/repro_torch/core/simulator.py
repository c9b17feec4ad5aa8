"""Behavioural chip simulator (paper §IV-C, §V-B: the paper's own energy,
power, and throughput numbers come from this component, not silicon).

The port's own numpy copy of `repro/core/simulator.py`: the same
arithmetic, so the same `LayerStats` give the same `SimReport` in both
packages. What it reports is TaiBai's modelled power and the paper's RTX
3090 comparator, never a time or power of the card the port runs on.

Given (a) a model's per-layer spike statistics — measured from the actual
run (`spike_stats_from_records` takes the port's tensors), not assumed —
and (b) a Mapping from `core/mapping.py`, produce:

  SOPs          synaptic operations = sum_t sum_i s_i(t) * fanout_i
  packets       spike events x multicast replication (parallel-send aware)
  energy        SOPs x E_SOP + packets x hops x E_hop + static
  throughput    bounded by NoC bandwidth (322 GSE/s intra, 363 MSE/s inter)
  power         energy / time at the 500 MHz INTEG/FIRE schedule

Constants from Table III/IV: E_SOP = 2.61 pJ, chip power 1.83 W typical,
memory fraction 70.3% (Fig. 13c). The GPU comparator models an RTX 3090
(350 W TDP, 35.6 TFLOP/s fp16 dense) running the same network densely —
the paper's §V-B2 protocol ('record the power while the model is running').
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

# TaiBai constants (Table III / IV / Fig. 13)
E_SOP_PJ = 2.61               # energy per synaptic op
E_HOP_PJ = 1.1                # router energy per packet-hop (28 nm class)
STATIC_W = 0.20               # leakage + clock tree at 0.9 V
CHIP_POWER_W = 1.83           # typical total (Table III)
MEM_FRACTION = 0.703          # Fig. 13c power breakdown
CLOCK_HZ = 500e6
INTRA_SE_S = 322e9            # intra-chip spike events / s
INTER_SE_S = 363e6            # inter-chip spike events / s
PEAK_GSOPS = 528e9            # peak synaptic ops / s

# RTX 3090 comparator (§V-B2)
GPU_TDP_W = 350.0
GPU_FP16_FLOPS = 35.6e12
GPU_IDLE_W = 25.0
GPU_UTIL = 0.35               # achieved fraction of peak on small SNN batches


@dataclasses.dataclass
class LayerStats:
    """Per-layer activity measured from a model run."""

    name: str
    n_neurons: int
    fan_out: int               # synapses per firing neuron
    spike_rate: float          # mean spikes / neuron / timestep (0..1)
    dense_flops: float         # FLOPs a dense implementation would burn per timestep


@dataclasses.dataclass
class SimReport:
    sops: float
    packets: float
    hops_per_packet: float
    time_s: float
    energy_j: float
    power_w: float
    throughput_fps: float
    gpu_energy_j: float
    gpu_power_w: float
    gpu_fps: float
    efficiency_x: float        # (TaiBai FPS/W) / (GPU FPS/W)
    power_ratio_x: float

    def asdict(self):
        return dataclasses.asdict(self)


def spike_stats_from_records(records: Dict[str, Any],
                             fan_outs: Dict[str, int],
                             dense_flops: Dict[str, float]) -> List[LayerStats]:
    """records[name]: (T, batch, n) spike records of a run, numpy arrays or
    tensors on any device (as `plan.run(record=...)` or `bci_forward`
    return them)."""
    out = []
    for name, rec in records.items():
        if torch.is_tensor(rec):
            rec = rec.detach().cpu().numpy()
        rate = float(np.mean(rec != 0))
        out.append(LayerStats(name, rec.shape[-1], fan_outs[name], rate,
                              dense_flops[name]))
    return out


GPU_STEP_FLOOR_S = 30e-6      # per-timestep kernel-launch latency floor


def simulate(layers: Sequence[LayerStats], timesteps: int,
             hops_per_packet: float = 3.0, parallel_send: int = 4,
             inter_chip_fraction: float = 0.0,
             parallel_speedup: float = 1.0,
             replication: float = 1.0) -> SimReport:
    """Run the behavioural cost model for one inference of `timesteps` steps.

    parallel_speedup: compute-time divisor from spreading a population over
    more cores (the throughput-objective mapping);
    replication: average number of destination REGIONS each spike multicasts
    to — spreading a layer over more cores raises it (more packets, more
    energy: the Fig. 13e efficiency cost of throughput mode).
    """
    sops = 0.0
    packets = 0.0
    dense_flops = 0.0
    for L in layers:
        events = L.n_neurons * L.spike_rate * timesteps
        sops += events * L.fan_out
        # parallel-send: one event reaches `parallel_send` NCs as ONE packet
        # per region (multicast), not N point-to-point packets
        packets += events * max(1.0, L.fan_out / 256 / parallel_send) \
            * replication
        dense_flops += L.dense_flops * timesteps

    # time: compute bound vs NoC bound, whichever is slower
    t_compute = sops / PEAK_GSOPS / max(parallel_speedup, 1e-9)
    noc_bw = (1 - inter_chip_fraction) * INTRA_SE_S + inter_chip_fraction * INTER_SE_S
    t_noc = packets / noc_bw
    # INTEG->FIRE phase barriers: the compiler picks cycles/timestep from
    # model complexity (§IV-A); 4096 cycles is the applications' setting
    t_sync = timesteps / (CLOCK_HZ / 4096)
    time_s = max(t_compute, t_noc) + t_sync

    # E_SOP is the ALL-IN per-op energy (Table IV's metric, memory included
    # — Fig. 13c's 70.3% memory share is a breakdown of it, not an adder)
    dyn_e = (sops * E_SOP_PJ + packets * hops_per_packet * E_HOP_PJ) * 1e-12
    energy = dyn_e + STATIC_W * time_s
    power = energy / time_s
    fps = 1.0 / time_s

    # GPU comparator: dense tensor math, spike rate irrelevant (§V-C1);
    # small SNNs are kernel-launch-bound, hence the per-step latency floor
    gpu_compute_time = dense_flops / (GPU_FP16_FLOPS * GPU_UTIL)
    gpu_time = max(gpu_compute_time, timesteps * GPU_STEP_FLOOR_S)
    # launch-bound workloads leave the GPU mostly idle: power scales with
    # the fraction of time the SMs are actually busy
    util_frac = min(1.0, gpu_compute_time / max(gpu_time, 1e-12))
    gpu_power = GPU_IDLE_W + (GPU_TDP_W - GPU_IDLE_W) * 0.8 * max(util_frac, 0.05)
    gpu_energy = gpu_power * gpu_time
    gpu_fps = 1.0 / gpu_time

    eff = (fps / power) / (gpu_fps / gpu_power)
    return SimReport(sops, packets, hops_per_packet, time_s, energy, power,
                     fps, gpu_energy, gpu_power, gpu_fps, eff,
                     gpu_power / power)


def energy_per_sop(report: SimReport) -> float:
    """pJ/SOP achieved — Table IV's comparison metric."""
    return report.energy_j * 1e12 / max(report.sops, 1.0)


__all__ = ["LayerStats", "SimReport", "spike_stats_from_records", "simulate",
           "energy_per_sop"]
