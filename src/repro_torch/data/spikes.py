"""Synthetic spike datasets, shape/statistics-faithful to the paper (§V-B3).

A numpy-only copy of `repro/data/spikes.py`: the port keeps its own copy
so that it never imports the JAX package.

QTDB, SHD and the macaque BCI recordings are not redistributable inside this
container, so each generator reproduces the *documented* dimensions and
first-order statistics; the benchmarks report relative (heterogeneous vs
homogeneous) orderings, which is what these generators support.

  gen_ecg_qtdb   759-record-style waveforms: six bands (P, PQ, QR, RS, ST,
                 TP) cycled per beat, level-crossing coded -> (T=1301, 4)
                 spike channels (2 leads x {+,-}), labels per timestep.
  gen_shd_spikes Heidelberg SHD-style: (T, 700) binary rasters, 20 classes,
                 class-dependent cochlear activation center; input spike
                 rate calibrated to the paper's measured 1.2 %.
  gen_bci_trials M1-style: 128 channels x 50 bins (20 ms), 4 movement
                 classes, with a per-"day" drift parameter — cross-day
                 decoding (the paper's fine-tuning task) needs day shift.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def level_crossing_encode(x: np.ndarray, delta: float = 0.1) -> np.ndarray:
    """Level-crossing coding (paper §V-B3): continuous (T, C) -> spike
    (T, 2C): one positive and one negative channel per input channel."""
    T, C = x.shape
    out = np.zeros((T, 2 * C), np.float32)
    ref = x[0].copy()
    for t in range(1, T):
        up = x[t] > ref + delta
        dn = x[t] < ref - delta
        out[t, :C] = up
        out[t, C:] = dn
        ref = np.where(up | dn, x[t], ref)
    return out


def gen_ecg_qtdb(n: int, seed: int = 0, T: int = 1301
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """-> spikes (n, T, 4), labels (n, T) in [0, 6). Two synthetic leads."""
    rng = np.random.default_rng(seed)
    # band template durations (fractions of one beat) for P,PQ,QR,RS,ST,TP
    frac = np.array([0.12, 0.08, 0.10, 0.10, 0.20, 0.40])
    spikes = np.zeros((n, T, 4), np.float32)
    labels = np.zeros((n, T), np.int64)
    for i in range(n):
        beat = int(rng.integers(180, 260))
        durs = np.maximum(2, (frac * beat).astype(int))
        amps = {0: 0.25, 1: 0.02, 2: 1.2, 3: -0.9, 4: 0.15, 5: 0.01}
        sig = np.zeros(T)
        lab = np.zeros(T, np.int64)
        t = int(rng.integers(0, beat))
        while t < T:
            for band, d in enumerate(durs):
                seg = min(d, T - t)
                if seg <= 0:
                    break
                phase = np.linspace(0, np.pi, seg)
                sig[t:t + seg] = amps[band] * np.sin(phase) \
                    + 0.02 * rng.standard_normal(seg)
                lab[t:t + seg] = band
                t += seg
            if t >= T:
                break
        lead2 = 0.6 * sig + 0.02 * rng.standard_normal(T)
        spikes[i] = level_crossing_encode(
            np.stack([sig, lead2], 1), delta=0.05)
        labels[i] = lab
    return spikes, labels


def gen_shd_spikes(n: int, T: int = 100, seed: int = 0, n_in: int = 700,
                   n_classes: int = 20) -> Tuple[np.ndarray, np.ndarray]:
    """-> spikes (n, T, 700) with ~1.2% rate, labels (n,) in [0, 20)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n)
    spikes = np.zeros((n, T, n_in), np.float32)
    ch = np.arange(n_in)
    for i in range(n):
        c = labels[i]
        center = (c + 0.5) * n_in / n_classes
        width = n_in / n_classes * 1.5
        prof = np.exp(-0.5 * ((ch - center) / width) ** 2)     # cochlear bump
        # temporal envelope: onset sweep with class-dependent velocity
        tt = np.arange(T)[:, None]
        drift = center + (c % 5 - 2) * 1.2 * tt / T * width
        prof_t = np.exp(-0.5 * ((ch[None] - drift) / width) ** 2)
        rate = 0.012 * n_in / prof.sum() * prof_t              # ~1.2% mean
        spikes[i] = rng.random((T, n_in)) < rate
    return spikes, labels


def gen_bci_trials(n: int, day: int = 0, seed: int = 0, n_channels: int = 128,
                   n_bins: int = 50, n_classes: int = 4
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """-> rates (n, 128, 50) binned firing, labels (n,) in [0, 4).

    `day` adds a fixed random rotation + gain drift to the channel tuning —
    the cross-day distribution shift the paper's on-chip fine-tuning corrects.
    """
    rng = np.random.default_rng(seed)
    day_rng = np.random.default_rng(1000 + day)
    # The class->channel tuning defines the TASK and must be identical for
    # every (seed, day): only trial noise varies with `seed`, only the
    # drift/gain shift with `day`. Drawing it from `rng` (as this function
    # originally did) gave each seed a different task, so cross-day
    # fine-tuning could never transfer.
    task_rng = np.random.default_rng(424242)
    base_tuning = task_rng.standard_normal((n_classes, n_channels))
    drift = 0.35 * day * day_rng.standard_normal((n_channels,))
    gain = 1.0 + 0.1 * day * day_rng.standard_normal((n_channels,))
    labels = rng.integers(0, n_classes, n)
    t_env = np.sin(np.linspace(0, np.pi, n_bins))              # movement env
    x = np.empty((n, n_channels, n_bins), np.float32)
    for i in range(n):
        mu = gain * (base_tuning[labels[i]] + drift)
        x[i] = (mu[:, None] * t_env[None, :]
                + 0.8 * rng.standard_normal((n_channels, n_bins)))
    return x, labels
