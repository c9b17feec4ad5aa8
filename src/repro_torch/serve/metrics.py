"""Serve-engine observability: counters + latency/depth histograms.

The serving runtime answers operational questions the incident log alone
cannot: how many sessions per second, what a p99 window costs, how deep
the admission queue runs, how often the state cache spills. Everything
here is plain host-side Python (no tracing, thread-safe) and exports as
one flat dict (`ServeMetrics.snapshot()`) so benches, tests, and the CI
artifacts can archive it; `publish()` additionally records the snapshot
onto the kernel incident log (`kind="serve", stage="metrics"`) so a run's
operational story and its degradation story land in the same place —
`record()` only, never `degrade()`, so `REPRO_STRICT` CI stays green.

Histograms keep exact samples in a bounded ring (newest-wins, default
4096): percentiles are true order statistics over the retained window
rather than bucket interpolations, which is what a p99 claim in a bench
row should mean.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Optional

from repro_torch.kernels.incidents import FallbackEvent, record

_MAX_SAMPLES = 4096


class Histogram:
    """Bounded-sample histogram with exact quantiles over the window."""

    def __init__(self, max_samples: int = _MAX_SAMPLES):
        self._max = max_samples
        self._samples: List[float] = []
        self._next = 0                      # ring cursor once full
        self.count = 0
        self.total = 0.0

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        if len(self._samples) < self._max:
            self._samples.append(value)
        else:
            self._samples[self._next] = value
            self._next = (self._next + 1) % self._max

    def quantile(self, q: float) -> float:
        """Exact order statistic over the retained samples (0 when empty)."""
        if not self._samples:
            return 0.0
        s = sorted(self._samples)
        i = min(len(s) - 1, max(0, math.ceil(q * len(s)) - 1))
        return s[i]

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def snapshot(self) -> Dict[str, float]:
        return {"count": self.count, "mean": self.mean,
                "p50": self.quantile(0.50), "p99": self.quantile(0.99),
                "max": max(self._samples) if self._samples else 0.0}


@dataclasses.dataclass
class ServeMetrics:
    """All counters + histograms one engine instance maintains.

    Counters (monotonic):
      sessions_opened/closed/finished, chunks_admitted, chunks_rejected
      (backpressure), windows_run, session_windows (slot-windows actually
      served), steps_run (timesteps x sessions), cache_hits/misses,
      cache_evictions, cache_restores.
    Histograms:
      window_latency_s   wall clock of one engine.step() cohort window
      queue_depth        ready-session count sampled at each step
      occupancy          served-slots / capacity per window (0..1)
    """

    sessions_opened: int = 0
    sessions_closed: int = 0
    sessions_finished: int = 0
    chunks_admitted: int = 0
    chunks_rejected: int = 0
    windows_run: int = 0
    session_windows: int = 0
    steps_run: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    cache_evictions: int = 0
    cache_restores: int = 0
    window_latency_s: Histogram = dataclasses.field(default_factory=Histogram)
    queue_depth: Histogram = dataclasses.field(default_factory=Histogram)
    occupancy: Histogram = dataclasses.field(default_factory=Histogram)
    _lock: threading.Lock = dataclasses.field(default_factory=threading.Lock,
                                              repr=False)

    def bump(self, name: str, by: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + by)

    @property
    def cache_hit_rate(self) -> float:
        n = self.cache_hits + self.cache_misses
        return self.cache_hits / n if n else 1.0

    def snapshot(self) -> Dict[str, object]:
        """One flat dict: every counter, every histogram's summary."""
        out: Dict[str, object] = {}
        for f in dataclasses.fields(self):
            if f.name.startswith("_"):
                continue
            v = getattr(self, f.name)
            if isinstance(v, Histogram):
                out[f.name] = v.snapshot()
            else:
                out[f.name] = v
        out["cache_hit_rate"] = self.cache_hit_rate
        return out

    def publish(self, family: str = "engine",
                extra: Optional[Dict[str, int]] = None) -> FallbackEvent:
        """Record the snapshot onto the kernel incident log (kind="serve",
        stage="metrics") — observability, not a degradation, so this goes
        through `record()` and never raises under REPRO_STRICT."""
        snap = self.snapshot()
        dims = {k: int(v) for k, v in snap.items() if isinstance(v, int)}
        dims.update(extra or {})
        return record(FallbackEvent(
            kind="serve", family=family, stage="metrics",
            error=f"p50_window_s={self.window_latency_s.quantile(0.5):.6f} "
                  f"p99_window_s={self.window_latency_s.quantile(0.99):.6f} "
                  f"cache_hit_rate={self.cache_hit_rate:.3f}",
            dims=dims))


__all__ = ["Histogram", "ServeMetrics"]
