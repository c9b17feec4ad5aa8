"""Ragged continuous batching: cohort assembly, admission, backpressure.

Sessions arrive with uneven rates and lengths; the engine's scheduling
quantum is one fixed-length window of `window` timesteps (the
chunked-online quantum `plan.run` state already round-trips at). The
scheduler's job is to pack whichever sessions have a runnable window into
fixed-shape cohorts — (window, capacity, n_in) — so every window step
runs at one shape, while staying fair and bounded:

  * **Readiness.** A session is schedulable when it has `window` buffered
    timesteps, or it is closed with a partial tail (which is zero-padded
    for shape and trimmed on output — padded state never feeds a later
    real step because closed means no more input).
  * **Fairness.** The ready queue is FIFO; a session served this window
    re-enters at the *tail* if still ready, so a firehose tenant streams
    at most one window ahead per cohort of everyone else (round-robin at
    window granularity).
  * **Admission control.** Total buffered-but-unserved windows across all
    sessions are bounded by `queue_limit`; a submit that would exceed it
    is rejected — the caller sees `False` (backpressure) and the
    rejection is recorded on the incident log (kind="serve",
    stage="admission") so operators can see shed load. `record()` only:
    shedding is the *designed* response, not a degradation to raise on.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.kernels.incidents import FallbackEvent, record
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.sessions import Session


class Scheduler:
    def __init__(self, window: int, n_in: int,
                 queue_limit: Optional[int] = None,
                 metrics: Optional[ServeMetrics] = None):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = window
        self.n_in = n_in
        self.queue_limit = queue_limit
        self.metrics = metrics or ServeMetrics()
        self.sessions: Dict[str, Session] = {}
        self._ready: Deque[str] = deque()
        self._queued: set = set()       # sids currently in the ready queue

    # -- session lifecycle --------------------------------------------------

    def open(self, sid: str) -> Session:
        if sid in self.sessions:
            raise ValueError(f"session {sid!r} already open")
        s = Session(sid=sid, n_in=self.n_in)
        self.sessions[sid] = s
        self.metrics.bump("sessions_opened")
        return s

    def close(self, sid: str) -> None:
        s = self.sessions[sid]
        if s.closed:
            return
        s.closed = True
        self.metrics.bump("sessions_closed")
        if s.buffered == 0:
            s.finished = True
            self.metrics.bump("sessions_finished")
        self._requeue(sid)

    # -- admission ----------------------------------------------------------

    @property
    def pending_windows(self) -> int:
        return sum(math.ceil(s.buffered / self.window)
                   for s in self.sessions.values())

    def submit(self, sid: str, chunk: np.ndarray) -> bool:
        """Buffer `chunk` (T, n_in) for `sid`; False = backpressure."""
        s = self.sessions[sid]
        chunk = np.asarray(chunk)
        if self.queue_limit is not None:
            after = (self.pending_windows
                     - math.ceil(s.buffered / self.window)
                     + math.ceil((s.buffered + len(chunk)) / self.window))
            if after > self.queue_limit:
                self.metrics.bump("chunks_rejected")
                record(FallbackEvent(
                    kind="serve", family="engine", stage="admission",
                    error=f"queue_limit={self.queue_limit} windows: "
                          f"rejected {len(chunk)}-step chunk for "
                          f"session {sid!r}",
                    dims={"pending_windows": self.pending_windows,
                          "chunk_steps": int(len(chunk))}))
                return False
        s.push(chunk)
        self.metrics.bump("chunks_admitted")
        self._requeue(sid)
        return True

    # -- cohort assembly ----------------------------------------------------

    def _requeue(self, sid: str) -> None:
        if sid not in self._queued and self.sessions[sid].ready(self.window):
            self._ready.append(sid)
            self._queued.add(sid)

    @property
    def ready_count(self) -> int:
        return len(self._ready)

    def next_cohort(self, capacity: int
                    ) -> List[Tuple[Session, np.ndarray, int]]:
        """Pop up to `capacity` ready sessions (FIFO) with their window
        inputs: [(session, x (window, n_in), valid_steps)]. Served
        sessions that remain ready re-enter at the tail (fair round-robin);
        a closed session whose buffer drains is marked finished."""
        out: List[Tuple[Session, np.ndarray, int]] = []
        served: List[str] = []
        while self._ready and len(out) < capacity:
            sid = self._ready.popleft()
            self._queued.discard(sid)
            s = self.sessions[sid]
            if not s.ready(self.window):
                continue                      # stale queue entry
            x, valid = s.pop_window(self.window)
            s.windows += 1
            s.steps += valid
            out.append((s, x, valid))
            served.append(sid)
            if s.closed and s.buffered == 0:
                s.finished = True
                self.metrics.bump("sessions_finished")
        for sid in served:
            self._requeue(sid)
        return out


__all__ = ["Scheduler"]
