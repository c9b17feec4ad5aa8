"""Stateful streaming sessions + the LRU state cache behind the engine.

The port of `repro/serve/sessions.py`. A `Session` is one tenant's
streaming SNN run: an input buffer of not-yet-executed timesteps, an
output trail, and — held separately in the `StateCache` — the persistent
per-session state tree that `plan.run` threads between windows. Hot
sessions keep their state as tensors on the engine's device; once the hot
set exceeds the byte budget, the least-recently-used sessions are
*spilled* to host memory (`.to("cpu")`) and restored bit-identically on
readmission (`.to(device)`). Spill -> restore is a pure copy of every
leaf, so a session's trajectory is the same whether it stayed resident or
bounced through the cache.

Byte accounting uses `plan.state_nbytes` over the full state tree.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.plan import state_nbytes
from repro_torch.kernels.common import tree_to
from repro_torch.serve.metrics import ServeMetrics


@dataclasses.dataclass
class Session:
    """One streaming tenant: buffered input, output trail, lifecycle."""

    sid: str
    n_in: int
    chunks: List[np.ndarray] = dataclasses.field(default_factory=list)
    offset: int = 0                 # consumed steps inside chunks[0]
    buffered: int = 0               # total unconsumed timesteps
    closed: bool = False            # no more submits accepted
    finished: bool = False          # closed AND buffer drained
    windows: int = 0                # cohort windows served
    steps: int = 0                  # timesteps executed
    outputs: List[np.ndarray] = dataclasses.field(default_factory=list)

    def push(self, chunk: np.ndarray) -> None:
        if self.closed:
            raise ValueError(f"session {self.sid!r} is closed")
        if chunk.ndim != 2 or chunk.shape[1] != self.n_in:
            raise ValueError(
                f"session {self.sid!r}: chunk shape {chunk.shape} != "
                f"(T, {self.n_in})")
        if len(chunk):
            self.chunks.append(np.asarray(chunk))
            self.buffered += len(chunk)

    def pop_window(self, window: int) -> Tuple[np.ndarray, int]:
        """Next `window` timesteps, zero-padded at stream end.

        Returns (x (window, n_in), valid) where `valid` is the number of
        real (unpadded) steps. Padding only ever happens on the final
        partial window of a *closed* stream, so padded state never feeds a
        later real step.
        """
        take = min(window, self.buffered)
        parts: List[np.ndarray] = []
        got = 0
        while got < take:
            head = self.chunks[0]
            n = min(take - got, len(head) - self.offset)
            parts.append(head[self.offset:self.offset + n])
            got += n
            self.offset += n
            if self.offset == len(head):
                self.chunks.pop(0)
                self.offset = 0
        self.buffered -= take
        x = (np.concatenate(parts, axis=0) if parts
             else np.zeros((0, self.n_in), np.float32))
        if take < window:
            x = np.concatenate(
                [x, np.zeros((window - take, self.n_in), x.dtype)], axis=0)
        return x, take

    def ready(self, window: int) -> bool:
        """Schedulable: a full window buffered, or a closed partial tail."""
        if self.finished:
            return False
        return self.buffered >= window or (self.closed and self.buffered > 0)


class StateCache:
    """LRU session-state cache with a hot-set byte budget.

    `put`/`get` move states in and out keyed by session id; every access
    refreshes recency. When hot bytes exceed `budget_bytes`, the
    least-recently-used entries spill to host (`.to("cpu")`) until the
    budget holds again — `get` of a spilled entry restores it to `device`
    bit-identically and counts a miss+restore. `budget_bytes=None` means
    unbounded (nothing ever spills).
    """

    def __init__(self, budget_bytes: Optional[int] = None,
                 metrics: Optional[ServeMetrics] = None,
                 device: Any = "cpu"):
        if budget_bytes is not None and budget_bytes <= 0:
            raise ValueError(f"budget_bytes must be positive or None, "
                             f"got {budget_bytes}")
        self.budget_bytes = budget_bytes
        self.device = torch.device(device)
        self.metrics = metrics or ServeMetrics()
        # sid -> (state tree, nbytes, spilled?); insertion order = recency
        self._entries: "OrderedDict[str, Tuple[Any, int, bool]]" = \
            OrderedDict()

    # -- introspection ------------------------------------------------------

    def __contains__(self, sid: str) -> bool:
        return sid in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def hot_bytes(self) -> int:
        return sum(nb for _, nb, spilled in self._entries.values()
                   if not spilled)

    @property
    def spilled(self) -> Tuple[str, ...]:
        return tuple(sid for sid, (_, _, sp) in self._entries.items() if sp)

    def is_spilled(self, sid: str) -> bool:
        return self._entries[sid][2]

    # -- core ---------------------------------------------------------------

    def put(self, sid: str, state: Dict[str, Any]) -> None:
        """Insert/replace a session's state (hot) and enforce the budget."""
        self._entries.pop(sid, None)
        self._entries[sid] = (state, state_nbytes(state), False)
        self._enforce(keep=sid)

    def get(self, sid: str) -> Dict[str, Any]:
        """Fetch a session's state onto device, refreshing recency."""
        state, nb, spilled = self._entries.pop(sid)
        if spilled:
            state = tree_to(state, self.device)
            self.metrics.bump("cache_misses")
            self.metrics.bump("cache_restores")
        else:
            self.metrics.bump("cache_hits")
        self._entries[sid] = (state, nb, False)
        self._enforce(keep=sid)
        return state

    def drop(self, sid: str) -> None:
        self._entries.pop(sid, None)

    def _enforce(self, keep: Optional[str] = None) -> None:
        """Spill LRU-first until hot bytes fit the budget. The `keep`
        entry (the session about to run / just scattered) is exempt so a
        budget smaller than one session still serves — it just spills
        everything else."""
        if self.budget_bytes is None:
            return
        hot = self.hot_bytes
        if hot <= self.budget_bytes:
            return
        for sid in list(self._entries):
            if hot <= self.budget_bytes:
                break
            state, nb, spilled = self._entries[sid]
            if spilled or sid == keep:
                continue
            host = tree_to(state, "cpu")
            self._entries[sid] = (host, nb, True)
            hot -= nb
            self.metrics.bump("cache_evictions")


__all__ = ["Session", "StateCache"]
