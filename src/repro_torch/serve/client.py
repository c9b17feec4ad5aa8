"""Generator-based streaming client over the batched engine.

The port of `repro/serve/client.py` (numpy only), onto the port's engine.

`BatchedEngine` exposes an operator's API: open / submit / step / drain /
retire, with explicit backpressure and a shared cohort loop. Application
code mostly wants the dual view — "here is my input stream, give me the
output stream" — without owning the stepping loop. `StreamClient` is that
facade:

    client = StreamClient(make_engine(nodes, params, cfg))
    for window in client.stream(chunks):
        ...  # (steps, n_out) blocks, in order, as they are produced

`stream` drives the engine lazily: it submits each input chunk (stepping
the shared engine through backpressure instead of dropping data), yields
every new output window as soon as the cohort loop produces it, then
closes and drains the session. Multiple clients — or one client with many
concurrent `stream` generators — share one engine, so interleaved streams
are continuously batched into cohorts exactly like hand-driven sessions;
per-session state isolation is the engine's contract (solo == interleaved
bit-for-bit), which `tests/test_torch_serve_client.py` pins down through
this facade too.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, Optional

import numpy as np

from repro_torch.serve.engine import BatchedEngine


class StreamClient:
    """Thin per-application handle on a (possibly shared) engine."""

    def __init__(self, engine: BatchedEngine):
        self.engine = engine

    # -- one-shot convenience ------------------------------------------------

    def run(self, chunks: Iterable[np.ndarray]) -> np.ndarray:
        """Feed a whole stream, return all outputs (steps, n_out)."""
        return np.concatenate(list(self.stream(None, chunks)), axis=0)

    # -- streaming ------------------------------------------------------------

    def stream(self, session_id: Optional[str],
               chunks: Optional[Iterable[np.ndarray]] = None,
               max_idle_steps: int = 10_000) -> Iterator[np.ndarray]:
        """Drive one session through the engine, yielding output windows.

        `stream(session_id, chunks)` adopts a session the caller
        pre-opened (and leaves retiring it to them); `stream(None,
        chunks)` — or the `stream(chunks)` shorthand — opens a fresh one
        and retires it on exhaustion. Each (T, n_in) chunk is submitted,
        running engine cohorts while the scheduler pushes back instead of
        dropping steps, and each new block of outputs is yielded as soon
        as it exists. `max_idle_steps` bounds the backpressure loop (a
        stall means the queue is saturated by sessions this generator
        cannot advance — a deadlocked topology — and raises instead of
        spinning forever).
        """
        if chunks is None:  # stream(chunks) shorthand
            session_id, chunks = None, session_id
        eng = self.engine
        sid = session_id
        owned = sid is None
        if owned:
            sid = eng.open()
        emitted = 0
        try:
            for chunk in chunks:
                idle = 0
                while not eng.submit(sid, np.asarray(chunk)):
                    if eng.step() == 0:
                        idle += 1
                        if idle > max_idle_steps:
                            raise RuntimeError(
                                f"session {sid!r}: backpressure stall — "
                                f"queue full and no session can run")
                # opportunistic: run whatever cohort is ready and flush
                eng.step()
                out = eng.outputs(sid)
                if out.shape[0] > emitted:
                    yield out[emitted:]
                    emitted = out.shape[0]
            eng.close(sid)
            while not eng.finished(sid):
                if eng.step() == 0:
                    break
                out = eng.outputs(sid)
                if out.shape[0] > emitted:
                    yield out[emitted:]
                    emitted = out.shape[0]
            out = eng.outputs(sid)
            if out.shape[0] > emitted:
                yield out[emitted:]
        finally:
            if owned:
                eng.retire(sid)

    def stats(self) -> Dict[str, Any]:
        return self.engine.stats()


__all__ = ["StreamClient"]
