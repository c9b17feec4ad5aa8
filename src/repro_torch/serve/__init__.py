"""serve — the multi-tenant streaming session engine (port of the
streaming stack of `repro.serve`).

`sessions.py` / `scheduler.py` / `engine.py` / `metrics.py`: long-lived
stateful sessions continuously batched into fixed-shape cohorts over one
`plan.run` window step on the card, with an LRU byte-budgeted state cache
(host spill + bit-identical restore) and operational metrics;
`client.py` adds the generator-based `StreamClient` facade for
application code that wants chunks-in / windows-out. The JAX package's LM
prompt loop (`serve/loop.py`) comes with a later slice.
"""

from repro_torch.serve.client import StreamClient
from repro_torch.serve.engine import (BatchedEngine, EngineConfig,
                                      NaiveEngine, make_engine)

__all__ = ["EngineConfig", "BatchedEngine", "NaiveEngine", "make_engine",
           "StreamClient"]
