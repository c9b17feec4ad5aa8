"""repro_torch — the PyTorch + CUDA port of the TaiBai reproduction.

It mirrors `src/repro/` (the JAX package, which stays the reference)
module for module, so each counterpart is found by its path. It imports
`torch` and numpy and never `jax` or `repro`.

Entry points (`core.plan.run`, `core.events.init_state`,
`core.snn_layers.make_dhsnn_shd`, `serve.make_engine` /
`serve.BatchedEngine`) default to device="cuda" and run on the CPU only
when the caller passes device="cpu"; with no card and no explicit CPU
they raise. The TPU kernels on the serving path are hand-written CUDA
(`csrc/*.cu`, built for sm_90a at first use by `kernels/_build.py`).
"""

__version__ = "0.1.0"
