"""repro_torch — the PyTorch + CUDA port of the TaiBai reproduction.

It mirrors `src/repro/` (the JAX package, which stays the reference)
module for module, so each counterpart is found by its path. It imports
`torch` and numpy and never `jax` or `repro`.

Entry points (`core.plan.run`, `core.events.init_state`,
`core.snn_layers.make_dhsnn_shd`, `core.snn_layers.make_srnn_ecg`,
`core.snn_layers.bci_init`, `serve.make_engine` / `serve.BatchedEngine`)
default to device="cuda" and
run on the CPU only when the caller passes device="cpu"; with no card and
no explicit CPU they raise. `kernels.attention.ops.flash_attention` runs
where its tensors lie, and `kernels.parity` (`python -m
repro_torch.kernels.parity`) holds every kernel against its plain version
on the card and refuses the CPU. Every TPU kernel of the JAX package has a
hand-written CUDA counterpart (`csrc/*.cu`, built for sm_90a at first use
by `kernels/_build.py`): serving, compressed topology, block-sparse INTEG,
on-chip learning and flash attention. The mapping compiler
(`core.mapping`) and the behavioural simulator (`core.simulator`) turn a
run's spike record into TaiBai's modelled power, as the JAX package does.
"""

__version__ = "0.1.0"
