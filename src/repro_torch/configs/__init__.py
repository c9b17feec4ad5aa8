"""configs — the paper's SNN benchmark networks (`snn_models`).

The port's counterpart of `repro/configs/`. Only `snn_models` (Table II's
networks and the Fig. 14 topology models, for the mapping compiler and
the behavioural simulator) is ported; the language-model registry that the
JAX package builds on `repro.models` waits for the LM shelf (ROADMAP.md,
Open items 1, item 11).
"""

from repro_torch.configs import snn_models

__all__ = ["snn_models"]
