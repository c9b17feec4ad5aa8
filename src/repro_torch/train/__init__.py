"""train — the fault-tolerant runtime around a run (port of `repro.train`).

checkpoint.py   chunked-npz checkpoints with manifest + integrity hashes,
                async save, keep-last-k, and `StreamCheckpointer` for
                chunked-online SNN streams; the format is the JAX
                package's, so either package restores the other's
                checkpoints. The LM training loop (`repro.train.loop`)
                comes with the LM shelf (ROADMAP.md, Open items 1, item 11).
"""

from repro_torch.train.checkpoint import (CheckpointManager,
                                          StreamCheckpointer, latest_step,
                                          restore_checkpoint,
                                          save_checkpoint)

__all__ = ["CheckpointManager", "StreamCheckpointer", "latest_step",
           "restore_checkpoint", "save_checkpoint"]
