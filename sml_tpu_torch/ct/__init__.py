"""Continuous training: the round-level boost checkpoints.

The port's part of `sml_tpu/ct`: `BoostCheckpoint`, `checkpointed_fit`
and `checkpointed_warm_start` (`_checkpoint.py`), so that an interrupted
boosting fit resumes from its last segment boundary. The live sources,
the trainer, the canary gate and the elastic fits wait for the port's
streaming, tracking and multi-GPU slices.
"""

from ._checkpoint import (BoostCheckpoint, checkpointed_fit,
                          checkpointed_warm_start)

__all__ = ["BoostCheckpoint", "checkpointed_fit", "checkpointed_warm_start"]
