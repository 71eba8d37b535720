"""Checkpoints of the port (``src/repro/checkpoint``)."""
from repro_torch.checkpoint.ckpt import (latest_step, list_steps, prune,
                                         restore, save)

__all__ = ["latest_step", "list_steps", "prune", "restore", "save"]
