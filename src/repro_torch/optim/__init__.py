"""The optimizer of the port (``src/repro/optim``): AdamW from scratch.
``optim/compress.py`` (gradient compression for the data-parallel
all-reduce) waits for training over a mesh, ROADMAP entry 9b."""
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, global_norm,
                                     init, schedule_lr, update)

__all__ = ["AdamWConfig", "AdamWState", "global_norm", "init", "schedule_lr",
           "update"]
