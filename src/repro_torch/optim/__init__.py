"""The optimizer of the port (``src/repro/optim``): AdamW from scratch,
and the int8-compressed data-parallel reduce (``compress``)."""
from repro_torch.optim import compress
from repro_torch.optim.adamw import (AdamWConfig, AdamWState, global_norm,
                                     init, schedule_lr, update)

__all__ = ["AdamWConfig", "AdamWState", "compress", "global_norm", "init",
           "schedule_lr", "update"]
