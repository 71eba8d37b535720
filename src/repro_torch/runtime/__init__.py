"""The fault-tolerant training driver of the port (``src/repro/runtime``)."""
from repro_torch.runtime.driver import (DriverConfig, DriverReport,
                                        FailureInjector, train)

__all__ = ["DriverConfig", "DriverReport", "FailureInjector", "train"]
