"""Continuous-batching serving over the UKL linkage spectrum, in PyTorch
(``src/repro/serve``): a request-level engine whose decode program is built
at any point of the linkage spectrum, with ordinary co-processes
(admission, metrics) running beside it."""
from repro_torch.serve.cache import (KVBackend, SlottedKV, init_slot_cache,
                                     slotify, write_slot)
from repro_torch.serve.engine import ServeEngine, check_slice, serve_report
from repro_torch.serve.scheduler import (MIN_BUCKET, Completion, Request,
                                         SlotScheduler, SlotState, bucket_len,
                                         synthetic_requests)
from repro_torch.serve.telemetry import NULL_TELEMETRY, Telemetry

__all__ = [
    "Completion", "KVBackend", "MIN_BUCKET", "NULL_TELEMETRY", "Request",
    "ServeEngine", "SlotScheduler", "SlotState", "SlottedKV", "Telemetry",
    "bucket_len", "check_slice", "init_slot_cache", "serve_report",
    "slotify", "synthetic_requests", "write_slot",
]
