"""Continuous-batching serving over the UKL linkage spectrum, in PyTorch
(``src/repro/serve``): a request-level engine whose decode program is built
at any point of the linkage spectrum, with ordinary co-processes
(admission, metrics) running beside it, and a fleet of engine replicas
behind one router."""
from repro_torch.serve.cache import (KVBackend, SlottedKV, init_slot_cache,
                                     slotify, write_slot)
from repro_torch.serve.engine import ServeEngine, check_slice, serve_report
from repro_torch.serve.fleet import (FleetEngine, ReplicaView, fleet_report,
                                     route_request)
from repro_torch.serve.paging import (BlockPool, BlockTable, HostBlockStore,
                                      PagedKV, PrefixIndex, SharedHostTier,
                                      SwapHandle, SwapStream,
                                      init_paged_cache)
from repro_torch.serve.scheduler import (MIN_BUCKET, BudgetTuner, Completion,
                                         DraftProposer, PreemptionPolicy,
                                         Request,
                                         SlotScheduler, SlotState, bucket_len,
                                         pack_chunks, synthetic_requests)
from repro_torch.serve.telemetry import NULL_TELEMETRY, Telemetry

__all__ = [
    "BlockPool", "BlockTable", "BudgetTuner", "Completion", "DraftProposer",
    "FleetEngine", "HostBlockStore", "KVBackend", "MIN_BUCKET",
    "NULL_TELEMETRY", "PagedKV", "PreemptionPolicy", "PrefixIndex",
    "ReplicaView", "Request", "ServeEngine", "SharedHostTier",
    "SlotScheduler", "SlotState", "SlottedKV", "SwapHandle", "SwapStream",
    "Telemetry", "bucket_len", "check_slice", "fleet_report",
    "init_paged_cache", "init_slot_cache", "pack_chunks", "route_request",
    "serve_report", "slotify", "synthetic_requests", "write_slot",
]
