"""The thread cap of the port's tests under pytest-xdist.

Each xdist worker is a process of its own, and torch would run one
intra-op thread a core in each: six workers on eight cores ran 48
threads, and the port's tests slowed by up to 100x (one chunked paged
case: 356 s under six workers against 3.06 s alone). Every
``test_torch_*`` module calls ``cap_threads`` when it is imported, so the
cap holds whichever files a run collects.
"""
import os


def cap_threads() -> None:
    """Under pytest-xdist, give torch in this worker its share of the
    cores (at least one thread); elsewhere leave it as it is."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        import torch
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(workers)))
