"""Co-running "processes" next to the linked step — UKL's multi-process
model (``src/repro/core/coprocess.py``, serving subset).

UKL keeps ordinary processes running beside the kernel-linked application,
talking over standard IPC. Here the serving engine co-runs with two plain
host threads:

  * ``AdmissionWorker`` — the serving frontend: replays request arrival
    times and hands requests to the engine over a queue (the "ordinary
    process doing the networking beside the linked Redis" of the paper);
  * ``MetricWriter``    — drains metric payloads (registry snapshots, or
    device tensors that it copies to the host) off the dispatch thread.

Neither ever blocks the engine's dispatch.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

import torch


def _to_host(x):
    """Device tensors -> host values, through dicts, lists and tuples."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().tolist()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


class MetricWriter:
    """Drains metric payloads on a worker thread (RET-mode companion).

    The serving engine's ``repro_torch.serve.telemetry.Telemetry`` submits
    ``MetricsRegistry.snapshot()`` dicts every ``--log-interval`` — plain
    host floats, passed through untouched; tensors are copied to the host
    on the worker. Sink exceptions are captured and re-raised on the next
    ``submit`` or on ``close``: a crashed sink must not silently drop every
    later metric.
    """

    def __init__(self, sink: Callable[[int, dict], None]):
        self._sink = sink
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, metrics = item
            try:
                self._sink(step, _to_host(metrics))
            except BaseException as e:  # surfaced on next submit/close
                self._err = e

    def submit(self, step: int, metrics):
        if self._err is not None:
            raise self._err
        self._q.put((step, metrics))

    def close(self):
        self._q.put(None)
        self._t.join()
        if self._err is not None:
            raise self._err


class AdmissionWorker:
    """Open-loop request source: replays arrival timestamps on a thread.

    Takes a list of ``repro_torch.serve.scheduler.Request`` (or anything
    with an ``arrival_s`` attribute) and makes each one available at its
    arrival time, independent of how fast the engine drains them — the
    defining property of open-loop load. The engine ``poll()``s between
    decode programs and ``wait()``s only when it has no active slots (the
    device is idle anyway, exactly when blocking costs nothing).
    """

    def __init__(self, requests, clock: Callable[[], float] = time.monotonic):
        """``clock`` must advance with real time (it may be offset or scaled;
        the wait loop re-reads it, so a frozen clock would never release)."""
        self._q: "queue.Queue" = queue.Queue()
        self._total = len(requests)
        self._delivered = 0

        def run():
            t0 = clock()
            for r in sorted(requests, key=lambda r: r.arrival_s):
                while True:
                    delay = r.arrival_s - (clock() - t0)
                    if delay <= 0:
                        break
                    time.sleep(min(delay, 0.005))
                self._q.put(r)

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    @property
    def exhausted(self) -> bool:
        """True once every request has been handed to the caller."""
        return self._delivered >= self._total

    def poll(self):
        """Drain every request that has arrived; never blocks."""
        out = []
        while True:
            try:
                out.append(self._q.get_nowait())
            except queue.Empty:
                break
        self._delivered += len(out)
        return out

    def wait(self, timeout: Optional[float] = None):
        """Block for the next arrival; None on timeout."""
        try:
            r = self._q.get(timeout=timeout)
        except queue.Empty:
            return None
        self._delivered += 1
        return r
