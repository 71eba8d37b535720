"""Co-running "processes" next to the linked step — UKL's multi-process
model (``src/repro/core/coprocess.py``).

UKL keeps ordinary processes running beside the kernel-linked application,
talking over standard IPC. Here the training step and the serving engine
co-run with plain host threads:

  * ``PrefetchWorker``  — stages batches onto the device ahead of the step
    (the NSS_PS pinned buffer feeder);
  * ``AsyncCheckpointer`` — copies state snapshots to the host and saves
    them off the critical path;
  * ``AdmissionWorker`` — the serving frontend: replays request arrival
    times and hands requests to the engine over a queue (the "ordinary
    process doing the networking beside the linked Redis" of the paper);
  * ``MetricWriter``    — drains metric payloads (registry snapshots, or
    device tensors that it copies to the host) off the dispatch thread.

None ever blocks the step's or the engine's dispatch.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterator, Optional

import torch

from repro_torch import tree


def _to_host(x):
    """Device tensors -> host values, through dicts, lists and tuples."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().tolist()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


class PrefetchWorker:
    """Stages items from a host iterator with ``put_fn`` (onto the device),
    ``depth`` ahead, on a thread (``coprocess.py:30``)."""

    def __init__(self, it: Iterator, put_fn: Callable[[Any], Any],
                 depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def run():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
                    self._q.put(put_fn(item))
            finally:
                self._q.put(None)

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        while True:  # drain so the producer can exit
            try:
                self._q.get_nowait()
            except queue.Empty:
                break


class AsyncCheckpointer:
    """Runs ``save_fn(state, step)`` on a worker thread; never blocks a
    step (``coprocess.py:64``). The worker copies the state's tensors to
    the host first, so a caller that updates its state in place (L2+) must
    submit a snapshot of its own, which the driver makes (a device copy)
    before it dispatches the step. An error in ``save_fn`` is raised on
    the next ``submit`` or on ``close``."""

    def __init__(self, save_fn: Callable[[Any, int], None]):
        self._save_fn = save_fn
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            state, step = item
            try:
                host = tree.tree_map(
                    lambda x: x.detach().cpu()
                    if isinstance(x, torch.Tensor) else x, state)
                self._save_fn(host, step)
            except BaseException as e:  # surfaced on next submit/close
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, state, step: int):
        if self._err is not None:
            raise self._err
        self._q.put((state, step))

    def wait(self):
        """Block until every submitted save has run (the driver's restore
        then finds the latest commit on disk)."""
        self._q.join()
        if self._err is not None:
            raise self._err

    def close(self, wait: bool = True):
        self._q.put(None)
        if wait:
            self._t.join()
        if self._err is not None:
            raise self._err


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
