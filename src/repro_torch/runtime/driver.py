"""Fault-tolerant training driver (``src/repro/runtime/driver.py``).

  * **checkpoint/restart** — async snapshots every ``ckpt_every`` steps
    (the ``AsyncCheckpointer`` co-process), committed atomically; on a
    step failure the driver restores the latest commit and *replays the
    data stream from that step* (the pipeline is step-indexed and
    deterministic, and so is the step on one device, so recovery is
    exact);
  * **retry budget** — a failing step is retried from the checkpoint up to
    ``max_restarts`` times before the error surfaces;
  * **straggler watchdog** — a per-step deadline (an EWMA of recent step
    times x ``straggler_factor``); an over-deadline step is counted (at
    scale it would be re-dispatched to a healthy replica).

The driver is linkage-aware: at L2+ (in-place updates) the snapshot it
hands the saver is a device copy taken before dispatch; at L3 it stages
``nss_steps`` batches at a time; under ret_async it reads the metrics
only every ``linkage.sync_every`` calls, and at the end those of the
last call if it has not read them (JAX's driver reads them again).

Over a mesh (``mesh``, with the sharded step's ``state_specs`` and
``batch_specs``) every rank runs this loop in lockstep, making the same
collectives in the same order: each stages its batch rows; a
checkpoint's snapshot is gathered over the mesh (a fresh copy: the full
logical arrays) and rank 0's saver alone writes it; before a restore
rank 0 waits for its saver, and the ranks take rank 0's latest committed
step (``Mesh.agree``, then a barrier), never listing the directory each
while rank 0 may be writing; each restores its pieces under the current
specs. A failure must reach every rank at the same step (a
``FailureInjector`` a rank, the same steps): a rank that fails alone
leaves the others in a collective until the group's timeout.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch import checkpoint as ckpt
from repro_torch import tree
from repro_torch.core.coprocess import AsyncCheckpointer
from repro_torch.core.linkage import L3_NSS, LinkageConfig
from repro_torch.data.pipeline import Pipeline, stage
from repro_torch.sharding.rules import gather


@dataclasses.dataclass
class DriverConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = "/tmp/repro_ckpt"
    max_restarts: int = 3
    straggler_factor: float = 3.0
    straggler_grace_steps: int = 5     # steps before the EWMA is trusted
    keep_ckpts: int = 3


@dataclasses.dataclass
class DriverReport:
    steps_run: int = 0
    restarts: int = 0
    straggler_redispatches: int = 0
    final_metrics: Optional[Dict[str, Any]] = None
    losses: List[float] = dataclasses.field(default_factory=list)
    #: every step's loss the driver read: at L3 each read call's
    #: microsteps ("loss_steps"), else the loss it read; ``losses`` keeps
    #: JAX's one loss a read
    step_losses: List[float] = dataclasses.field(default_factory=list)
    #: the state after the last step (this rank's pieces over a mesh)
    state: Any = None


class FailureInjector:
    """Test hook: raise at given step indices (once each)."""

    def __init__(self, fail_at=(), exc=RuntimeError):
        self.fail_at = set(fail_at)
        self.exc = exc

    def maybe_fail(self, step: int):
        if step in self.fail_at:
            self.fail_at.discard(step)
            raise self.exc(f"injected failure at step {step}")


def _host(metrics: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    return {k: v.tolist() for k, v in metrics.items()}


def _read(report: DriverReport, metrics: Dict[str, torch.Tensor]) -> None:
    """Record a call's losses on the host (the driver's one sync)."""
    got = _host(metrics)
    report.losses.append(got["loss"])
    report.step_losses.extend(got.get("loss_steps", [got["loss"]]))


def train(step_fn: Callable, state, pipeline: Pipeline,
          linkage: LinkageConfig, dcfg: DriverConfig,
          injector: Optional[FailureInjector] = None, *,
          batch_specs=None, state_specs=None, mesh=None) -> DriverReport:
    """Run ``total_steps`` optimizer steps with full fault handling.

    ``step_fn(state, batch) -> (state, metrics)``; at L3 the batch carries
    a leading ``nss_steps`` dim and one call advances ``nss_steps`` steps.
    Batches are staged on the device of the state's step counter. Over a
    mesh, ``state`` is this rank's pieces and ``step_fn`` the sharded
    step (``build_sharded_train_step``: its specs)."""
    report = DriverReport()
    writes = mesh is None or mesh.rank == 0
    saver = AsyncCheckpointer(
        lambda host_state, step: (ckpt.save(dcfg.ckpt_dir, step, host_state),
                                  ckpt.prune(dcfg.ckpt_dir, dcfg.keep_ckpts)))
    k = linkage.steps_per_call
    device = state.step.device
    step = int(state.step)
    restarts = 0
    ewma: Optional[float] = None
    pending_metrics = None
    calls_since_sync = 0

    try:
        while step < dcfg.total_steps:
            # ---- stage the batch (PrefetchWorker in examples; direct here)
            raw = (pipeline.stacked_at(step, k) if linkage.level == L3_NSS
                   else pipeline.batch_at(step))
            batch = stage(raw, device, batch_specs, mesh)

            # ---- checkpoint BEFORE dispatch; at L2+ the step updates the
            # state in place, so the saver gets its own device copy (freed
            # once the host copy is made); over a mesh the gathered full
            # arrays are that copy, but for the leaves no axis cuts
            if step % dcfg.ckpt_every == 0 and step > 0:
                snap = (state if mesh is None
                        else gather(state, state_specs, mesh))
                if linkage.donate:
                    snap = tree.tree_map(
                        lambda a, b: a.clone() if a is b else a, snap, state)
                if writes:
                    saver.submit(snap, step)
                del snap

            t0 = time.perf_counter()
            try:
                if injector is not None:
                    injector.maybe_fail(step)
                new_state, metrics = step_fn(state, batch)
                pending_metrics = metrics
                if not linkage.ret_async:
                    _read(report, metrics)
                else:
                    calls_since_sync += 1
                    if calls_since_sync >= max(linkage.sync_every, 1):
                        _read(report, metrics)
                        calls_since_sync = 0
                state = new_state
            except Exception:
                restarts += 1
                report.restarts = restarts
                if restarts > dcfg.max_restarts:
                    raise
                # restore from the latest commit and replay the stream
                saver.wait()         # every submitted snapshot is committed
                latest = (ckpt.latest_step(dcfg.ckpt_dir) if writes
                          else None)
                if mesh is not None:
                    latest = mesh.agree([-1 if latest is None
                                         else latest])[0]
                    mesh.world.barrier()
                    latest = None if latest < 0 else latest
                if latest is None:
                    raise
                state = ckpt.restore(dcfg.ckpt_dir, latest, state,
                                     state_specs, mesh)
                step = latest
                continue

            dt = time.perf_counter() - t0
            # ---- straggler watchdog
            if (ewma is not None
                    and report.steps_run > dcfg.straggler_grace_steps
                    and dt > dcfg.straggler_factor * ewma):
                report.straggler_redispatches += 1
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt

            step += k
            report.steps_run += k

        report.state = state
        # final sync (RET mode may have outstanding metrics)
        if pending_metrics is not None:
            report.final_metrics = _host(pending_metrics)
            if linkage.ret_async and calls_since_sync:
                _read(report, pending_metrics)
    finally:
        saver.close(wait=True)
    return report
