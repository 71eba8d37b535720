"""Fleet serving: an engine-replica router with prefill/decode
disaggregation over a shared cross-replica prefix store — the port of
``src/repro/serve/fleet.py``.

UKL keeps one specialized hot process linked into the kernel and runs
ordinary co-processes beside it; MultiK runs several specialized kernels
under one orchestrator. This module is that split for the serving engine:
N in-process ``ServeEngine`` replicas — each a scheduler, a block pool and
its programs, all over ONE copy of the weights on the device — behind one
router, with three fleet-level mechanisms:

  router          a request goes to the replica holding the longest
                  device-resident radix prefix of its prompt (session
                  affinity), least loaded on ties, bounded by a per-replica
                  admission cap (queue-depth backpressure).
  disaggregation  *prefill cells* absorb prompts (chunked) and hand each
                  finished KV chain to a *decode cell* over the host tier:
                  the handoff is a ``swap_out`` whose ``swap_in`` lands in
                  another replica's pool, so decode cells never stall
                  behind a long prompt, and swap round-trip identity makes
                  the disaggregated streams those of the colocated engine.
  shared store    one ``SharedHostTier`` all replicas demote into, publish
                  through and promote from: a prefix prefilled by any
                  replica warms the whole fleet.

The fleet tick is split-phase: every replica's program is *dispatched*
before any replica's blocking host sync (*commit*). All replicas enqueue on
the current CUDA stream, as JAX's replicas share one device queue. With
one replica the two phases run back to back, which is exactly
``ServeEngine._admit_and_step``: a 1-replica fleet serves the bare
engine's streams.

With ``mesh`` every replica runs over the one mesh (JAX passes one mesh
to every replica): every rank holds its shard of the weights once, cut
once for all replicas, and its own ``SharedHostTier`` over its KV heads,
so a handoff moves each rank's shard of a chain through that rank's
tier. Every routing decision, tick and handoff reads state every rank
shares (queue depths, loads, resident prefixes: the same block decisions
on every rank), so the ranks agree by construction; open-load arrivals
come from rank 0 (``MeshArrivals``), as in the engine.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, List, Optional, Tuple

import numpy as np

from repro_torch.core.coprocess import AdmissionWorker
from repro_torch.core.linkage import LinkageConfig
from repro_torch.serve.engine import (MeshArrivals, ServeEngine,
                                      check_servable, serve_report)
from repro_torch.serve.paging import SharedHostTier
from repro_torch.serve.scheduler import Completion, Request
from repro_torch.serve.telemetry import NULL_TELEMETRY, Telemetry


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReplicaView:
    """What the router sees of one replica when placing one request."""
    idx: int            # replica index
    queue_depth: int    # requests queued (not yet in a slot)
    active: int         # slots currently decoding/prefilling
    swapped: int        # suspended sequences parked on the host tier
    cap: int            # admission cap: max queue_depth the router may reach
    match_tokens: int   # longest device-resident radix prefix of THIS
                        # request's prompt (full blocks, in tokens)

    @property
    def load(self) -> int:
        return self.queue_depth + self.active + self.swapped


def route_request(views: List[ReplicaView]) -> Optional[int]:
    """Pick the replica for one request, or None when every replica is at
    its admission cap (backpressure: the caller holds the request).

    Policy, in order: (1) never exceed a replica's cap; (2) the longest
    resident shared-prefix match wins; (3) the least total load (queued +
    active + swapped) among ties; (4) the lowest index."""
    eligible = [v for v in views if v.queue_depth < v.cap]
    if not eligible:
        return None
    best = max(eligible,
               key=lambda v: (v.match_tokens, -v.load, -v.idx))
    return best.idx


def _resident_match(kv, prompt: np.ndarray) -> int:
    """Longest device-resident full-block prefix of ``prompt`` in ``kv``'s
    radix index, in tokens. Read-only: unlike ``PrefixIndex.match`` it
    touches no LRU tick, so probing N replicas to route one request
    perturbs nothing (a 1-replica fleet keeps the bare engine's eviction
    order)."""
    index = getattr(kv, "index", None)
    if index is None:
        return 0                      # slotted: no prefix structure
    bs = index.block_size
    node, n = index.root, 0
    for i in range(len(prompt) // bs):
        key = tuple(int(t) for t in prompt[i * bs:(i + 1) * bs])
        child = node.children.get(key)
        if child is None:
            break
        n += bs
        node = child
    return n


# ---------------------------------------------------------------------------
# Fleet
# ---------------------------------------------------------------------------

class FleetEngine:
    """N in-process ``ServeEngine`` replicas behind one router.

    ``prefill_replicas=P`` turns on disaggregation: replicas [0, P) are
    prefill cells (the router admits only to them), replicas [P, N) decode
    cells (they take work only as handoffs). P = 0 (the default) runs every
    replica colocated.

    All replicas share the parameters (one dict, one copy on the device),
    the telemetry bundle (events carry a replica id) and, on the paged
    backend, one ``SharedHostTier``. With ``mesh`` (a live
    ``repro_torch.launch.mesh.Mesh``) every replica serves over it, from
    this rank's one shard of the weights and its one tier. The
    constructor issues no collective: ranks that share a card build their
    fleets one at a time (``Mesh.in_turn``).
    """

    def __init__(self, cfg, params, opts, linkage: LinkageConfig, *,
                 replicas: int = 1, prefill_replicas: int = 0,
                 n_slots: int, max_len: int,
                 admit_cap: Optional[int] = None,
                 shared_host_blocks: Optional[int] = None,
                 telemetry: Optional[Telemetry] = None, mesh=None,
                 **engine_kwargs):
        check_servable(cfg)
        if replicas < 1:
            raise ValueError("fleet needs replicas >= 1")
        if not 0 <= prefill_replicas < replicas:
            raise ValueError("prefill_replicas must leave at least one "
                             "decode replica (0 <= P < replicas)")
        kv = engine_kwargs.get("kv", "slotted")
        if prefill_replicas and kv != "paged":
            raise ValueError("prefill/decode disaggregation moves KV chains "
                             "over the swap lane — it needs kv='paged'")
        self.replicas = replicas
        self.prefill_replicas = prefill_replicas
        self.n_slots = n_slots
        self.admit_cap = admit_cap if admit_cap is not None else 2 * n_slots
        if self.admit_cap < 1:
            raise ValueError("admit_cap must be >= 1")
        self.tel = telemetry if telemetry is not None else NULL_TELEMETRY
        self.mesh = mesh
        shard, tier_cfg = None, cfg
        if mesh is not None:
            # this rank's weights, cut once for every replica; the tier
            # holds this rank's KV heads (the local config's)
            from repro_torch.core.step import check_mesh_linkage
            from repro_torch.sharding.placement import serve_shard
            check_mesh_linkage(linkage, True)
            shard = serve_shard(cfg, params, mesh, n_slots)
            tier_cfg = shard.local_cfg

        # one host tier for the whole fleet: the shared prefix store and the
        # handoff lane, sized to mirror every replica's device pool by
        # default. LRU sheds cold prefixes when it fills, and a full tier
        # leaves a stream to decode on its prefill cell (values unchanged).
        self.shared: Optional[SharedHostTier] = None
        if kv == "paged":
            block_size = engine_kwargs.get("block_size", 16)
            nb = -(-max_len // block_size)
            dev_blocks = engine_kwargs.get("num_blocks") or n_slots * nb + 1
            hb = (shared_host_blocks if shared_host_blocks is not None
                  else replicas * dev_blocks)
            self.shared = SharedHostTier.build(
                tier_cfg, opts, block_size, hb,
                kv_dtype=engine_kwargs.get("kv_dtype", "bf16"),
                device=params["embed"].device)

        self.engines: List[ServeEngine] = []
        for i in range(replicas):
            kw = dict(engine_kwargs)
            if i > 0:
                # the warm-start file restores into the *shared* map: one
                # replica restoring it warms the whole fleet
                kw.pop("warm_start", None)
            if prefill_replicas and i < prefill_replicas:
                # prefill cells run chunked prefill only: admission is
                # bookkeeping, the prompt streams in through serve steps,
                # and the slot leaves for a decode cell the moment token #1
                # commits
                kw["chunked"] = True
            eng = ServeEngine(cfg, params, opts, linkage, n_slots, max_len,
                              telemetry=self.tel, shared_host=self.shared,
                              mesh=mesh, shard=shard, **kw)
            eng.kv.owner = i          # feeds the shared tier's writer map
            self.engines.append(eng)
        #: replicas the router may admit to (the prefill cells when
        #: disaggregated, every replica when colocated)
        self._admitting = list(range(prefill_replicas or replicas))
        self._decode_cells = (list(range(prefill_replicas, replicas))
                              if prefill_replicas else [])
        #: extracted handoffs no decode cell could hold yet, FIFO
        self._pending: Deque[tuple] = deque()
        self.handoffs = 0             # chains moved prefill cell -> decode

    # -- routing ------------------------------------------------------------

    def _views(self, prompt: np.ndarray) -> List[ReplicaView]:
        return [ReplicaView(
            idx=i,
            queue_depth=self.engines[i].sched.n_queued,
            active=len(self.engines[i].sched.active),
            swapped=len(self.engines[i].sched.swapped),
            cap=self.admit_cap,
            match_tokens=_resident_match(self.engines[i].kv, prompt))
            for i in self._admitting]

    def _route(self, req: Request, now: float) -> bool:
        """Enqueue ``req`` on the routed replica. False = every admitting
        replica is at its cap; the caller keeps the request."""
        idx = route_request(self._views(np.asarray(req.prompt)))
        if idx is None:
            return False
        req = dataclasses.replace(req, arrival_s=now) \
            if req.arrival_s == 0.0 else req
        self.engines[idx].sched.enqueue(req)
        self.tel.state(req.rid, "queued", req.arrival_s)
        return True

    # -- the fleet tick -----------------------------------------------------

    def _tick_all(self, now_fn: Callable[[], float]) -> List[Completion]:
        """One fleet step: dispatch every replica's program, then commit
        them in the same order (every program is queued before the first
        blocking sync), then move finished prefill chains to decode
        cells."""
        tel = self.tel
        tickets = []
        for i, eng in enumerate(self.engines):
            tel.set_engine(i)
            tickets.append(eng.tick_dispatch(now_fn))
        finished: List[Completion] = []
        for i, eng in enumerate(self.engines):
            tel.set_engine(i)
            finished += eng.tick_commit(tickets[i], now_fn)
        if self.prefill_replicas:
            self._move_handoffs()
        return finished

    def _move_handoffs(self) -> None:
        """Take decode-ready chains from the prefill cells and place each
        on the least-loaded decode cell that can hold it. Chains no cell
        can take yet stay held in the shared tier and retry next tick
        (FIFO, so a stuck head does not starve)."""
        tel = self.tel
        for p in self._admitting:
            tel.set_engine(p)
            for st, handle, nxt in self.engines[p].extract_handoffs():
                self._pending.append((p, st, handle, nxt))
        remaining: Deque[tuple] = deque()
        while self._pending:
            src, st, handle, nxt = self._pending.popleft()
            dsts = [d for d in self._decode_cells
                    if self.engines[d].sched.n_free > 0
                    and self.engines[d].kv.can_swap_in(handle)]
            if not dsts:
                remaining.append((src, st, handle, nxt))
                continue
            dst = min(dsts, key=lambda d: (
                len(self.engines[d].sched.active)
                + len(self.engines[d].sched.swapped)
                + self.engines[d].sched.n_queued, d))
            tel.set_engine(dst)
            # swap_in consumes the handle (clears hblks): count first
            nblocks = len(handle.hblks)
            nbytes = nblocks * self.engines[src].kv._block_bytes
            if not self.engines[dst].inject_handoff(st, handle, nxt):
                remaining.append((src, st, handle, nxt))
                continue
            self.handoffs += 1
            tel.handoff(st.req.rid, src, dst, nblocks, nbytes)
        self._pending = remaining

    def _has_work(self) -> bool:
        return bool(self._pending) or any(
            e.sched.active or e.sched.can_admit() or e.sched.swapped
            for e in self.engines)

    # -- driving loops (as ServeEngine.run) ---------------------------------

    def run(self, requests: List[Request], *, load: str = "closed",
            concurrency: Optional[int] = None,
            clock: Callable[[], float] = time.monotonic
            ) -> Tuple[List[Completion], float]:
        """Serve ``requests`` across the fleet. Returns (completions,
        wall_s): completions pooled in finish order, as
        ``ServeEngine.run``."""
        n = len(requests)
        completions: List[Completion] = []
        t0 = clock()
        rel = lambda: clock() - t0
        self.tel.set_clock(rel)
        if load == "open":
            worker = (AdmissionWorker(requests, clock=clock)
                      if self.mesh is None
                      else MeshArrivals(requests, clock, self.mesh))
            waiting: Deque[Request] = deque()
            while len(completions) < n:
                waiting.extend(worker.poll())
                while waiting and self._route(waiting[0], rel()):
                    waiting.popleft()
                if (not self._has_work() and not waiting
                        and not worker.exhausted):
                    r = worker.wait(timeout=0.05)   # fleet idle: block
                    if r is not None:
                        waiting.append(r)
                    continue
                completions += self._tick_all(rel)
        elif load == "closed":
            conc = concurrency or sum(self.engines[i].n_slots
                                      for i in self._admitting)
            issued = 0
            outstanding = 0
            while len(completions) < n:
                while outstanding < conc and issued < n:
                    req = dataclasses.replace(requests[issued],
                                              arrival_s=rel())
                    if not self._route(req, rel()):
                        break         # every admitting replica at its cap
                    issued += 1
                    outstanding += 1
                done = self._tick_all(rel)
                outstanding -= len(done)
                completions += done
        else:
            raise ValueError(f"unknown load mode {load!r}")
        return completions, rel()

    # -- fleet-wide cache management ----------------------------------------

    def drop_prefix_cache(self) -> int:
        """Evict every replica's index-only device blocks AND the shared
        store's prefix entries (to shed warmup residue before a timed
        run). Swapped chains and handoffs in flight stay held."""
        freed = 0
        for eng in self.engines:
            if hasattr(eng.kv, "drop_prefix_cache"):
                freed += eng.kv.drop_prefix_cache()
        if self.shared is not None:
            for drain in self.shared.store.drains:
                drain()               # complete in-flight publishes first
            for key in list(self.shared.prefix_map):
                h = self.shared.prefix_map.pop(key)
                self.shared.prefix_keys.pop(h, None)
                self.shared.writer.pop(key, None)
                self.shared.store.free(h)
                freed += 1
            self.shared.store.hwm = self.shared.store.n_resident
        return freed

    def save_prefix_cache(self, path: str) -> int:
        """Persist the fleet's shared prefix map (every replica writes into
        the same tier, so one replica's save holds the fleet's)."""
        return self.engines[0].save_prefix_cache(path)

    # -- reporting ----------------------------------------------------------

    def utilization(self) -> dict:
        """Fleet utilization: integer counters summed across replicas, the
        shared store's and the handoffs' totals added, the per-replica
        breakdown under ``per_replica``."""
        utils = [e.utilization() for e in self.engines]
        agg: dict = {
            "replicas": self.replicas,
            "prefill_replicas": self.prefill_replicas,
            "fleet_handoffs": self.handoffs,
            "fleet_pending_handoffs": len(self._pending),
        }
        if self.shared is not None:
            agg["shared_store_entries"] = len(self.shared.prefix_map)
            agg["shared_store_cross_hits"] = self.shared.cross_hits
            agg["shared_store_blocks"] = self.shared.store.num_blocks
            agg["shared_store_resident"] = self.shared.store.n_resident
        # geometry constants and the shared tier's gauges (every replica
        # reports the one shared store) are not summed across replicas
        const = frozenset((
            "kv_block_size", "kv_bytes_per_block", "chunk_budget",
            "chunk_width", "kv_host_blocks_total", "kv_host_blocks_resident",
            "kv_host_blocks_hwm", "kv_host_shared", "kv_async_swap",
        ))
        for u in utils:
            for k, v in u.items():
                if k in const or isinstance(v, bool) or not isinstance(v, int):
                    continue
                agg[k] = agg.get(k, 0) + v
        for k in const | {"kv_backend", "preempt_policy", "step_mode",
                          "mesh", "kv_dtype"}:
            vals = {u.get(k) for u in utils}
            if len(vals) == 1 and vals != {None}:
                agg[k] = vals.pop()
        agg["per_replica"] = utils
        return agg

    def reset_counters(self) -> None:
        """Zero the fleet's and the replicas' counters (after a warmup
        run)."""
        for eng in self.engines:
            eng.reset_counters()      # the shared telemetry resets alike
        self.handoffs = 0
        if self.shared is not None:
            self.shared.cross_hits = 0


def fleet_report(completions: List[Completion], wall_s: float,
                 fleet: Optional[FleetEngine] = None) -> dict:
    """One report for the whole fleet: percentiles over the pooled
    completions, counters summed across replicas, and the per-replica
    breakdown under ``per_replica``."""
    return serve_report(completions, wall_s,
                        utilization=fleet.utilization() if fleet else None)
