"""Continuous-batching serving engine over the UKL linkage spectrum — the
two-phase (slotted or paged) and the paged chunked paths of
``src/repro/serve/engine.py``.

One persistent KV store lives on the device; between decode programs the
engine evicts finished sequences and prefills newly admitted prompts into
the freed slots, so the device never idles while work exists. The decode
program is built by ``repro_torch.core`` at the level the preset names:

  L1/L2      one token per program for the whole slot set; L2 updates the
             cache in place.
  L3 (NSS)   ``decode_steps`` tokens per program with no host sync between
             them — one host transition per K tokens for all slots.
  ret_async  RET: generated tokens stay on the device; the host copies them
             only when a request *finishes* (completion is length-based, so
             the host detects it without reading token values).
  shortcut   the hand-written Hopper kernels (flash attention at admission,
             slot, paged decode and paged prefill attention, fused RMSNorm).

Device memory is owned by a ``KVBackend`` (``kv=``):

  slotted    one dense ``max_len`` row per slot (``SlottedKV``).
  paged      demand-allocated fixed-size blocks, per-slot block tables,
             copy-on-write prefix sharing and, under pool pressure,
             recompute or swap-out preemption against a host block tier
             (``PreemptionPolicy``; swapped sequences resume without
             re-prefill, evicted shared prefixes demote to the host and
             persist across restarts via ``save_prefix_cache`` /
             ``warm_start``) (``repro_torch.serve.paging.PagedKV``).
             Admission is gated on free *blocks*.

Two step disciplines: two-phase (admission runs a blocking prefill, then
the occupied slots decode together) and chunked (``chunked=True``, on
either backend): every step is one program with a token budget, decode
tokens first and prompt chunks after, so admission never stalls decode.
Speculative decoding (``spec_decode="ngram"``) runs on either: a
scheduler-side ``DraftProposer`` drafts from each slot's own history, and
one verify program per step checks the drafts of every slot; a step where
no slot drew a draft runs the plain decode program.

The engine is deterministic for a fixed request list: admission is FIFO,
slots are assigned lowest-index-first, eviction happens only at program
boundaries, and sampling keys are derived from (seed, request id) — so
each request's tokens are the ones it would get alone through prefill +
decode, whichever backend, step discipline or speculation serves it
(tests/test_torch_serve.py, test_torch_paging.py, test_torch_spec.py).

The paged backend stores its blocks at ``kv_dtype`` "bf16" (the
activation dtype, the uncompressed control), "int8" or "fp8" (per-block
scaled codes, read by the fused-dequant kernels); the slotted backend
takes only "bf16" and raises ``ValueError`` otherwise. Under async swap
(the default) the step boundary drains the swap stream and resumes
swapped slots before any admission, and the host work of the next step —
draining, prefetching the resume head's chain, packing chunk grants — runs
under the dispatched device program. With ``ttft_slo_s`` a
``BudgetTuner`` moves the chunked token budget after every completion.

An engine fleet (``repro_torch.serve.fleet``) drives replicas through the
split tick (``tick_dispatch`` / ``tick_commit``: every replica's program is
dispatched before any replica blocks on its result) and moves finished
prompts from prefill replicas to decode replicas (``extract_handoffs`` /
``inject_handoff``) over a host tier they share (``shared_host``).

With ``mesh`` (a ``repro_torch.launch.mesh.Mesh`` over the
``torch.distributed`` world, one rank a position) the engine is SPMD:
every rank runs this loop over its shard (``repro_torch.sharding.
placement``): weights tensor-parallel over "model", each rank's KV heads
in its cache, slots over "data" on the slotted backend. Every host
decision is a function of state every rank shares, except those that
read a clock: open-load arrivals (rank 0 runs the ``AdmissionWorker`` and
broadcasts what arrived) and the TTFT tuner's budget (rank 0's, broadcast
each tick). The swap stream polls no event (a transfer completes past
its depth or at a drain, both by count) and the draft proposer reads no
clock, so neither needs agreeing. Rank 0 reports. Every family the
engine serves runs at a model axis > 1 (MoE experts, Mamba channels and
RWKV heads split over it, ``repro_torch.sharding.placement``), and a
fleet's replicas share one mesh, each rank's host tier holding its shard
of every block; L0 with a mesh raises ``ValueError``, as in JAX. The
constructor issues no collective: ranks that share a card build their
engines one at a time (``Mesh.in_turn``), the others waiting at a
barrier.

An ``embeds_in`` model (musicgen-medium) and a cross-attention
model (llama-3.2-vision-11b) raise ``ValueError``: requests are token
ids, and no request carries a context, as in JAX.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import XATTN, ArchConfig
from repro_torch.core.coprocess import AdmissionWorker
from repro_torch.core.linkage import L3_NSS, LinkageConfig
from repro_torch.core.step import (SamplingConfig, check_mesh_linkage,
                                   program_label)
from repro_torch.serve.cache import KVBackend, SlottedKV
from repro_torch.serve.scheduler import (MIN_BUCKET, BudgetTuner,
                                         Completion, DraftProposer,
                                         PreemptionPolicy, Request,
                                         SlotScheduler, bucket_len,
                                         pack_chunks)
from repro_torch.serve.telemetry import NULL_TELEMETRY, Telemetry

KV_BACKENDS = ("slotted", "paged")
SPEC_MODES = ("none", "ngram")


def check_slice(*, kv: str = "slotted", spec_decode: str = "none",
                kv_dtype: str = "bf16") -> None:
    """Raise ``ValueError`` for a serving option or combination the
    reference rejects too."""
    if kv not in KV_BACKENDS:
        raise ValueError(f"unknown kv backend {kv!r}; known: {KV_BACKENDS}")
    if spec_decode not in SPEC_MODES:
        raise ValueError(f"unknown spec_decode {spec_decode!r}; known: "
                         f"{SPEC_MODES}")
    if kv == "slotted" and kv_dtype != "bf16":
        raise ValueError("kv_dtype quantization needs kv='paged': dense "
                         "slot rows have no per-block scale tables")


def check_servable(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for a model whose requests are not token ids
    alone: embedding inputs (JAX ``engine.py:108-109``) or cross-attention
    layers, whose context no request carries (JAX's engine cannot serve
    them either: its admission prefill passes no ``xctx``, and its
    attention asserts on one)."""
    if cfg.embeds_in:
        raise ValueError("serving engine takes token ids, not embeddings")
    if any(spec.mixer == XATTN for spec in cfg.block_pattern):
        raise ValueError("serving engine passes no cross-attention context "
                         "(xctx): run a cross-attention model at model "
                         "level (prefill / decode_step)")


def _host(t) -> np.ndarray:
    """A token tensor (or numpy array) as a host numpy array."""
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class MeshArrivals:
    """Open-load arrivals over a mesh, with ``AdmissionWorker``'s
    ``poll`` / ``wait`` / ``exhausted``: rank 0 runs the worker (its clock
    decides) and broadcasts how many requests arrived; every other rank
    takes as many from the same list in the worker's release order."""

    def __init__(self, requests, clock, mesh):
        self.mesh = mesh
        self.order = sorted(requests, key=lambda r: r.arrival_s)
        self.worker = (AdmissionWorker(requests, clock=clock)
                       if mesh.rank == 0 else None)
        self.released = 0

    @property
    def exhausted(self) -> bool:
        return self.released >= len(self.order)

    def _take(self, got: list) -> list:
        n = self.mesh.agree([len(got)])[0]
        if self.worker is None:
            got = self.order[self.released:self.released + n]
        self.released += n
        return got

    def poll(self) -> list:
        return self._take(self.worker.poll() if self.worker else [])

    def wait(self, timeout: Optional[float] = None):
        r = self.worker.wait(timeout=timeout) if self.worker else None
        got = self._take([] if r is None else [r])
        return got[0] if got else None


class ServeEngine:
    """Request-level continuous batching over a fixed slot pool.

    two-phase (default)  admission runs a blocking full-prompt prefill,
                         then occupied slots decode together.
    chunked              (``chunked=True``) no prefill phase: every step
                         is ONE program with a token budget, filled with
                         decode tokens from occupied slots first and prompt
                         *chunks* of admitting requests after; pure-decode
                         steps dispatch the plain decode program (or, with
                         speculation, the verify program). Token streams
                         are identical to the two-phase engine's.
    """

    #: smallest admission bucket (owned by the scheduler)
    MIN_BUCKET = MIN_BUCKET

    def __init__(self, cfg: ArchConfig, params, opts, linkage: LinkageConfig,
                 n_slots: int, max_len: int, *, kv: str = "slotted",
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 sampling: Optional[SamplingConfig] = None,
                 bucket_prompts: bool = False, chunked: bool = False,
                 chunk_budget: int = 256, chunk_width: int = 0,
                 preempt="recompute", host_blocks: Optional[int] = 0,
                 warm_start: Optional[str] = None,
                 ttft_slo_s: Optional[float] = None,
                 kv_dtype: str = "bf16", spec_decode: str = "none",
                 spec_width: int = 0, telemetry: Optional[Telemetry] = None,
                 async_swap: bool = True, shared_host=None, mesh=None,
                 shard=None):
        check_slice(kv=kv, spec_decode=spec_decode, kv_dtype=kv_dtype)
        linkage.validate()
        check_servable(cfg)
        if n_slots < 1:
            raise ValueError("serving engine needs n_slots >= 1")
        # a mesh: this rank's weights, local widths and collectives; the
        # programs below are built over them (opts.tp)
        self.mesh = mesh
        self.shard = None
        kcfg = cfg
        check_mesh_linkage(linkage, mesh is not None)
        if mesh is not None:
            # ``shard``: this rank's pieces already cut (a fleet's replicas
            # share one), else cut here from the full ``params``
            from repro_torch.sharding.placement import serve_shard
            self.shard = shard or serve_shard(cfg, params, mesh, n_slots)
            params, kcfg = self.shard.params, self.shard.local_cfg
            opts = dataclasses.replace(opts, tp=self.shard.tp)
        self.cfg = cfg
        self.params = params
        self.opts = opts
        self.linkage = linkage
        self.n_slots = n_slots
        self.max_len = max_len
        self.sampling = sampling or SamplingConfig()
        self.device = params["embed"].device
        self.tokens_per_program = (linkage.decode_steps
                                   if linkage.level == L3_NSS else 1)
        self.chunked = chunked
        if chunked:
            if chunk_budget < 1:
                raise ValueError("chunked serving needs chunk_budget >= 1")
            self.chunk_budget = chunk_budget
            # W: the per-row chunk width — every step pads to this one shape
            self.chunk_width = chunk_width or min(chunk_budget, max_len)
            if not 1 <= self.chunk_width <= max_len:
                raise ValueError(f"chunk_width must be in [1, max_len] "
                                 f"(got {self.chunk_width})")
        self.preempt = PreemptionPolicy.parse(preempt)
        if ttft_slo_s is not None and not chunked:
            raise ValueError("ttft_slo_s tunes the chunked token budget — "
                             "it needs chunked=True")
        # speculative decode: a scheduler-side DraftProposer feeds W-wide
        # draft-and-verify programs; "none" never builds the verify program
        self.proposer: Optional[DraftProposer] = None
        self.spec_width = 0
        if spec_decode != "none":
            self.spec_width = spec_width or 4
            if not 1 <= self.spec_width <= max_len:
                raise ValueError(f"spec_width must be in [1, max_len] "
                                 f"(got {self.spec_width})")
            self.proposer = DraftProposer(self.spec_width)
        spec = self.proposer is not None
        bucket_fn = self._bucket if bucket_prompts else None
        if kv == "paged":
            from repro_torch.serve.paging import PagedKV
            hb = host_blocks
            if hb in (0, None) and (self.preempt.mode == "swap"
                                    or warm_start):
                hb = None            # auto: mirror the device pool (and grow
                                     # to fit the warm-start file)
            self.kv: KVBackend = PagedKV(
                kcfg, params, opts, linkage, n_slots, max_len, self.sampling,
                bucket_fn, block_size=block_size, num_blocks=num_blocks,
                chunked=chunked, kv_dtype=kv_dtype, spec=spec,
                host_blocks=hb, warm_start=warm_start,
                async_swap=async_swap, shared_host=shared_host,
                shard=self.shard)
        else:
            # host_blocks=None means "auto-size the host tier" on paged —
            # reject it here too, not just explicit sizes
            if warm_start or host_blocks != 0:
                raise ValueError("the host tier (host_blocks / warm_start) "
                                 "needs kv='paged': dense slot rows have no "
                                 "block structure to spill")
            if shared_host is not None:
                raise ValueError("a shared host tier (shared_host) needs "
                                 "kv='paged': dense slot rows have no block "
                                 "structure to publish")
            self.kv = SlottedKV(kcfg, params, opts, linkage, n_slots,
                                max_len, self.sampling, bucket_fn,
                                chunked=chunked, spec=spec, shard=self.shard)
        # NULL_TELEMETRY is the zero-cost disabled bundle (every hook a
        # no-op, now() never reads a clock)
        self.tel = telemetry if telemetry is not None else NULL_TELEMETRY
        self.kv.tel = self.tel
        self._labels = {k: program_label(cfg, linkage, k)
                        for k in ("decode", "serve_chunk", "verify",
                                  "prefill_admit")}
        self.tuner: Optional[BudgetTuner] = None
        if ttft_slo_s is not None:
            self.tuner = BudgetTuner(
                slo_s=ttft_slo_s, budget=self.chunk_budget,
                floor=max(1, self.tokens_per_program),
                cap=(self.tokens_per_program + self.chunk_width) * n_slots)
        self._next = torch.zeros((n_slots,), dtype=torch.int32,
                                 device=self.device)
        self.sched = SlotScheduler(n_slots)
        # next-step chunk grants packed under the device step, keyed on the
        # exact pack_chunks inputs; _plan_chunks uses them only on an exact
        # key match (pack_chunks is pure, so a hit equals recomputing)
        self._pack_memo: Optional[Tuple[tuple, List[int]]] = None
        self.programs_run = 0
        self.tokens_wasted = 0       # decoded past a request's budget/EOS
        self.preemptions = 0         # paged: recompute-preempted admissions
        self.swap_preemptions = 0    # paged: swap-out preempted (host tier)
        self.swap_resumes = 0        # swapped slots resumed via swap-in
        self.prefill_tokens = 0      # prompt tokens admitted (incl. shared)
        self.decode_tokens = 0       # decode tokens produced
        self.spec_steps = 0          # verify programs run
        self.spec_draft_tokens = 0   # drafts fed into verify programs
        self.spec_accepted_tokens = 0   # ...that the model confirmed
        self.spec_wasted_tokens = 0  # ...that it rejected
        self.spec_emitted_tokens = 0    # tokens emitted by verify programs
        self.handoffs_out = 0        # fleet: chains handed to a decode cell
        self.handoffs_in = 0         # fleet: chains adopted from a prefill
                                     # cell (swap-in landed in this pool)

    def _bucket(self, n: int) -> int:
        """Power-of-two admission bucket (``scheduler.bucket_len``)."""
        return bucket_len(n, self.max_len)

    # -- admission ----------------------------------------------------------

    def _check_fits(self, slot: int, req: Request) -> None:
        if req.prompt.shape[0] + req.max_new_tokens > self.max_len:
            self.sched.release(slot)
            raise ValueError(
                f"request {req.rid}: prompt+budget exceeds max_len "
                f"{self.max_len}")
        if not self.kv.fits(int(req.prompt.shape[0]), req.max_new_tokens):
            self.sched.release(slot)
            raise ValueError(
                f"request {req.rid}: prompt+budget can never fit the "
                f"{self.kv.kind} KV store (pool too small)")

    def _admit(self, now_fn: Callable[[], float]) -> List[Completion]:
        tel = self.tel
        adm = now_fn()
        slot, req = self.sched.admit_next(adm)
        self._check_fits(slot, req)
        tel.admit(req.rid, slot, int(req.prompt.shape[0]), adm)
        t0 = tel.now()
        first = self.kv.admit(slot, np.asarray(req.prompt, np.int32),
                              self.sampling.request_key(req.rid, self.device))
        t1 = tel.now()
        self.prefill_tokens += int(req.prompt.shape[0])
        tel.prefill_tokens(int(req.prompt.shape[0]))
        self._next[slot] = first[0]
        st = self.sched.active[slot]
        # the prefill sample is generated token #1 of the budget
        if self.linkage.ret_async:
            st.chunks.append(first)                 # stays on the device
            t2 = t1
        else:
            f = _host(first)                        # "iret": sync now
            t2 = tel.now()
            st.chunks.append(f)
            if req.eos_id is not None and int(f[0]) == req.eos_id:
                st.eos_seen = True
        st.first_token_s = st.prefill_done_s = now_fn()
        st.note_emit(st.first_token_s)
        st.prefill_pos = int(req.prompt.shape[0])   # two-phase: all at once
        st.fresh = False
        st.produced = 1
        tel.state(req.rid, "decoding", st.first_token_s)
        tel.step("prefill_admit", self.programs_run, t0, 0.0, t1 - t0,
                 t2 - t1, tel.now() - t2, queued=self.sched.n_queued,
                 active=len(self.sched.active),
                 swapped=len(self.sched.swapped),
                 program=self._labels["prefill_admit"])
        if st.remaining == 0 or st.eos_seen:
            return [self._finalize(slot, now_fn)]
        return []

    # -- decode -------------------------------------------------------------

    def _reserve_all(self, width=None) -> None:
        """Demand-allocate the blocks this program will write — K decode
        tokens a slot, or ``width(state)`` for a verify row — preempting
        the youngest slot (recompute on re-admission) while the pool is
        dry. Oldest-first order keeps the head of the line progressing."""
        K = self.tokens_per_program
        while True:
            order = sorted(self.sched.active,
                           key=lambda s: self.sched.active[s].admit_seq)
            if all(self.kv.reserve(
                    s, K if width is None else width(self.sched.active[s]))
                   for s in order):
                return
            self._preempt_one()

    def _preempt_one(self) -> None:
        if len(self.sched.active) == 1:
            raise RuntimeError(
                "paged KV pool cannot hold a single active request; "
                "fits() should have rejected it")
        self._preempt(self.sched.choose_victim(self.preempt.victim))

    def _preempt(self, slot: int) -> None:
        """Evict ``slot`` under pool pressure, per the PreemptionPolicy:
        swap parks the slot state and its host-tier KV for an exact resume;
        recompute (or a failed swap: no host tier, or the tier held full)
        releases everything and requeues the request at the head of the
        line (re-admission replays its stream exactly)."""
        rid = self.sched.active[slot].req.rid
        if self.preempt.mode == "swap":
            handle = self.kv.swap_out(slot)
            if handle is not None:
                st = self.sched.release(slot)
                st.pending_drafts = None     # drafts die with the victim's
                                             # step; resume re-proposes
                # a copy: _next is written in place by later admissions
                self.sched.suspend_front(st, (handle,
                                              self._next[slot].clone()))
                self.swap_preemptions += 1
                now = self.tel.now()
                self.tel.preempt(rid, slot, "swap", now)
                self.tel.state(rid, "swapped", now)
                # stage the resume-head victim's host→device copy while
                # the victim's device blocks are being recycled
                self._prefetch_head()
                return
        st = self.sched.release(slot)
        self.kv.release(slot)
        self.sched.requeue_front(st.req)
        self.preemptions += 1
        now = self.tel.now()
        self.tel.preempt(rid, slot, "recompute", now)
        self.tel.state(rid, "preempted", now)
        self.tel.state(rid, "queued", now)

    def _resume_swapped(self) -> None:
        """Swap suspended slot states back in, oldest first — they are the
        head of the FIFO line, so fresh admissions wait behind them (the
        discipline recompute's requeue_front imposes). Stops at the first
        one the device pool cannot hold yet."""
        while self.sched.can_resume():
            handle, nxt = self.sched.peek_swapped()[1]
            if not self.kv.can_swap_in(handle):
                break                # FIFO: wait for blocks, don't skip ahead
            slot, st, _ = self.sched.resume_next()
            if not self.kv.swap_in(slot, handle):
                # can_swap_in raced nothing (single-threaded); should it
                # fail, recompute this request and free the handle's host
                # blocks so the tier cannot leak
                self.kv.drop_swap(handle)
                self.sched.release(slot)
                self.sched.requeue_front(st.req)
                self.preemptions += 1
                now = self.tel.now()
                self.tel.preempt(st.req.rid, slot, "recompute", now)
                self.tel.state(st.req.rid, "queued", now)
                continue
            self._next[slot] = nxt
            self.swap_resumes += 1
            self.tel.state(st.req.rid,
                           "prefilling" if st.prefilling else "decoding",
                           self.tel.now())
        # whatever still waits: stage the new resume head's copy so its
        # eventual swap-in is a prefetch hit
        self._prefetch_head()

    # -- async runtime: drain / prefetch / overlapped host work -------------

    def _drain_swaps(self) -> int:
        """Complete in-flight async swap transfers (no-op for backends
        without a stream). Called at step boundaries and in the overlap
        window, so deferred device→host copies never pile past the step."""
        drain = getattr(self.kv, "drain_swaps", None)
        return drain() if drain is not None else 0

    def _prefetch_head(self) -> bool:
        """Stage the host→device copy of the resume-head swapped victim
        (smallest original admit_seq — the one ``_resume_swapped`` pops
        first). Pure staging on the handle: no refcount moves until the
        swap-in, and the synchronous path (``--sync-swap``) makes it a
        no-op."""
        pf = getattr(self.kv, "prefetch_swap_in", None)
        if pf is None:
            return False
        head = self.sched.peek_swapped()
        if head is None:
            return False
        return pf(head[1][0])

    def _overlap_host_work(self) -> None:
        """Host work pipelined under the just-dispatched device step: drain
        the swap stream and stage the resume-head prefetch. Its cost lands
        inside the step's device phase instead of its pack/host phases."""
        tel = self.tel
        t = tel.now()
        if self._drain_swaps():
            tel.overlap("drain", tel.now() - t)
        if self.sched.swapped:
            t = tel.now()
            if self._prefetch_head():
                tel.overlap("prefetch", tel.now() - t)

    def step(self, now_fn: Callable[[], float]) -> List[Completion]:
        """Run one decode program; harvest tokens; evict finished slots.
        With speculation on, a verify program runs instead whenever some
        slot drew a draft. Split at the blocking host sync
        (``_step_begin``/``_step_end``), as in the JAX engine, whose fleet
        runtime dispatches every replica before committing any."""
        return self._step_end(self._step_begin(now_fn), now_fn)

    def _step_begin(self, now_fn: Callable[[], float]):
        """Dispatch half: reserve, launch the decode program, everything up
        to (excluding) the blocking host copy. The verify step reads its
        accept counts on the host, so it runs whole here and hands back
        its completions."""
        if self.proposer is not None:
            spec = self._step_spec(now_fn)
            if spec is not None:
                return ("done", spec)
        tel = self.tel
        t0 = tel.now()
        self._reserve_all()
        t1 = tel.now()
        toks = self.kv.decode(self._next)
        # a copy: later admissions write _next in place, and toks' rows
        # stay referenced by the slots' RET chunks
        self._next = toks[:, -1].clone()
        self.programs_run += 1
        t2 = tel.now()
        self._overlap_host_work()      # under the dispatched device step
        return ("decode", (toks, t0, t1, t2))

    def _step_end(self, pending, now_fn: Callable[[], float]
                  ) -> List[Completion]:
        """Commit half: block on the device result (iret), harvest tokens,
        evict finished slots, stamp the step trace event. Dispatches on the
        ticket tag of ``_step_begin`` / ``_chunk_begin``."""
        tag, data = pending
        if tag == "done":
            return data
        if tag == "chunk":
            return self._chunk_end(data, now_fn)
        tel = self.tel
        toks, t0, t1, t2 = data
        toks_host = None
        if not self.linkage.ret_async:
            toks_host = _host(toks)                 # "iret": sync every program
        t3 = tel.now()
        slots = sorted(self.sched.active)
        tel.decode_microsteps(len(slots), self.tokens_per_program, t1)
        finished = self._harvest_decode(slots, toks, toks_host, now_fn)
        tel.step("decode", self.programs_run, t0, t1 - t0, t2 - t1, t3 - t2,
                 tel.now() - t3, queued=self.sched.n_queued,
                 active=len(self.sched.active),
                 swapped=len(self.sched.swapped),
                 program=self._labels["decode"])
        return finished

    # -- speculative decode: draft-and-verify -------------------------------

    def _step_spec(self, now_fn: Callable[[], float]
                   ) -> Optional[List[Completion]]:
        """One draft-and-verify program (``engine.py:480-572``), or None to
        fall back to plain decode (no slot drew a draft).

        Every active slot rides the program: drafted rows at width 1 +
        |drafts|, the others at width 1, which is a decode step. The
        accept counts and tokens come to the host (the one sync the step
        needs, under RET too); each row's next token stays on the
        device."""
        order = sorted(self.sched.active)
        if not all(self.sched.active[s].produced > 0 for s in order):
            return None                   # a slot with no committed token
        tel = self.tel
        t0 = tel.now()
        any_draft = False
        for s in order:
            st = self.sched.active[s]
            st.pending_drafts = self.proposer.propose(st)
            any_draft = any_draft or st.pending_drafts.size > 0
        if not any_draft:
            for s in order:
                self.sched.active[s].pending_drafts = None
            return None
        # a row writes its committed token and its drafts this program
        self._reserve_all(lambda st: 1 + int(st.pending_drafts.size))
        order = sorted(self.sched.active)   # preemption may have evicted
        B, W = self.n_slots, self.spec_width
        toks = np.zeros((B, W), np.int32)
        clen = np.zeros(B, np.int32)
        start = np.zeros(B, np.int32)
        vmask = np.zeros(B, bool)
        nxt_host = _host(self._next)
        for s in order:
            st = self.sched.active[s]
            m = int(st.pending_drafts.size)
            toks[s, 0] = nxt_host[s]
            toks[s, 1:1 + m] = st.pending_drafts
            clen[s] = 1 + m
            start[s] = st.prompt_len + st.produced - 1   # next write position
            vmask[s] = True

        t1 = tel.now()
        out, n_emit = self.kv.verify_step(toks, clen, start, vmask)
        self.programs_run += 1
        self.spec_steps += 1
        last = out.gather(1, (n_emit.long() - 1).clamp_min(0)[:, None])
        self._next = torch.where(n_emit > 0, last[:, 0], self._next)
        t2 = tel.now()
        out_host, n_host = _host(out), _host(n_emit)
        t3 = tel.now()

        now = now_fn()
        finished = []
        for s in order:
            st = self.sched.active[s]
            m = int(st.pending_drafts.size)
            st.pending_drafts = None
            a = int(n_host[s])              # emitted = 1 + accepted drafts
            self.spec_draft_tokens += m
            self.spec_accepted_tokens += a - 1
            self.spec_wasted_tokens += m - (a - 1)
            self.spec_emitted_tokens += a
            tel.verify_window(s, st.req.rid, m, a - 1, now)
            chunk = out_host[s, :a]
            st.chunks.append(chunk)
            st.produced += a                # clamped drafting: never > budget
            self.decode_tokens += a
            if st.last_emit_s is not None:
                tel.emit_gap(now - st.last_emit_s)
            st.note_emit(now)
            if st.first_decode_s is None:
                st.first_decode_s = now
            if st.req.eos_id is not None and st.req.eos_id in chunk:
                st.eos_seen = True          # EOS inside the accepted window
            # commit = roll back to the accepted length: frees draft-tail
            # blocks (paged) and rewinds the host position
            self.kv.rollback(s, int(start[s]) + a)
            if st.produced >= st.req.max_new_tokens or st.eos_seen:
                finished.append(self._finalize(s, now_fn))
        tel.step("verify", self.programs_run, t0, t1 - t0, t2 - t1, t3 - t2,
                 tel.now() - t3, queued=self.sched.n_queued,
                 active=len(self.sched.active),
                 swapped=len(self.sched.swapped),
                 program=self._labels["verify"])
        return finished

    def _harvest_decode(self, slots, toks, toks_host,
                        now_fn: Callable[[], float]) -> List[Completion]:
        """Collect this program's decode tokens for ``slots``: append (up to
        the request budget), check EOS at the sync point, finalize finished.
        Shared by the two-phase step and the chunked step's decode half."""
        now = now_fn()
        finished = []
        for slot in slots:
            st = self.sched.active[slot]
            take = min(self.tokens_per_program, st.remaining)
            self.tokens_wasted += self.tokens_per_program - take
            if take == 0:
                continue
            chunk = (toks[slot, :take] if toks_host is None
                     else toks_host[slot, :take])
            st.chunks.append(chunk)
            st.produced += take
            self.decode_tokens += take
            if st.last_emit_s is not None:
                self.tel.emit_gap(now - st.last_emit_s)
            st.note_emit(now)
            if st.first_decode_s is None:
                st.first_decode_s = now
            if (toks_host is not None and st.req.eos_id is not None
                    and st.req.eos_id in chunk):
                st.eos_seen = True                  # stop at the sync point
            if st.produced >= st.req.max_new_tokens or st.eos_seen:
                finished.append(self._finalize(slot, now_fn))
        return finished

    # -- chunked prefill: the unified serve step ---------------------------

    def _admit_chunked(self, now_fn: Callable[[], float]) -> None:
        """Chunked admission is host bookkeeping only — no program runs, so
        admission never stalls occupied decode slots. The prompt enters the
        device chunk by chunk through later serve steps."""
        slot, req = self.sched.admit_next(now_fn())
        self._check_fits(slot, req)
        self.tel.admit(req.rid, slot, int(req.prompt.shape[0]),
                       self.sched.active[slot].admit_s)
        shared = self.kv.admit_chunked(
            slot, np.asarray(req.prompt, np.int32),
            self.sampling.request_key(req.rid, self.device))
        # count the radix-shared prefix so prefill_tokens means the same in
        # both step modes (prompt tokens admitted, shared or computed)
        self.prefill_tokens += shared
        self.tel.prefill_tokens(shared)
        self.sched.active[slot].prefill_pos = shared   # already resident

    def _plan_chunks(self):
        """Pack this step's token budget and reserve the memory it needs,
        preempting the youngest slot (recompute on re-admission) while the
        pool is dry. Returns (decode slots, prefill slots, grants) in FIFO
        admission order."""
        K = self.tokens_per_program
        while True:
            order = sorted(self.sched.active,
                           key=lambda s: self.sched.active[s].admit_seq)
            dec = [s for s in order if not self.sched.active[s].prefilling]
            pre = [s for s in order if self.sched.active[s].prefilling]
            remaining = [self.sched.active[s].prompt_len
                         - self.sched.active[s].prefill_pos for s in pre]
            key = (self.chunk_budget, self.chunk_width, K * len(dec),
                   tuple(remaining))
            if self._pack_memo is not None and self._pack_memo[0] == key:
                grants = self._pack_memo[1]
            else:
                grants = pack_chunks(self.chunk_budget, self.chunk_width,
                                     K * len(dec), remaining)
            self._pack_memo = None       # single-shot; replans recompute
            ok = all(self.kv.reserve(s, K) for s in dec)
            if ok:
                for s, g in zip(pre, grants):
                    st = self.sched.active[s]
                    if g and not self.kv.append_chunk(
                            s, st.prefill_pos,
                            st.req.prompt[st.prefill_pos:st.prefill_pos + g]):
                        ok = False
                        break
            if ok:
                return dec, pre, grants
            self._preempt_one()

    def _chunk_begin(self, now_fn: Callable[[], float]):
        """Dispatch half of the chunked serve step (see ``_step_begin``): one
        unified serve program, decode tokens for occupied slots plus
        budget-packed prompt chunks (``_chunk_end`` harvests both halves
        and evicts finished slots). Pure-decode steps (no slot mid-prefill)
        dispatch the two-phase decode program instead. The unified program
        runs whenever ANY slot is mid-prefill, even on a step that grants
        it no chunk tokens: the plain decode program would decode it as a
        decode row and write its garbage through its real block table."""
        if not any(self.sched.active[s].prefilling for s in self.sched.active):
            return self._step_begin(now_fn)
        tel = self.tel
        w0 = tel.now()
        B, W, K = self.n_slots, self.chunk_width, self.tokens_per_program
        dec, pre, grants = self._plan_chunks()
        tel.pack(self.chunk_budget, K * len(dec), int(sum(grants)), w0)
        toks = np.zeros((B, W), np.int32)
        clen = np.zeros(B, np.int32)
        start = np.zeros(B, np.int32)
        reset = np.zeros(B, bool)
        emit0 = np.zeros(B, bool)
        dec_mask = np.zeros(B, bool)
        for s in dec:
            st = self.sched.active[s]
            start[s] = st.prompt_len + st.produced - 1   # next write position
            dec_mask[s] = True
        for s, g in zip(pre, grants):
            st = self.sched.active[s]
            start[s] = st.prefill_pos
            clen[s] = g
            toks[s, :g] = st.req.prompt[st.prefill_pos:st.prefill_pos + g]
            if g:
                reset[s] = st.fresh
                st.fresh = False
                emit0[s] = st.prefill_pos + g == st.prompt_len
                tel.prefill_chunk(s, st.req.rid, st.prefill_pos, g, w0)

        w1 = tel.now()
        t0, seq = self.kv.serve_step(toks, clen, start, reset, emit0,
                                     dec_mask, self._next)
        self._next = torch.where(
            torch.from_numpy(emit0).to(seq.device), t0, seq[:, -1])
        self.programs_run += 1
        self.prefill_tokens += int(clen.sum())
        w2 = tel.now()
        tel.decode_microsteps(len(dec), K, w1)
        self._overlap_host_work()      # under the dispatched device step
        # pack the next step's grants now, under the dispatched device
        # step, keyed on the exact inputs _plan_chunks will see; a miss
        # (admission or preemption changed the picture) just recomputes
        nxt_rem = [r for s, g in zip(pre, grants)
                   for r in [self.sched.active[s].prompt_len
                             - (self.sched.active[s].prefill_pos + g)]
                   if r > 0]
        if nxt_rem:
            t = tel.now()
            ndec = len(dec) + sum(1 for s, g in zip(pre, grants) if emit0[s])
            key = (self.chunk_budget, W, K * ndec, tuple(nxt_rem))
            self._pack_memo = (key, pack_chunks(self.chunk_budget, W,
                                                K * ndec, nxt_rem))
            tel.overlap("pack", tel.now() - t)
        return ("chunk", (pre, grants, dec, emit0, t0, seq, w0, w1, w2))

    def _chunk_end(self, data, now_fn: Callable[[], float]
                   ) -> List[Completion]:
        """Commit half of the chunked serve step: sync, harvest prefill
        first-tokens and decode tokens, evict finished slots."""
        pre, grants, dec, emit0, t0, seq, w0, w1, w2 = data
        tel = self.tel
        t0_host = seq_host = None
        if not self.linkage.ret_async:
            t0_host, seq_host = _host(t0), _host(seq)
        w3 = tel.now()
        now = now_fn()
        finished = []
        for s, g in zip(pre, grants):
            st = self.sched.active[s]
            st.prefill_pos += g
            if not emit0[s]:
                continue
            # the chunk that completed the prompt yields generated token #1
            first = t0[s:s + 1] if t0_host is None else t0_host[s:s + 1]
            st.chunks.append(first)
            if (t0_host is not None and st.req.eos_id is not None
                    and int(first[0]) == st.req.eos_id):
                st.eos_seen = True
            st.first_token_s = st.prefill_done_s = now
            st.note_emit(now)
            st.produced = 1
            tel.state(st.req.rid, "decoding", now)
            if st.remaining == 0 or st.eos_seen:
                finished.append(self._finalize(s, now_fn))
        finished += self._harvest_decode(dec, seq, seq_host, now_fn)
        tel.step("serve_chunk", self.programs_run, w0, w1 - w0, w2 - w1,
                 w3 - w2, tel.now() - w3, queued=self.sched.n_queued,
                 active=len(self.sched.active),
                 swapped=len(self.sched.swapped),
                 program=self._labels["serve_chunk"])
        return finished

    def _finalize(self, slot: int,
                  now_fn: Callable[[], float]) -> Completion:
        st = self.sched.release(slot)
        self.kv.release(slot)                       # paged: free blocks now
        # RET mode synchronizes here, once per completed request
        tokens = np.concatenate([_host(c) for c in st.chunks])
        if st.req.eos_id is not None:
            hits = np.nonzero(tokens == st.req.eos_id)[0]
            if hits.size:
                self.tokens_wasted += len(tokens) - (int(hits[0]) + 1)
                tokens = tokens[:int(hits[0]) + 1]
        done = now_fn()
        fd = st.first_decode_s if st.first_decode_s is not None else done
        c = Completion(
            rid=st.req.rid, prompt_len=int(st.req.prompt.shape[0]),
            tokens=tokens, arrival_s=st.req.arrival_s, admit_s=st.admit_s,
            first_token_s=st.first_token_s, done_s=done,
            prefill_done_s=st.prefill_done_s, first_decode_s=fd,
            max_stall_s=st.max_stall_s)
        self.tel.complete(c, done)
        return c

    # -- driving loop -------------------------------------------------------

    def _admit_and_step(self, now_fn) -> List[Completion]:
        """One engine tick: at the step boundary drain the swap stream and
        resume swapped slots, then FIFO admissions into free slots (behind
        any swapped slot: they are the head of the line), then one program
        over the occupied ones; each completion feeds the TTFT tuner."""
        return self.tick_commit(self.tick_dispatch(now_fn), now_fn)

    def tick_dispatch(self, now_fn) -> Tuple[List[Completion],
                                             Optional[tuple]]:
        """Dispatch half of one engine tick: the drain, the resumes, the
        admissions and the step's dispatch half. Returns (completions so
        far, pending ticket) for ``tick_commit``. A fleet calls every
        replica's dispatch before any replica's commit, so every device
        program is queued before the first blocking sync; back to back the
        two halves are exactly the single-engine tick."""
        finished = []
        self.tel.profile_tick(self.programs_run)
        self._drain_swaps()          # step boundary: complete deferred copies
        self._resume_swapped()
        while self.sched.can_admit() and not self.sched.swapped:
            if not self.kv.has_room(int(self.sched.peek().prompt.shape[0])):
                break                # FIFO: wait for memory, don't skip ahead
            if self.chunked:
                self._admit_chunked(now_fn)   # bookkeeping only, no program
            else:
                finished += self._admit(now_fn)
        pend = None
        if self.sched.active:
            pend = (self._chunk_begin(now_fn) if self.chunked
                    else self._step_begin(now_fn))
        return finished, pend

    def tick_commit(self, ticket, now_fn) -> List[Completion]:
        """Commit half of one engine tick: block on the dispatched program,
        harvest, and feed the TTFT tuner."""
        finished, pend = ticket
        finished = list(finished)
        if pend is not None:
            finished += self._step_end(pend, now_fn)
        if self.tuner is not None:
            for c in finished:
                old = self.chunk_budget
                self.chunk_budget = self.tuner.observe(c.ttft_s)
                self.tel.budget_adjust(old, self.chunk_budget,
                                       self.tel.now())
            if self.mesh is not None:
                # the budget follows rank 0's clock on every rank
                self.chunk_budget = self.mesh.agree([self.chunk_budget])[0]
                self.tuner.budget = self.chunk_budget
        return finished

    # -- fleet: prefill/decode disaggregation handoff -----------------------

    def extract_handoffs(self) -> List[tuple]:
        """Take every decode-ready slot out for a fleet prefill→decode
        handoff: its prompt is resident and generated token #1 committed,
        so a decode cell continues the stream where this cell left off.
        The chain rides the swap lane: ``swap_out`` exports it into the
        shared host tier and the decode cell's ``swap_in`` imports it into
        its own pool, so the handed-off stream equals the colocated one.

        A slot whose chain cannot reach the tier (none, or held full)
        stays and decodes here, values unchanged. Returns [(SlotState,
        SwapHandle, next token), ...] in slot order; the next token is a
        copy, since later admissions write ``_next`` in place while the
        handoff may wait in the fleet's queue."""
        out = []
        for slot in sorted(self.sched.active):
            st = self.sched.active[slot]
            if st.prefilling or st.produced < 1:
                continue
            nxt = self._next[slot].clone()
            handle = self.kv.swap_out(slot)
            if handle is None:
                continue             # no host room: decode locally instead
            st = self.sched.release(slot)
            st.pending_drafts = None     # drafts die with the handoff; the
                                         # decode cell proposes anew
            self.handoffs_out += 1
            out.append((st, handle, nxt))
        return out

    def inject_handoff(self, st, handle, next_token) -> bool:
        """Adopt a prefill cell's finished chain: claim a slot, swap the
        chain into this pool and resume decoding from the carried next
        token. False (nothing consumed) when no slot is free or the pool
        cannot hold the chain yet: the fleet retries later."""
        if self.sched.n_free == 0 or not self.kv.can_swap_in(handle):
            return False
        slot = self.sched.adopt(st)
        if not self.kv.swap_in(slot, handle):
            # can_swap_in raced nothing (single-threaded); should it fail,
            # recompute the request here (its sampling chain replays from
            # the request key, so the stream is the same)
            self.kv.drop_swap(handle)
            self.sched.release(slot)
            self.sched.requeue_front(st.req)
            self.preemptions += 1
            now = self.tel.now()
            self.tel.preempt(st.req.rid, slot, "recompute", now)
            self.tel.state(st.req.rid, "queued", now)
            return True                  # consumed (as a requeue)
        self._next[slot] = next_token
        self.handoffs_in += 1
        return True

    def run(self, requests: List[Request], *, load: str = "closed",
            concurrency: Optional[int] = None,
            clock: Callable[[], float] = time.monotonic
            ) -> Tuple[List[Completion], float]:
        """Serve ``requests`` to completion. Returns (completions, wall_s).

        load="open":   requests arrive at their ``arrival_s`` timestamps via
                       an AdmissionWorker co-process, regardless of server
                       speed (open loop — queueing delay shows up in latency).
        load="closed": at most ``concurrency`` requests are outstanding; a
                       completion immediately issues the next (closed loop).
        """
        n = len(requests)
        completions: List[Completion] = []
        t0 = clock()
        rel = lambda: clock() - t0
        self.tel.set_clock(rel)
        if load == "open":
            worker = (AdmissionWorker(requests, clock=clock)
                      if self.mesh is None
                      else MeshArrivals(requests, clock, self.mesh))
            while len(completions) < n:
                for r in worker.poll():
                    self.sched.enqueue(r)
                    self.tel.state(r.rid, "queued", r.arrival_s)
                if (not self.sched.active and not self.sched.can_admit()
                        and not self.sched.swapped and not worker.exhausted):
                    r = worker.wait(timeout=0.05)   # device idle: block
                    if r is not None:
                        self.sched.enqueue(r)
                        self.tel.state(r.rid, "queued", r.arrival_s)
                    continue
                completions += self._admit_and_step(rel)
        elif load == "closed":
            conc = concurrency or self.n_slots
            issued = 0
            outstanding = 0
            while len(completions) < n:
                while outstanding < conc and issued < n:
                    req = dataclasses.replace(requests[issued],
                                              arrival_s=rel())
                    self.sched.enqueue(req)
                    self.tel.state(req.rid, "queued", req.arrival_s)
                    issued += 1
                    outstanding += 1
                done = self._admit_and_step(rel)
                outstanding -= len(done)
                completions += done
        else:
            raise ValueError(f"unknown load mode {load!r}")
        return completions, rel()

    # -- prefix-cache persistence -------------------------------------------

    def save_prefix_cache(self, path: str) -> int:
        """Persist the KV hierarchy's prefix cache (host tier and shared
        device prefixes) so a restarted engine (``warm_start=path``) serves
        the same prompts without prefilling them again. Paged backend
        only."""
        return self.kv.save(path)

    # -- reporting ----------------------------------------------------------

    def utilization(self) -> dict:
        """Engine + backend utilization counters (merged into serve_report)."""
        u = {
            "kv_backend": self.kv.kind,
            "step_mode": "chunked" if self.chunked else "two_phase",
            "programs_run": self.programs_run,
            "tokens_wasted": self.tokens_wasted,
            "preemptions": self.preemptions,
            "preempt_policy": f"{self.preempt.mode}/{self.preempt.victim}",
            "swap_preemptions": self.swap_preemptions,
            "swap_resumes": self.swap_resumes,
            "prefill_tokens": self.prefill_tokens,
            "decode_tokens": self.decode_tokens,
        }
        if self.programs_run:
            u["prefill_tokens_per_step"] = round(
                self.prefill_tokens / self.programs_run, 2)
            u["decode_tokens_per_step"] = round(
                self.decode_tokens / self.programs_run, 2)
        if self.chunked:
            u["chunk_budget"] = self.chunk_budget
            u["chunk_width"] = self.chunk_width
        if self.tuner is not None:
            u["ttft_slo_s"] = self.tuner.slo_s
            u["budget_adjustments"] = self.tuner.adjustments
        if self.handoffs_out or self.handoffs_in:
            u["handoffs_out"] = self.handoffs_out
            u["handoffs_in"] = self.handoffs_in
        if self.proposer is not None:
            u["spec_decode"] = "ngram"
            u["spec_width"] = self.spec_width
            u["spec_steps"] = self.spec_steps
            u["spec_draft_tokens"] = self.spec_draft_tokens
            u["spec_accepted_tokens"] = self.spec_accepted_tokens
            u["spec_wasted_tokens"] = self.spec_wasted_tokens
            if self.spec_draft_tokens:
                u["spec_acceptance_rate"] = round(
                    self.spec_accepted_tokens / self.spec_draft_tokens, 4)
            if self.spec_steps:
                u["spec_tokens_per_step"] = round(
                    self.spec_emitted_tokens / self.spec_steps, 2)
        u.update(self.kv.utilization())
        # on one device the single shard holds the whole store
        u["kv_bytes_per_shard"] = _kv_bytes_per_shard(self.kv.cache)
        if "kv_blocks_hwm" in u:
            # resident high-watermark in bytes (+1: the trash row)
            u["kv_hwm_bytes_per_shard"] = int(
                u["kv_bytes_per_shard"] * u["kv_blocks_hwm"]
                / (u["kv_blocks_total"] + 1))
        if self.mesh is not None:
            u["mesh"] = self.mesh.describe()
        return u

    def reset_counters(self) -> None:
        """Zero the utilization counters (after a warmup run)."""
        self.programs_run = 0
        self.tokens_wasted = 0
        self.preemptions = 0
        self.swap_preemptions = 0
        self.swap_resumes = 0
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.spec_steps = 0
        self.spec_draft_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_wasted_tokens = 0
        self.spec_emitted_tokens = 0
        self.handoffs_out = 0
        self.handoffs_in = 0
        if self.proposer is not None:
            self.proposer.proposed_tokens = 0
            self.proposer.lookups = 0
            self.proposer.hits = 0
        if self.tuner is not None:
            self.tuner.adjustments = 0
        self.kv.reset_counters()
        self.tel.reset()


# ---------------------------------------------------------------------------
# Reporting
# ---------------------------------------------------------------------------

def _kv_bytes_per_shard(cache) -> int:
    """Device bytes this rank holds for the KV store (JAX
    ``engine.py:1064-1071``): under a mesh its heads' and its slots' share,
    on one device the whole store."""
    return int(sum(t.numel() * t.element_size()
                   for g in cache for t in g.values()))


def serve_report(completions: List[Completion], wall_s: float,
                 utilization: Optional[dict] = None) -> dict:
    """Summarize a serve run. Well-defined for every completion count:

    - zero completions (a mid-run snapshot before anything finishes):
      returns the partial report — ``requests``/``total_tokens`` 0, the
      rates 0.0, utilization merged — with every percentile/latency field
      *omitted* (there is no sample to summarize; consumers must treat the
      keys as optional, not read NaNs).
    - small samples: percentiles are ``np.percentile`` over the observed
      completions, so with n < 100 the p99 equals the sample maximum (with
      n == 1, every percentile is that single observation). They are exact
      order statistics of what was measured, not population estimates.
    - ``wall_s == 0`` (frozen or zero-resolution clocks): the throughput
      rates are 0.0 rather than a division error.
    """
    if not completions:
        rep = {
            "requests": 0,
            "wall_s": wall_s,
            "total_tokens": 0,
            "tokens_per_s": 0.0,
            "requests_per_s": 0.0,
        }
        if utilization:
            rep.update(utilization)
        return rep
    lats = np.array([c.latency_s for c in completions])
    ttfts = np.array([c.ttft_s for c in completions])
    queue = np.array([c.queue_wait_s for c in completions])
    pfill = np.array([c.prefill_s for c in completions])
    fdec = np.array([c.first_decode_gap_s for c in completions])
    total_tokens = int(sum(len(c.tokens) for c in completions))
    rep = {
        "requests": len(completions),
        "wall_s": wall_s,
        "total_tokens": total_tokens,
        "tokens_per_s": total_tokens / wall_s if wall_s else 0.0,
        "requests_per_s": len(completions) / wall_s if wall_s else 0.0,
        "mean_latency_s": float(lats.mean()),
        "p50_latency_s": float(np.percentile(lats, 50)),
        "p99_latency_s": float(np.percentile(lats, 99)),
        "p50_ttft_s": float(np.percentile(ttfts, 50)),
        "p99_ttft_s": float(np.percentile(ttfts, 99)),
        # TTFT breakdown: time queued for a slot, time absorbing the prompt
        # (admission -> first token), and the gap to the first decode-phase
        # tokens
        "p50_queue_wait_s": float(np.percentile(queue, 50)),
        "p99_queue_wait_s": float(np.percentile(queue, 99)),
        "p50_prefill_s": float(np.percentile(pfill, 50)),
        "p99_prefill_s": float(np.percentile(pfill, 99)),
        "p50_first_decode_gap_s": float(np.percentile(fdec, 50)),
        # worst inter-token stall across requests: in the two-phase engine
        # this is dominated by blocking admission prefills
        "max_decode_stall_s": float(max(c.max_stall_s for c in completions)),
    }
    if utilization:
        rep.update(utilization)
    return rep
