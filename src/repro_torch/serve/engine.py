"""Continuous-batching serving engine over the UKL linkage spectrum — the
two-phase slotted path of ``src/repro/serve/engine.py``.

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
             slot decode, fused RMSNorm).

The engine is deterministic for a fixed request list: admission is FIFO,
slots are assigned lowest-index-first, eviction happens only at program
boundaries, and decoding is greedy — so each request's tokens are the ones
it would get alone through prefill + decode (tests/test_torch_serve.py).

Outside this slice, and raising ``NotImplementedError`` with their ROADMAP
item: the paged KV backend (item 5), chunked prefill (item 6), speculative
decoding (item 7), swap preemption and the prefix cache (item 8),
quantized KV (item 9), device meshes (item 13) and sampling at
temperature > 0 (item 3).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.coprocess import AdmissionWorker
from repro_torch.core.linkage import L3_NSS, LinkageConfig
from repro_torch.core.step import SamplingConfig, program_label
from repro_torch.serve.cache import KVBackend, SlottedKV
from repro_torch.serve.scheduler import (MIN_BUCKET, Completion, Request,
                                         SlotScheduler, bucket_len)
from repro_torch.serve.telemetry import NULL_TELEMETRY, Telemetry


def _not_in_slice(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP module item {item})")


def check_slice(*, kv: str = "slotted", chunked: bool = False,
                spec_decode: str = "none", mesh=None, kv_dtype: str = "bf16",
                preempt: str = "recompute", prefix_cache=None) -> None:
    """Raise ``NotImplementedError`` for a serving option this port does not
    have yet, naming the ROADMAP item that brings it."""
    if kv != "slotted":
        raise _not_in_slice(f"kv={kv!r} (the paged KV backend)", "5")
    if chunked:
        raise _not_in_slice("chunked prefill", "6")
    if spec_decode != "none":
        raise _not_in_slice(f"spec_decode={spec_decode!r}", "7")
    if preempt != "recompute":
        raise _not_in_slice(f"preempt={preempt!r} (the host tier)", "8")
    if prefix_cache:
        raise _not_in_slice("the persistent prefix cache", "8")
    if kv_dtype != "bf16":
        raise _not_in_slice(f"kv_dtype={kv_dtype!r} (quantized KV)", "9")
    if mesh:
        raise _not_in_slice("mesh serving", "13")


def _host(t) -> np.ndarray:
    """A token tensor (or numpy array) as a host numpy array."""
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class ServeEngine:
    """Request-level continuous batching over a fixed slot pool, two-phase:
    admission runs a blocking full-prompt prefill, then occupied slots
    decode together."""

    #: smallest admission bucket (owned by the scheduler)
    MIN_BUCKET = MIN_BUCKET

    def __init__(self, cfg: ArchConfig, params, opts, linkage: LinkageConfig,
                 n_slots: int, max_len: int, *, kv: str = "slotted",
                 sampling: Optional[SamplingConfig] = None,
                 bucket_prompts: bool = False,
                 telemetry: Optional[Telemetry] = None):
        check_slice(kv=kv)
        linkage.validate()
        if n_slots < 1:
            raise ValueError("serving engine needs n_slots >= 1")
        self.cfg = cfg
        self.params = params
        self.opts = opts
        self.linkage = linkage
        self.n_slots = n_slots
        self.max_len = max_len
        self.sampling = (sampling or SamplingConfig()).validate()
        self.tokens_per_program = (linkage.decode_steps
                                   if linkage.level == L3_NSS else 1)
        bucket_fn = self._bucket if bucket_prompts else None
        self.kv: KVBackend = SlottedKV(cfg, params, opts, linkage, n_slots,
                                       max_len, self.sampling, bucket_fn)
        # NULL_TELEMETRY is the zero-cost disabled bundle (every hook a
        # no-op, now() never reads a clock)
        self.tel = telemetry if telemetry is not None else NULL_TELEMETRY
        self.kv.tel = self.tel
        self._labels = {k: program_label(cfg, linkage, k)
                        for k in ("decode", "prefill_admit")}
        self._next = torch.zeros((n_slots,), dtype=torch.int32,
                                 device=params["embed"].device)
        self.sched = SlotScheduler(n_slots)
        self.programs_run = 0
        self.tokens_wasted = 0       # decoded past a request's budget/EOS
        self.prefill_tokens = 0      # prompt tokens admitted
        self.decode_tokens = 0       # decode tokens produced

    def _bucket(self, n: int) -> int:
        """Power-of-two admission bucket (``scheduler.bucket_len``)."""
        return bucket_len(n, self.max_len)

    # -- admission ----------------------------------------------------------

    def _admit(self, now_fn: Callable[[], float]) -> List[Completion]:
        tel = self.tel
        adm = now_fn()
        slot, req = self.sched.admit_next(adm)
        if not self.kv.fits(int(req.prompt.shape[0]), req.max_new_tokens):
            self.sched.release(slot)
            raise ValueError(
                f"request {req.rid}: prompt+budget exceeds max_len "
                f"{self.max_len}")
        tel.admit(req.rid, slot, int(req.prompt.shape[0]), adm)
        t0 = tel.now()
        first = self.kv.admit(slot, np.asarray(req.prompt, np.int32))
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
        st.produced = 1
        tel.state(req.rid, "decoding", st.first_token_s)
        tel.step("prefill_admit", self.programs_run, t0, 0.0, t1 - t0,
                 t2 - t1, tel.now() - t2, queued=self.sched.n_queued,
                 active=len(self.sched.active),
                 program=self._labels["prefill_admit"])
        if st.remaining == 0 or st.eos_seen:
            return [self._finalize(slot, now_fn)]
        return []

    # -- decode -------------------------------------------------------------

    def step(self, now_fn: Callable[[], float]) -> List[Completion]:
        """Run one decode program; harvest tokens; evict finished slots.
        Split at the blocking host sync (``_step_begin``/``_step_end``), as
        in the JAX engine, whose fleet runtime dispatches every replica
        before committing any."""
        return self._step_end(self._step_begin(now_fn), now_fn)

    def _step_begin(self, now_fn: Callable[[], float]):
        """Dispatch half: launch the decode program, everything up to
        (excluding) the blocking host copy."""
        tel = self.tel
        t0 = tel.now()
        toks = self.kv.decode(self._next)
        # a copy: later admissions write _next in place, and toks' rows
        # stay referenced by the slots' RET chunks
        self._next = toks[:, -1].clone()
        self.programs_run += 1
        t2 = tel.now()
        return toks, t0, t2

    def _step_end(self, pending, now_fn: Callable[[], float]
                  ) -> List[Completion]:
        """Commit half: block on the device result (iret), harvest tokens,
        evict finished slots, stamp the step trace event."""
        tel = self.tel
        toks, t0, t2 = pending
        toks_host = None
        if not self.linkage.ret_async:
            toks_host = _host(toks)                 # "iret": sync every program
        t3 = tel.now()
        slots = sorted(self.sched.active)
        tel.decode_microsteps(len(slots), self.tokens_per_program, t0)
        finished = self._harvest_decode(slots, toks, toks_host, now_fn)
        tel.step("decode", self.programs_run, t0, 0.0, t2 - t0, t3 - t2,
                 tel.now() - t3, queued=self.sched.n_queued,
                 active=len(self.sched.active),
                 program=self._labels["decode"])
        return finished

    def _harvest_decode(self, slots, toks, toks_host,
                        now_fn: Callable[[], float]) -> List[Completion]:
        """Collect this program's decode tokens for ``slots``: append (up to
        the request budget), check EOS at the sync point, finalize finished."""
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

    def _finalize(self, slot: int,
                  now_fn: Callable[[], float]) -> Completion:
        st = self.sched.release(slot)
        self.kv.release(slot)
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
        """One engine tick: FIFO admissions into free slots, then one decode
        program over the occupied ones."""
        finished = []
        self.tel.profile_tick(self.programs_run)
        while self.sched.can_admit():
            if not self.kv.has_room(int(self.sched.peek().prompt.shape[0])):
                break                # FIFO: wait for memory, don't skip ahead
            finished += self._admit(now_fn)
        if self.sched.active:
            finished += self.step(now_fn)
        return finished

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
            worker = AdmissionWorker(requests, clock=clock)
            while len(completions) < n:
                for r in worker.poll():
                    self.sched.enqueue(r)
                    self.tel.state(r.rid, "queued", r.arrival_s)
                if (not self.sched.active and not self.sched.can_admit()
                        and not worker.exhausted):
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

    # -- reporting ----------------------------------------------------------

    def utilization(self) -> dict:
        """Engine + backend utilization counters (merged into serve_report)."""
        u = {
            "kv_backend": self.kv.kind,
            "step_mode": "two_phase",
            "programs_run": self.programs_run,
            "tokens_wasted": self.tokens_wasted,
            "preemptions": 0,
            "preempt_policy": "recompute/youngest",
            "swap_preemptions": 0,
            "swap_resumes": 0,
            "prefill_tokens": self.prefill_tokens,
            "decode_tokens": self.decode_tokens,
        }
        if self.programs_run:
            u["prefill_tokens_per_step"] = round(
                self.prefill_tokens / self.programs_run, 2)
            u["decode_tokens_per_step"] = round(
                self.decode_tokens / self.programs_run, 2)
        u.update(self.kv.utilization())
        u["kv_bytes_per_shard"] = _kv_bytes(self.kv.cache)
        return u

    def reset_counters(self) -> None:
        """Zero the utilization counters (after a warmup run)."""
        self.programs_run = 0
        self.tokens_wasted = 0
        self.prefill_tokens = 0
        self.decode_tokens = 0
        self.kv.reset_counters()
        self.tel.reset()


# ---------------------------------------------------------------------------
# Reporting
# ---------------------------------------------------------------------------

def _kv_bytes(cache) -> int:
    """Device bytes of the KV store (one device holds the whole store)."""
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
