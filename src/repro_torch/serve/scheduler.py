"""Request/slot scheduling for the continuous-batching engine.

``src/repro/serve/scheduler.py``, copied (numpy only): the port imports
nothing of the JAX package, and a fixed seed must give the same requests,
the same schedule and the same drafts in both. Recompute and swap
preemption (the swap-suspended queue), the chunk packer, the TTFT budget
tuner (``BudgetTuner``), the n-gram drafter (``DraftProposer``) and the
fleet's handoff entry (``SlotScheduler.adopt``) are here.

Deterministic by construction: admission is FIFO over arrival order (ties
broken by request id) and free slots are handed out lowest-index-first, so a
fixed request list plus a fixed seed replays the exact same schedule — the
property the token-identity tests rely on.
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np


#: smallest admission bucket — prompts shorter than this share one compiled
#: prefill instead of one program per tiny length. Lives here (not on the
#: engine) so every admission path — two-phase prefill and chunked — goes
#: through the same guard and the zero-``true_len`` padding-read bug fixed
#: earlier cannot be resurrected by a new caller.
MIN_BUCKET = 8


@dataclasses.dataclass(frozen=True)
class PreemptionPolicy:
    """What the engine does when the paged pool runs dry mid-flight.

    ``mode``:
      recompute  release the victim's blocks and requeue its request at the
                 head of the line — re-admission replays the stream from
                 scratch (prefill included).
      swap       park the victim's blocks in the host tier and resume without
                 re-prefill (``PagedKV.swap_out`` / ``swap_in``); a failed
                 swap (no host tier, or the tier pinned full) falls back to
                 recompute.

    ``victim`` names the ``SlotScheduler.choose_victim`` policy — victim
    selection is the scheduler's call, not the memory subsystem's.
    """
    mode: str = "recompute"
    victim: str = "youngest"

    MODES = ("recompute", "swap")
    VICTIMS = ("youngest", "lru")

    def validate(self) -> "PreemptionPolicy":
        if self.mode not in self.MODES:
            raise ValueError(f"unknown preemption mode {self.mode!r}; "
                             f"known: {self.MODES}")
        if self.victim not in self.VICTIMS:
            raise ValueError(f"unknown victim policy {self.victim!r}; "
                             f"known: {self.VICTIMS}")
        return self

    @classmethod
    def parse(cls, spec) -> "PreemptionPolicy":
        """A PreemptionPolicy, or a bare mode string ("recompute"|"swap")."""
        if isinstance(spec, cls):
            return spec.validate()
        return cls(mode=str(spec)).validate()


@dataclasses.dataclass
class BudgetTuner:
    """AIMD controller tying the chunked engine's token budget to a TTFT
    SLO (``--ttft-slo``), fed one observation per completion.

    A completion's TTFT over the SLO → additive-increase the budget (absorb
    prompts in fewer, bigger steps); TTFT comfortably inside the SLO
    (< ``margin`` · slo) → multiplicative-decrease toward the floor
    (smaller steps bound every other slot's decode stall). In between:
    hold. The budget is a host-side knob — no rebuild; the chunk width W
    caps any single grant regardless.
    """
    slo_s: float
    budget: int
    floor: int = 1
    cap: int = 1 << 16
    add: int = 16
    mult: float = 0.75
    margin: float = 0.5
    adjustments: int = 0

    def observe(self, ttft_s: float) -> int:
        prev = self.budget
        if ttft_s > self.slo_s:
            self.budget = min(self.cap, self.budget + self.add)
        elif ttft_s < self.margin * self.slo_s:
            self.budget = max(self.floor, int(self.budget * self.mult))
        if self.budget != prev:
            self.adjustments += 1
        return self.budget


def bucket_len(n: int, max_len: int) -> int:
    """Power-of-two prompt bucket, floored at MIN_BUCKET and clipped to
    ``max_len``: bounds the jit prefill cache under mixed-length load. The
    floor keeps 1..7-token prompts from each minting their own compiled
    program; ``true_len`` fixes up positions/logits so the padding is exact.
    Empty prompts are rejected loudly — a ``true_len`` of 0 would silently
    read position 0 of pure padding."""
    if n < 1:
        raise ValueError("cannot bucket an empty prompt (true_len == 0 "
                         "would read logits from pure padding)")
    return min(max(1 << max(n - 1, 0).bit_length(), MIN_BUCKET), max_len)


def pack_chunks(budget: int, width: int, decode_tokens: int,
                remaining: Sequence[int]) -> List[int]:
    """Token-budget packer for the unified (chunked-prefill) serve step.

    One engine step runs one program with a fixed token budget. Decode
    tokens are mandatory — occupied decode slots always advance, so decode
    never stalls behind admission — and whatever budget is left is handed
    to mid-prefill slots as prompt chunks, FIFO by admission order.

    budget:        target tokens per step (the --budget knob).
    width:         compiled per-row chunk width W (a grant never exceeds it).
    decode_tokens: tokens the decode scan will consume this step.
    remaining:     per mid-prefill slot, prompt tokens still to prefill,
                   in FIFO admission order.

    Returns per-slot grants (same order): ``sum(grants) <= max(budget -
    decode_tokens, 0)``, FIFO-greedy, ``0 <= grants[i] <= min(width,
    remaining[i])``, and the head slot gets a token whenever budget is left.
    """
    if budget < 1:
        raise ValueError("pack_chunks needs budget >= 1")
    if width < 1:
        raise ValueError("pack_chunks needs width >= 1")
    left = max(budget - decode_tokens, 0)
    grants = []
    for rem in remaining:
        if rem < 0:
            raise ValueError("negative remaining prompt length")
        g = min(width, rem, left)
        grants.append(g)
        left -= g
    return grants


class DraftProposer:
    """Scheduler-side self-speculation: n-gram prompt-lookup drafts.

    No second model — drafts come from the slot's own resident tokens
    (prompt + produced history, which ends with the committed next token
    the engine is about to feed). The proposer finds the most recent
    earlier occurrence of the history's trailing n-gram and proposes the
    tokens that followed it, longest-n first. Greedy verify makes wrong
    drafts harmless (bit-identity holds regardless of what is proposed),
    so the proposer is pure policy: hit rate decides throughput, never
    correctness.

    Draft length is clamped to ``min(width - 1, remaining - 1)`` so a row's
    emissions (1 + accepted ≤ 1 + drafts) can never overshoot its
    ``max_new_tokens`` budget or write past ``max_len``. A draft list is
    truncated just *after* a proposed EOS (keeping it — the engine detects
    EOS inside an accepted window at harvest, like mid-chunk EOS in plain
    decode). ``width == 1`` therefore always proposes nothing: the engine
    falls back to the plain decode program (speculation disabled ==
    plain decode, the width-1 identity edge).
    """

    _EMPTY = np.zeros((0,), np.int32)

    def __init__(self, width: int, ngram: int = 3,
                 eos_id: Optional[int] = None):
        if width < 1:
            raise ValueError(f"spec width must be >= 1, got {width}")
        if ngram < 1:
            raise ValueError(f"ngram order must be >= 1, got {ngram}")
        self.width = width
        self.ngram = ngram
        self.eos_id = eos_id
        self.proposed_tokens = 0     # drafts handed to the engine
        self.lookups = 0             # propose() calls with room to draft
        self.hits = 0                # ... that found a non-empty draft

    def history(self, st: "SlotState") -> np.ndarray:
        """The slot's resident tokens: prompt then produced chunks (whose
        last element is the committed next token the engine feeds first).
        A chunk still on the device (RET) is copied to the host here."""
        parts = [np.asarray(st.req.prompt, np.int32).ravel()]
        parts += [np.asarray(c.cpu() if hasattr(c, "cpu") else c,
                             np.int32).ravel() for c in st.chunks]
        return np.concatenate(parts)

    def propose(self, st: "SlotState") -> np.ndarray:
        """Drafts for one decode-phase slot: (m,) int32, m in [0, width-1].

        The verify row will feed ``[next_token, drafts...]`` — position j's
        draft predicts the model's output after absorbing draft j-1."""
        max_d = min(self.width - 1, st.remaining - 1)
        if max_d <= 0 or st.eos_seen:
            return self._EMPTY
        self.lookups += 1
        hist = self.history(st)
        L = int(hist.shape[0])
        for n in range(min(self.ngram, L - 1), 0, -1):
            tail = hist[L - n:]
            win = np.lib.stride_tricks.sliding_window_view(hist, n)
            cands = np.flatnonzero((win == tail).all(axis=1))
            cands = cands[cands < L - n]   # real continuation, not the tail
            if not cands.size:
                continue
            i = int(cands[-1])             # most recent earlier occurrence
            d = hist[i + n: i + n + max_d].astype(np.int32)
            eos = self.eos_id if self.eos_id is not None else st.req.eos_id
            if eos is not None:
                stop = np.flatnonzero(d == eos)
                if stop.size:
                    d = d[:int(stop[0]) + 1]    # keep the proposed EOS
            if d.size:
                self.hits += 1
                self.proposed_tokens += int(d.size)
            return d
        return self._EMPTY


@dataclasses.dataclass
class Request:
    """One serving request: a prompt and a generation budget.

    ``eos_id``: optional stop token — generation finalizes early when it
    appears at a host sync point (every program in iret mode; at request
    completion under RET, where only the output is trimmed — see
    docs/serving.md for the RET caveat).
    """
    rid: int
    prompt: np.ndarray               # (P,) int32 token ids
    max_new_tokens: int
    arrival_s: float = 0.0           # offset from run start (open-loop load)
    eos_id: Optional[int] = None


@dataclasses.dataclass
class SlotState:
    """Host-side bookkeeping for one occupied cache slot."""
    req: Request
    admit_s: float
    admit_seq: int = 0               # monotonic admission order (preemption
                                     # evicts the youngest = max admit_seq)
    produced: int = 0                # generated tokens so far (incl. prefill's)
    eos_seen: bool = False           # EOS observed at a host sync point
    first_token_s: Optional[float] = None
    chunks: List[np.ndarray] = dataclasses.field(default_factory=list)
    # chunked prefill (unified serve step): prompt tokens already resident —
    # radix-shared prefix at admission, then += each granted chunk. A slot
    # is in *decode phase* once prefill_pos reaches the prompt length.
    prefill_pos: int = 0
    fresh: bool = True               # no chunk written yet: the first chunk
                                     # must reset the slot's stale cache marks
    prefill_done_s: Optional[float] = None   # last prompt chunk absorbed
    first_decode_s: Optional[float] = None   # first decode-phase tokens
    last_emit_s: Optional[float] = None      # last time this slot emitted
    max_stall_s: float = 0.0                 # worst inter-emission gap — in
                                             # two-phase mode this exposes
                                             # decode stalls behind blocking
                                             # admission prefills
    # speculative decode: drafts proposed for this step's verify row (None
    # outside a spec step; an empty array = no draft, a width-1 row)
    pending_drafts: Optional[np.ndarray] = None

    def note_emit(self, now: float) -> None:
        if self.last_emit_s is not None:
            self.max_stall_s = max(self.max_stall_s, now - self.last_emit_s)
        self.last_emit_s = now

    @property
    def remaining(self) -> int:
        return self.req.max_new_tokens - self.produced

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.req.prompt).shape[0])

    @property
    def prefilling(self) -> bool:
        return self.prefill_pos < self.prompt_len


@dataclasses.dataclass
class Completion:
    """A finished request with its timeline.

    The TTFT breakdown (``serve_report``): ``queue_wait_s`` (arrival ->
    admission), ``prefill_s`` (admission -> last prompt chunk absorbed =
    first token), and ``first_decode_gap_s`` (first token -> first
    decode-phase tokens). Under chunked prefill the prefill component is
    what the budget knob trades against decode throughput."""
    rid: int
    prompt_len: int
    tokens: np.ndarray               # (max_new_tokens,) generated ids
    arrival_s: float
    admit_s: float
    first_token_s: float
    done_s: float
    prefill_done_s: float = 0.0
    first_decode_s: float = 0.0
    max_stall_s: float = 0.0         # worst gap between consecutive token
                                     # emissions (inter-token stall)

    @property
    def latency_s(self) -> float:
        return self.done_s - self.arrival_s

    @property
    def ttft_s(self) -> float:
        return self.first_token_s - self.arrival_s

    @property
    def queue_wait_s(self) -> float:
        return self.admit_s - self.arrival_s

    @property
    def prefill_s(self) -> float:
        return self.prefill_done_s - self.admit_s

    @property
    def first_decode_gap_s(self) -> float:
        return self.first_decode_s - self.prefill_done_s


class SlotScheduler:
    """FIFO admission queue over a fixed pool of cache slots."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self._free: List[int] = list(range(n_slots))
        heapq.heapify(self._free)
        self._queue: Deque[Request] = deque()
        self.active: Dict[int, SlotState] = {}
        self._admit_seq = 0
        #: swap-preempted slot states waiting to resume (oldest first) —
        #: ahead of the request queue in the FIFO line, exactly like
        #: ``requeue_front`` puts recompute victims ahead of it
        self.swapped: Deque[Tuple[SlotState, Any]] = deque()

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_queued(self) -> int:
        return len(self._queue)

    def enqueue(self, req: Request) -> None:
        if req.max_new_tokens < 1:
            raise ValueError(
                f"request {req.rid}: max_new_tokens must be >= 1 (the "
                "prefill itself yields the first generated token)")
        if int(np.asarray(req.prompt).shape[0]) < 1:
            raise ValueError(
                f"request {req.rid}: prompt must be non-empty (a bucketed "
                "prefill with true_len == 0 would silently read logits from "
                "pure padding)")
        self._queue.append(req)

    def requeue_front(self, req: Request) -> None:
        """Put a preempted request back at the head of the queue (it keeps
        its original arrival; re-admission replays its stream exactly)."""
        self._queue.appendleft(req)

    def peek(self) -> Optional[Request]:
        """The request the next admit would take, without taking it."""
        return self._queue[0] if self._queue else None

    def can_admit(self) -> bool:
        return bool(self._queue) and bool(self._free)

    def admit_next(self, now: float) -> tuple:
        """Pop the oldest queued request into the lowest free slot."""
        req = self._queue.popleft()
        slot = heapq.heappop(self._free)
        self._admit_seq += 1
        self.active[slot] = SlotState(req=req, admit_s=now,
                                      admit_seq=self._admit_seq)
        return slot, req

    def release(self, slot: int) -> SlotState:
        st = self.active.pop(slot)
        heapq.heappush(self._free, slot)
        return st

    def choose_victim(self, policy: str = "youngest") -> int:
        """Pick the preemption victim among active slots.

        youngest  max ``admit_seq`` — the last admission loses (the default:
                  it has the least sunk work and the head of the line keeps
                  progressing).
        lru       the slot that least recently emitted a token (a slot that
                  never emitted counts as its admission time); ties go to
                  the youngest.
        """
        if policy == "youngest":
            return max(self.active, key=lambda s: self.active[s].admit_seq)
        if policy == "lru":
            def staleness(s):
                st = self.active[s]
                last = (st.last_emit_s if st.last_emit_s is not None
                        else st.admit_s)
                return (last, -st.admit_seq)
            return min(self.active, key=staleness)
        raise ValueError(f"unknown victim policy {policy!r}; known: "
                         f"{PreemptionPolicy.VICTIMS}")

    # -- swap-preemption (suspended slot states) ----------------------------

    def suspend_front(self, st: SlotState, handle: Any) -> None:
        """Park a swap-preempted slot state ahead of the request queue in
        the FIFO line (the swap analogue of ``requeue_front``). The parked
        state keeps its original ``admit_seq``; resume order is decided by
        it (``resume_next``), not by parking order — preemption order is
        victim-policy-dependent (youngest-first, lru, ...) and only
        youngest-first happens to unwind back to admission order."""
        self.swapped.appendleft((st, handle))

    def _resume_index(self) -> int:
        """Index of the suspended state with the smallest original
        ``admit_seq`` — the one ``peek_swapped`` and ``resume_next`` agree
        on (FIFO by admission, whatever victim policy chose the
        preemption order)."""
        return min(range(len(self.swapped)),
                   key=lambda i: self.swapped[i][0].admit_seq)

    def peek_swapped(self) -> Optional[Tuple[SlotState, Any]]:
        """The suspended state the next ``resume_next`` would pop."""
        return self.swapped[self._resume_index()] if self.swapped else None

    def can_resume(self) -> bool:
        return bool(self.swapped) and bool(self._free)

    def resume_next(self) -> tuple:
        """Pop the suspended state with the oldest *original* admission
        into the lowest free slot. The resumed slot takes a fresh
        ``admit_seq`` — it is the youngest again, exactly like a recompute
        victim re-admitted from the queue head."""
        i = self._resume_index()
        st, handle = self.swapped[i]
        del self.swapped[i]
        slot = heapq.heappop(self._free)
        self._admit_seq += 1
        st.admit_seq = self._admit_seq
        self.active[slot] = st
        return slot, st, handle

    def adopt(self, st: SlotState) -> int:
        """Install a slot state arriving from *outside* this scheduler — a
        fleet prefill→decode handoff: the state (its produced tokens,
        chunks and timing marks) continues here in the lowest free slot
        under a fresh ``admit_seq``, exactly like a resumed swap victim.
        The caller guarantees ``n_free > 0``."""
        slot = heapq.heappop(self._free)
        self._admit_seq += 1
        st.admit_seq = self._admit_seq
        self.active[slot] = st
        return slot


# ---------------------------------------------------------------------------
# Synthetic load generation
# ---------------------------------------------------------------------------

def synthetic_requests(n: int, prompt_len: int, max_new_tokens: int,
                       vocab_size: int, seed: int = 0,
                       rate: Optional[float] = None,
                       prompt_lens: Optional[Sequence[int]] = None,
                       shared_prefix_len: int = 0,
                       eos_id: Optional[int] = None) -> List[Request]:
    """n random-token requests; with ``rate`` (req/s), Poisson arrival times
    (open-loop load — arrivals don't wait for the server), else all at t=0.

    ``prompt_lens``: bucket sizes to cycle through (mixed-length load for the
    engine's power-of-two admission bucketing); overrides ``prompt_len``.
    ``shared_prefix_len``: every prompt starts with the same token prefix (a
    "system prompt") — the paged backend's radix index prefills it once and
    CoW-shares its blocks.
    """
    rng = np.random.default_rng(seed)
    lens = ([int(prompt_lens[i % len(prompt_lens)]) for i in range(n)]
            if prompt_lens else [prompt_len] * n)
    if shared_prefix_len > 0:
        if any(l <= shared_prefix_len for l in lens):
            raise ValueError("shared_prefix_len must be < every prompt len")
        prefix = rng.integers(0, vocab_size, size=shared_prefix_len,
                              dtype=np.int32)
    prompts = []
    for l in lens:
        p = rng.integers(0, vocab_size, size=l, dtype=np.int32)
        if shared_prefix_len > 0:
            p[:shared_prefix_len] = prefix
        prompts.append(p)
    arrivals = np.zeros(n)
    if rate is not None and rate > 0:
        arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n))
    return [Request(rid=i, prompt=prompts[i], max_new_tokens=max_new_tokens,
                    arrival_s=float(arrivals[i]), eos_id=eos_id)
            for i in range(n)]
