"""Slotted KV cache: the serving engine's resident device memory
(``src/repro/serve/cache.py``).

The engine owns one persistent cache with ``n_slots`` batch rows ("slots").
A slot holds one in-flight sequence; finished sequences are evicted and the
freed row is overwritten by the next admitted prompt's prefill — the device
state never reallocates between requests (the UKL "pinned" discipline).
Writes are in place: the PyTorch counterpart of the JAX slot writer's
donated ``dynamic_update_slice``.

Layout (one dict per layer) vs the uniform decode cache of
``repro_torch.models.transformer``:

  uniform (all rows at one position)      slot layout (per-row positions)
  -----------------------------------    --------------------------------
  slot_pos : (T,)                         slot_pos : (B, T)
  pos      : ()                           pos      : (B,)

Every other leaf already carries batch at axis 0 (K/V, a Mamba layer's conv
and scan states or an RWKV layer's state and shifts, which have no
``slot_pos``), so once ``slot_pos`` and ``pos`` gain a batch axis,
admission is one row write per leaf (``write_slot``): it overwrites every
recurrent state of the row, so nothing of an evicted request reaches the
next one.
"""
from __future__ import annotations

from typing import Any, Protocol

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.step import (build_prefill_fn, build_serve_step,
                                   build_slot_decode_step, build_verify_step,
                                   make_sampler)
from repro_torch.models.transformer import Cache, init_cache
from repro_torch.serve.telemetry import NULL_TELEMETRY


def slotify(cache: Cache) -> Cache:
    """Uniform-layout cache (any batch) -> slot layout.

    ``slot_pos`` (T,) and ``pos`` () are shared across the batch in the
    uniform layout (prefill runs all rows in lockstep), so broadcasting them
    over the batch axis is exact. The batch is read off the first other
    leaf, and a layer without ``slot_pos`` (Mamba, RWKV) gains only the
    per-row ``pos`` (JAX ``cache.py:44``). The result owns its storage (the engine
    writes into it in place).
    """
    out = []
    for g in cache:
        B = next(v for k, v in g.items()
                 if k not in ("slot_pos", "pos")).shape[0]
        g = dict(g)
        g["pos"] = g["pos"].expand(B).clone()
        if "slot_pos" in g:
            g["slot_pos"] = g["slot_pos"][None].expand(B, -1).clone()
        out.append(g)
    return out


def init_slot_cache(cfg: ArchConfig, n_slots: int, max_len: int,
                    dtype=torch.bfloat16, device="cuda") -> Cache:
    """Fresh slot-layout cache: all slots empty (slot_pos == -1, pos == 0).
    On ``cuda`` unless the caller asks for the CPU; ``cuda`` without a GPU
    raises (``init_cache``)."""
    base = slotify(init_cache(cfg, n_slots, max_len, dtype, device))
    # init_cache leaves pos at the int32 fill value; empty slots decode from
    # position 0 (their garbage output is ignored until admission).
    for g in base:
        g["pos"].zero_()
    return base


def write_slot(dst: Cache, src: Cache, slot: int) -> None:
    """Write a freshly prefilled single-sequence cache (slot layout, batch
    1) into row ``slot`` of the engine cache, in place — no reallocation per
    admission (the JAX ``make_slot_writer``)."""
    for d, s in zip(dst, src):
        for name, leaf in d.items():
            leaf[slot].copy_(s[name][0])


class KVBackend(Protocol):
    """What ``ServeEngine`` needs from a KV-memory subsystem.

    ``SlottedKV`` (dense: one ``max_len`` row per slot) and
    ``repro_torch.serve.paging.PagedKV`` (demand-allocated blocks) implement
    it. Each holds ``keys`` (n_slots, 2), every slot's sampling-key chain,
    on the device.
    """
    kind: str
    #: telemetry hook bundle (``repro_torch.serve.telemetry.Telemetry``);
    #: the engine installs its own on construction
    tel: Any
    #: the resident cache (KV bytes are read off it for reports)
    cache: Cache

    def admit(self, slot: int, prompt: np.ndarray, key=None) -> torch.Tensor:
        """Prefill ``prompt`` into ``slot`` and seed its sampling chain from
        ``key`` (None keeps the row's key: greedy reads none). Returns the
        first generated token, shape (1,), on the device."""
        ...

    def decode(self, next_tokens: torch.Tensor) -> torch.Tensor:
        """Run one decode program over all slots; returns tokens (B, K)."""
        ...

    def reserve(self, slot: int, k: int) -> bool:
        """Make room for the slot's next ``k`` writes. False = out of
        memory: the engine preempts a slot and retries."""
        ...

    def admit_chunked(self, slot: int, prompt: np.ndarray, key=None) -> int:
        """Begin a chunked admission (no program runs) and seed the slot's
        sampling chain; returns the prompt tokens already resident (a
        shared prefix; 0 on slot rows)."""
        ...

    def append_chunk(self, slot: int, start: int, tokens: np.ndarray) -> bool:
        """Make room for the chunk [start, start+len). False = out of
        memory: the engine preempts a slot and replans."""
        ...

    def serve_step(self, chunk_tokens, clen, start, reset, emit0, dec_mask,
                   dec_tok):
        """Run one unified serve program; returns (first tokens (B,),
        decode tokens (B, K))."""
        ...

    def verify_step(self, tokens, clen, start, vmask) -> tuple:
        """Run the verify program over the slots: each vmask row feeds its
        committed next token plus its drafts at its own position. Returns
        (out (B, W), n_emit (B,)) on the device."""
        ...

    def rollback(self, slot: int, new_len: int) -> None:
        """Commit a verify outcome: the slot's sequence is ``new_len``
        tokens long again (the program repaired the device state)."""
        ...

    def fits(self, prompt_len: int, max_new: int) -> bool:
        """Could this request ever run alone? (Hard reject when False.)"""
        ...

    def has_room(self, prompt_len: int) -> bool:
        """Admission gate: is there memory for this prompt *now*?"""
        ...

    def release(self, slot: int) -> None:
        """Free the slot's memory."""
        ...

    def utilization(self) -> dict:
        """Backend-specific utilization counters for ``serve_report``."""
        ...

    def reset_counters(self) -> None:
        """Zero utilization counters (after a warmup run)."""
        ...


def tensor(a, device) -> torch.Tensor:
    """A host array as a tensor on ``device`` (the serving programs'
    host-built operands: chunk tokens, lengths, masks, block tables)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


class SlottedKV:
    """Dense slot-row backend behind the KVBackend API (``cache.py:233``).
    The cache and the key chains live on the parameters' device."""

    kind = "slotted"
    tel = NULL_TELEMETRY

    def __init__(self, cfg: ArchConfig, params, opts, linkage, n_slots: int,
                 max_len: int, sampling=None, bucket_fn=None,
                 chunked: bool = False, spec: bool = False):
        self.cfg, self.params, self.opts = cfg, params, opts
        self.n_slots, self.max_len = n_slots, max_len
        self.device = params["embed"].device
        self.cache = init_slot_cache(cfg, n_slots, max_len, opts.dtype,
                                     self.device)
        # the decode program serves both step disciplines: two-phase
        # decode, and the chunked engine's pure-decode steps
        self._dec = build_slot_decode_step(cfg, opts, linkage, sampling)
        if chunked:
            # the unified serve program replaces the admission prefill
            self._serve = build_serve_step(cfg, opts, linkage, max_len,
                                           sampling, kv_kind="slotted")
        else:
            self._prefill = build_prefill_fn(cfg, opts, max_len,
                                             bucket_fn=bucket_fn)
            self._sample = make_sampler(sampling)
        if spec:
            self._verify = build_verify_step(cfg, opts, linkage, max_len,
                                             sampling, kv_kind="slotted")
        self.keys = torch.zeros((n_slots, 2), dtype=torch.int64,
                                device=self.device)

    def _seed(self, slot: int, key) -> None:
        if key is not None:
            self.keys[slot] = key

    def admit(self, slot: int, prompt: np.ndarray, key=None) -> torch.Tensor:
        logits, c1 = self._prefill(self.params, prompt)
        write_slot(self.cache, slotify(c1), slot)
        self._seed(slot, key)
        first, krow = self._sample(logits, self.keys[slot:slot + 1])
        self.keys[slot] = krow[0]
        return first

    def decode(self, next_tokens: torch.Tensor) -> torch.Tensor:
        self.cache, toks, self.keys = self._dec(self.params, self.cache,
                                                next_tokens, self.keys)
        return toks

    def reserve(self, slot: int, k: int) -> bool:
        return True                     # the slot's row is always there

    def fits(self, prompt_len: int, max_new: int) -> bool:
        return prompt_len + max_new <= self.max_len

    def has_room(self, prompt_len: int) -> bool:
        return True                     # a free slot is the only resource

    def release(self, slot: int) -> None:
        pass                            # the row is overwritten on admission

    def utilization(self) -> dict:
        return {}

    def reset_counters(self) -> None:
        pass

    # -- chunked prefill ----------------------------------------------------

    def admit_chunked(self, slot: int, prompt: np.ndarray, key=None) -> int:
        """Seed the slot's sampling chain; nothing is resident yet (a dense
        row shares no prefix). The serve program's sampler splits the
        request key as the two-phase admission's does, so key chains replay
        bit for bit across step disciplines."""
        self._seed(slot, key)
        return 0

    def append_chunk(self, slot: int, start: int, tokens: np.ndarray) -> bool:
        return True                     # a slot row always holds max_len

    def serve_step(self, chunk_tokens, clen, start, reset, emit0, dec_mask,
                   dec_tok):
        d = self.device
        self.cache, t0, seq, self.keys = self._serve(
            self.params, self.cache, tensor(chunk_tokens, d),
            tensor(clen, d), tensor(start, d), tensor(reset, d),
            tensor(emit0, d), dec_tok, tensor(dec_mask, d), self.keys)
        return t0, seq

    # -- speculative decode -------------------------------------------------

    def verify_step(self, tokens, clen, start, vmask):
        d = self.device
        self.cache, out, n_emit, self.keys = self._verify(
            self.params, self.cache, tensor(tokens, d), tensor(clen, d),
            tensor(start, d), tensor(vmask, d), self.keys)
        return out, n_emit

    def rollback(self, slot: int, new_len: int) -> None:
        pass    # the verify program repaired slot_pos and pos; a dense row
                # has no host-side residency to truncate
