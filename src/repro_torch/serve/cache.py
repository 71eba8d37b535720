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

Under a serving mesh (``shard``, a ``repro_torch.sharding.placement.
ServeShard``; JAX ``cache.py:236-290``) the cache holds the rank's KV
heads, its channels of a Mamba layer's conv (B, d_conv-1, di/tp) and
scan state (B, di/tp, ds) and its heads of an RWKV state (B, nh/tp, hd,
hd) (the token shifts whole), and when the slots divide over the "data"
axis the rank holds and computes only its ``n_slots / data`` rows: every
program's tokens are merged over the data axis (one ``all_reduce`` of a
zeroed (n_slots, ...) buffer), so every rank's scheduler sees every slot. The host-built
operands of the chunk and verify programs are rank 0's, broadcast as one
packed tensor (``operands``), so every rank runs the same program.
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
                    dtype=torch.bfloat16, device="cuda", tp=None) -> Cache:
    """Fresh slot-layout cache: all slots empty (slot_pos == -1, pos == 0);
    under ``tp`` the Mamba and RWKV state rows at this rank's widths. On
    ``cuda`` unless the caller asks for the CPU; ``cuda`` without a GPU
    raises (``init_cache``)."""
    base = slotify(init_cache(cfg, n_slots, max_len, dtype, device, tp))
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


def operands(arrays, device, shard=None) -> list:
    """A program's host-built operands as tensors on ``device``. Under a
    mesh, rank 0's arrays on every rank: packed into one int32 tensor,
    broadcast over the world, unpacked into their shapes and dtypes (bool
    or integer arrays)."""
    arrays = [np.asarray(a) for a in arrays]
    if shard is None or shard.mesh.world.size == 1:
        return [tensor(a, device) for a in arrays]
    buf = tensor(np.concatenate([a.astype(np.int32).ravel()
                                 for a in arrays]), device)
    shard.mesh.world.broadcast_(buf)
    out, off = [], 0
    for a in arrays:
        dt = torch.from_numpy(a[:0]).dtype
        out.append(buf[off:off + a.size].view(a.shape).to(dt))
        off += a.size
    return out


class SlottedKV:
    """Dense slot-row backend behind the KVBackend API (``cache.py:233``).
    The cache and the key chains live on the parameters' device."""

    kind = "slotted"
    tel = NULL_TELEMETRY

    def __init__(self, cfg: ArchConfig, params, opts, linkage, n_slots: int,
                 max_len: int, sampling=None, bucket_fn=None,
                 chunked: bool = False, spec: bool = False, shard=None):
        self.cfg, self.params, self.opts = cfg, params, opts
        self.n_slots, self.max_len = n_slots, max_len
        self.device = params["embed"].device
        # under a mesh: this rank's slot rows (all of them unless the slots
        # split over "data"); cfg and params are the rank's
        self.shard = shard
        self.rows = shard.rows if shard is not None else slice(0, n_slots)
        self.split = shard is not None and shard.slots_split
        n_local = self.rows.stop - self.rows.start
        self.cache = init_slot_cache(cfg, n_local, max_len, opts.dtype,
                                     self.device, opts.tp)
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
        # the key chains of this rank's rows
        self.keys = torch.zeros((n_local, 2), dtype=torch.int64,
                                device=self.device)

    def _row(self, slot: int):
        """The local row of ``slot``, or None when another data rank holds
        it."""
        if self.rows.start <= slot < self.rows.stop:
            return slot - self.rows.start
        return None

    def _merge(self, local: torch.Tensor) -> torch.Tensor:
        """Every slot's program output from this rank's rows."""
        if self.shard is None:
            return local
        return self.shard.merge_slots(local, self.split)

    def _seed(self, row: int, key) -> None:
        if key is not None:
            self.keys[row] = key

    def admit(self, slot: int, prompt: np.ndarray, key=None) -> torch.Tensor:
        i = self._row(slot)
        if i is None:            # another data rank prefills it
            first = torch.zeros((1,), dtype=torch.int32, device=self.device)
        else:
            logits, c1 = self._prefill(self.params, prompt)
            write_slot(self.cache, slotify(c1), i)
            self._seed(i, key)
            first, krow = self._sample(logits, self.keys[i:i + 1])
            self.keys[i] = krow[0]
        if self.shard is None:
            return first
        # the owner's token: summed over the data axis (the others hold
        # zero), or data rank 0's when the slots are replicated
        data = self.shard.data
        first = first.contiguous()
        return data.sum_(first) if self.split else data.broadcast_(first)

    def decode(self, next_tokens: torch.Tensor) -> torch.Tensor:
        self.cache, toks, self.keys = self._dec(
            self.params, self.cache, next_tokens[self.rows], self.keys)
        return self._merge(toks)

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
        i = self._row(slot)
        if i is not None:
            self._seed(i, key)
        return 0

    def append_chunk(self, slot: int, start: int, tokens: np.ndarray) -> bool:
        return True                     # a slot row always holds max_len

    def serve_step(self, chunk_tokens, clen, start, reset, emit0, dec_mask,
                   dec_tok):
        toks, clen, start, reset, emit0, dec_mask = (
            t[self.rows] for t in operands(
                (chunk_tokens, clen, start, reset, emit0, dec_mask),
                self.device, self.shard))
        self.cache, t0, seq, self.keys = self._serve(
            self.params, self.cache, toks, clen, start, reset, emit0,
            dec_tok[self.rows], dec_mask, self.keys)
        return self._merge(t0), self._merge(seq)

    # -- speculative decode -------------------------------------------------

    def verify_step(self, tokens, clen, start, vmask):
        toks, clen, start, vmask = (
            t[self.rows] for t in operands((tokens, clen, start, vmask),
                                           self.device, self.shard))
        self.cache, out, n_emit, self.keys = self._verify(
            self.params, self.cache, toks, clen, start, vmask, self.keys)
        return self._merge(out), self._merge(n_emit)

    def rollback(self, slot: int, new_len: int) -> None:
        pass    # the verify program repaired slot_pos and pos; a dense row
                # has no host-side residency to truncate
