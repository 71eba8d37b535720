"""Serving programs of the port (``src/repro/core/step.py``, serving
subset): the prefill program, the uniform, slotted and paged decode
programs, the paged unified serve program of chunked prefill, and the
greedy sampler, each built at a point of the linkage spectrum.

PyTorch runs eagerly, so a "program" here is a Python callable: at L3 it
runs ``decode_steps`` microsteps back to back without a host sync and
stacks their tokens on the device; at L2+ it updates the cache in place;
at L0/L1 it leaves the caller's cache intact and returns a new one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.linkage import L3_NSS, LinkageConfig
from repro_torch.models import decode_step as model_decode
from repro_torch.models import decode_step_paged as model_decode_paged
from repro_torch.models import decode_step_slots as model_decode_slots
from repro_torch.models import prefill
from repro_torch.models import serve_chunk_step_paged as model_chunk_paged
from repro_torch.models.layers import ModelOptions


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Token-sampling policy. ``temperature == 0`` is greedy argmax (the
    default, and the mode the token-identity tests pin down). Sampling at
    ``temperature > 0`` draws from JAX threefry key chains in the reference;
    its port is ROADMAP module item 3, so it raises here."""
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    def validate(self) -> "SamplingConfig":
        if self.temperature > 0.0:
            raise NotImplementedError(
                "sampling at temperature > 0 needs the threefry key chains "
                "of the JAX reference (ROADMAP module item 3); the port "
                "decodes greedily")
        return self


def make_sampler(sampling: Optional[SamplingConfig]) -> Callable:
    """logits (B,V) -> tokens (B,) int32: greedy argmax (ties go to the
    first index, as ``jnp.argmax``)."""
    (sampling or SamplingConfig()).validate()

    def greedy(logits: torch.Tensor) -> torch.Tensor:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return greedy


def program_label(cfg: ArchConfig, linkage: LinkageConfig,
                  kind: str) -> str:
    """A stable human-readable label for a serving program — ``kind`` is the
    program family the engine dispatched ("decode", "serve_chunk",
    "prefill_admit").
    Telemetry stamps it on ``engine_step`` trace events."""
    tag = linkage.level
    if linkage.level == L3_NSS:
        tag += f"x{linkage.decode_steps}"
    if linkage.ret_async:
        tag += "+ret"
    if linkage.shortcut:
        tag += "+shortcut"
    return f"{kind}/{tag}/d{cfg.d_model}L{cfg.num_blocks}"


def _serving_decode_fn(one: Callable, linkage: LinkageConfig) -> Callable:
    """Lift a one-token microstep ``(params, cache, tokens) -> (cache, nxt)``
    over the linkage spectrum: at L3 ``decode_steps`` tokens per program
    (one host transition per K tokens), else one. Returns ``(params, cache,
    tokens (B,)) -> (cache, tokens (B, K))``."""
    if linkage.level == L3_NSS:
        def many(params, cache, tokens):
            seq = []
            for _ in range(linkage.decode_steps):
                cache, tokens = one(params, cache, tokens)
                seq.append(tokens)
            return cache, torch.stack(seq, dim=1)     # (B, K)
        return many

    def single(params, cache, tokens):
        cache, nxt = one(params, cache, tokens)
        return cache, nxt[:, None]
    return single


def make_decode_fn(cfg: ArchConfig, opts: ModelOptions,
                   linkage: LinkageConfig) -> Callable:
    """Uniform-layout greedy decode (every row at one position):
    ``decode_steps`` tokens per program at L3, else one."""
    sample = make_sampler(None)

    def one(params, cache, tokens):
        logits, cache = model_decode(params, cache, tokens, cfg, opts,
                                     inplace=linkage.donate)
        return cache, sample(logits)
    return _serving_decode_fn(one, linkage)


def build_decode_step(cfg: ArchConfig, opts: ModelOptions,
                      linkage: LinkageConfig) -> Callable:
    linkage.validate()
    return make_decode_fn(cfg, opts, linkage)


def make_slot_decode_fn(cfg: ArchConfig, opts: ModelOptions,
                        linkage: LinkageConfig,
                        sampling: Optional[SamplingConfig] = None
                        ) -> Callable:
    """Slot-layout decode for the serving engine: every batch row is an
    independent in-flight sequence at its own position."""
    sample = make_sampler(sampling)

    def one(params, cache, tokens):
        logits, cache = model_decode_slots(params, cache, tokens, cfg, opts,
                                           inplace=linkage.donate)
        return cache, sample(logits)
    return _serving_decode_fn(one, linkage)


def build_slot_decode_step(cfg: ArchConfig, opts: ModelOptions,
                           linkage: LinkageConfig,
                           sampling: Optional[SamplingConfig] = None
                           ) -> Callable:
    """(params, slot_cache, tokens (B,)) -> (slot_cache, tokens (B, K))."""
    linkage.validate()
    return make_slot_decode_fn(cfg, opts, linkage, sampling)


def make_paged_decode_fn(cfg: ArchConfig, opts: ModelOptions,
                         linkage: LinkageConfig, max_len: int,
                         sampling: Optional[SamplingConfig] = None
                         ) -> Callable:
    """Paged-KV decode (``step.py:369``): the cache is one block pool per
    layer, and each slot's view goes through its block table, passed per
    call — the engine allocates and forks blocks between programs, so the
    table is host state, not program state. Returns ``(params, cache,
    tokens (B,), tables (B, nb)) -> (cache, tokens (B, K))``."""
    sample = make_sampler(sampling)

    def fn(params, cache, tokens, tables):
        def one(params, cache, tokens):
            logits, cache = model_decode_paged(params, cache, tokens, tables,
                                               cfg, opts, max_len,
                                               inplace=linkage.donate)
            return cache, sample(logits)
        return _serving_decode_fn(one, linkage)(params, cache, tokens)
    return fn


def build_paged_decode_step(cfg: ArchConfig, opts: ModelOptions,
                            linkage: LinkageConfig, max_len: int,
                            sampling: Optional[SamplingConfig] = None
                            ) -> Callable:
    """(params, paged_cache, tokens (B,), tables (B, nb)) ->
    (paged_cache, tokens (B, K))."""
    linkage.validate()
    return make_paged_decode_fn(cfg, opts, linkage, max_len, sampling)


def build_serve_step(cfg: ArchConfig, opts: ModelOptions,
                     linkage: LinkageConfig, max_len: int,
                     sampling: Optional[SamplingConfig] = None) -> Callable:
    """The *unified* serve program of chunked prefill over the paged pools
    (``step.py:555``, its ``kv_kind="paged"`` branch):
    one program per engine step, [chunk pass] + [K decode microsteps].

      1. Chunk pass: each slot absorbs its own variable-length prompt chunk
         (decode and empty slots carry a zero-length chunk); K/V written,
         then attended with per-row positions. Rows whose chunk completes
         their prompt sample their first token from the chunk's last
         position (the caller reads ``t0`` only where ``emit0``).
      2. Decode scan: the linkage level's K microsteps — the two-phase
         decode body — advance the rows past prefill (``dec_mask``). The
         other rows ride the scan against ``scan_tables``, where their
         whole row is the trash block, so their garbage never lands in a
         live block; and they keep their position, which the engine's
         pure-decode path trusts between programs.

    Signature: (params, cache, chunk_tokens (B,W) i32, clen (B,) i32,
    start (B,) i32, dec_tok (B,) i32, dec_mask (B,) bool, tables (B,nb)
    i32, scan_tables (B,nb) i32) -> (cache, t0 (B,) i32, seq (B,K) i32).
    Greedy decoding carries no key chains, so JAX's ``emit0`` and ``keys``
    operands have nothing to gate. The slotted program is the rest of
    ROADMAP module item 6.
    """
    linkage.validate()
    sample = make_sampler(sampling)
    K = linkage.decode_steps if linkage.level == L3_NSS else 1

    def fn(params, cache, chunk_toks, clen, start, dec_tok, dec_mask, tables,
           scan_tables):
        logits, cache = model_chunk_paged(
            params, cache, chunk_toks, tables, start, clen, cfg, opts,
            max_len, inplace=linkage.donate)
        t0 = sample(logits)
        toks, seq = dec_tok, []
        for _ in range(K):
            held = [g["pos"].clone() for g in cache]
            logits, cache = model_decode_paged(params, cache, toks,
                                               scan_tables, cfg, opts,
                                               max_len)
            for g, pos in zip(cache, held):
                g["pos"].copy_(torch.where(dec_mask, g["pos"], pos))
            toks = sample(logits)
            seq.append(toks)
        return cache, t0, torch.stack(seq, dim=1)
    return fn


def build_prefill_fn(cfg: ArchConfig, opts: ModelOptions, max_len: int, *,
                     bucket_fn: Optional[Callable[[int], int]] = None
                     ) -> Callable:
    """Full-prompt admission prefill. Returns ``prefill_prompt(params,
    prompt (P,) np.int32) -> (logits (1,V), cache)``, on the parameters'
    device.

    With ``bucket_fn`` the prompt is right-padded to its bucket and
    prefilled with ``true_len`` (in JAX: one compile per bucket, not per
    length; here the same shapes and the same fix-up). Prompts must be
    non-empty: ``true_len == 0`` would read logits from pure padding.
    """
    def prefill_prompt(params, prompt):
        P_ = int(prompt.shape[0])
        if P_ < 1:
            raise ValueError("cannot prefill an empty prompt")
        device = params["embed"].device
        if bucket_fn is None:
            toks = torch.as_tensor(np.asarray(prompt, np.int32))[None]
            return prefill(params, toks.to(device), cfg, opts,
                           max_len=max_len)
        bucket = bucket_fn(P_)
        if bucket < P_:
            raise ValueError(
                f"bucket_fn({P_}) = {bucket} is smaller than the prompt "
                "— buckets must cover the prompt length")
        padded = np.zeros((bucket,), np.int32)
        padded[:P_] = prompt
        return prefill(params, torch.from_numpy(padded)[None].to(device),
                       cfg, opts, max_len=max_len, true_len=P_)
    return prefill_prompt
