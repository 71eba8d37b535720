"""Model assembly of the port: init, embed/unembed, backbone, prefill and
one-token decode for the ATTN/SWA + DENSE architectures
(``src/repro/models/transformer.py``).

JAX stacks each block-pattern position's parameters and scans over blocks;
PyTorch runs eagerly, so the port keeps one parameter dict per layer in
execution order (``params["layers"][b * len(pattern) + p]`` is block ``b``,
pattern position ``p``) and the cache as one dict per layer. Layer specs
come from ``layer_specs(cfg)`` in the same order.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ATTN, DENSE, SWA, ArchConfig, LayerSpec
from repro_torch.models import layers as L
from repro_torch.models.layers import ModelOptions, Params

Cache = List[Dict[str, torch.Tensor]]


def layer_specs(cfg: ArchConfig) -> List[LayerSpec]:
    """The spec of every layer in execution order. The port serves the
    attention (full or sliding-window) + dense SwiGLU subset; the MoE,
    Mamba, RWKV and cross-attention layers are ROADMAP module item 12."""
    for spec in cfg.block_pattern:
        if spec.mixer not in (ATTN, SWA) or spec.mlp != DENSE:
            raise NotImplementedError(
                f"layer {spec} is outside the port's ATTN/SWA + DENSE subset "
                "(ROADMAP module item 12: the model zoo)")
    if cfg.embeds_in:
        raise NotImplementedError("embedding-input configs are ROADMAP module "
                                  "item 12")
    return [spec for _ in range(cfg.num_blocks) for spec in cfg.block_pattern]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_layer(gen: torch.Generator, cfg: ArchConfig, device) -> Params:
    return {"norm1": L.init_rmsnorm(cfg, device),
            "norm2": L.init_rmsnorm(cfg, device),
            "mixer": L.init_attention(gen, cfg, device),
            "mlp": L.init_mlp(gen, cfg, device)}


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device) -> Params:
    """Random parameters with the JAX package's shapes and distributions
    (``transformer.py:50-68``: embed and lm_head N(0, 0.02²), dense weights
    N(0, 1/fan_in), norms at 1), drawn from ``generator`` directly on
    ``device``. The draws differ from JAX's; weights cross between the two
    only through ``repro_torch.convert.params_from_jax``."""
    device = resolve_device(device)
    specs = layer_specs(cfg)
    params: Params = {"embed": torch.randn(
        (cfg.vocab_size, cfg.d_model), generator=generator, device=device,
        dtype=torch.float32) * 0.02}
    params["layers"] = [init_layer(generator, cfg, device) for _ in specs]
    params["final_norm"] = L.init_rmsnorm(cfg, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = torch.randn(
            (cfg.d_model, cfg.vocab_size), generator=generator, device=device,
            dtype=torch.float32) * 0.02
    return params


# ---------------------------------------------------------------------------
# Embed / unembed / backbone
# ---------------------------------------------------------------------------

def embed(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
          opts: ModelOptions) -> torch.Tensor:
    return params["embed"][tokens.long()].to(opts.dtype)


def unembed_logits(params: Params, h: torch.Tensor,
                   cfg: ArchConfig) -> torch.Tensor:
    w = params["lm_head"] if not cfg.tie_embeddings else params["embed"].T
    return (h @ w.to(h.dtype)).float()


def apply_layer(p: Params, x: torch.Tensor, cfg: ArchConfig, spec: LayerSpec,
                opts: ModelOptions, positions: torch.Tensor) -> torch.Tensor:
    """Pre-norm residual layer (full sequence)."""
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps, opts)
    x = x + L.attention(p["mixer"], h, cfg, spec, opts, positions)
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps, opts)
    return x + L.mlp(p["mlp"], h)


def backbone(params: Params, h: torch.Tensor, cfg: ArchConfig,
             opts: ModelOptions, positions: torch.Tensor) -> torch.Tensor:
    """h: (B,S,D) embedded input -> final (normed) hidden state."""
    for p, spec in zip(params["layers"], layer_specs(cfg)):
        h = apply_layer(p, h, cfg, spec, opts, positions)
    return L.rmsnorm(params["final_norm"], h, cfg.norm_eps, opts)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def cache_len(cfg: ArchConfig, spec: LayerSpec, max_len: int) -> int:
    """Cache rows of one layer: SWA layers keep a circular buffer of
    min(window, max_len)."""
    return min(cfg.sliding_window, max_len) if spec.mixer == SWA else max_len


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> Cache:
    """Uniform-layout cache, one dict per layer: k/v (B,T,HKV,dh) zeros,
    slot_pos (T,) at -1 (empty) and pos () at -1 (the JAX int32 fill;
    prefill overwrites it). On ``cuda`` unless the caller asks for the CPU;
    ``cuda`` without a GPU raises."""
    device = resolve_device(device)
    out = []
    for spec in layer_specs(cfg):
        T = cache_len(cfg, spec, max_len)
        kv = (batch, T, cfg.n_kv_heads, cfg.head_dim)
        out.append({
            "k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device),
            "slot_pos": torch.full((T,), -1, dtype=torch.int32, device=device),
            "pos": torch.full((), -1, dtype=torch.int32, device=device),
        })
    return out


def clone_cache(cache: Cache) -> Cache:
    return [{k: v.clone() for k, v in g.items()} for g in cache]


# ---------------------------------------------------------------------------
# Decode step (one token)
# ---------------------------------------------------------------------------

def apply_layer_decode(p: Params, x: torch.Tensor, cache_l: Params,
                       cfg: ArchConfig, spec: LayerSpec, opts: ModelOptions,
                       slots: bool = False) -> torch.Tensor:
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps, opts)
    attn_fn = L.attention_decode_slots if slots else L.attention_decode
    x = x + attn_fn(p["mixer"], h, cache_l, cfg, spec, opts)
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps, opts)
    return x + L.mlp(p["mlp"], h)


def decode_step(params: Params, cache: Cache, tokens: torch.Tensor,
                cfg: ArchConfig, opts: ModelOptions, slots: bool = False,
                inplace: bool = True) -> Tuple[torch.Tensor, Cache]:
    """tokens: (B,) int -> (logits (B,V), cache).

    With ``slots=True`` the cache is in slot layout (``slot_pos``: (B,T),
    ``pos``: (B,) per layer) and every batch row decodes at its own position
    — the serving-engine decode (see ``repro_torch.serve.cache``).
    ``inplace=False`` leaves ``cache`` untouched and returns an updated
    copy, as the functional JAX step does.
    """
    if not inplace:
        cache = clone_cache(cache)
    h = embed(params, tokens[:, None], cfg, opts)
    for p, spec, cl in zip(params["layers"], layer_specs(cfg), cache):
        h = apply_layer_decode(p, h, cl, cfg, spec, opts, slots=slots)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps, opts)
    return unembed_logits(params, h, cfg)[:, 0], cache


def decode_step_slots(params: Params, cache: Cache, tokens: torch.Tensor,
                      cfg: ArchConfig, opts: ModelOptions,
                      inplace: bool = True) -> Tuple[torch.Tensor, Cache]:
    """Slot-layout decode: each batch row at its own position (serving)."""
    return decode_step(params, cache, tokens, cfg, opts, slots=True,
                       inplace=inplace)


# ---------------------------------------------------------------------------
# Prefill: full forward that also fills the cache
# ---------------------------------------------------------------------------

def _prefill_layer(p, x, cache_l, cfg, spec, opts, positions):
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps, opts)
    S = x.shape[1]
    mix, k, v = L.attention_kv(p["mixer"], h, cfg, spec, opts, positions)
    T = cache_l["k"].shape[1]
    if S >= T:
        # decode assumes a circular layout (position p lives at slot p % T)
        roll = S % T
        cache_l["k"].copy_(torch.roll(k[:, S - T:], roll, dims=1))
        cache_l["v"].copy_(torch.roll(v[:, S - T:], roll, dims=1))
        cache_l["slot_pos"].copy_(torch.roll(positions[S - T:], roll))
    else:
        cache_l["k"][:, :S] = k
        cache_l["v"][:, :S] = v
        cache_l["slot_pos"][:S] = positions
    cache_l["pos"].fill_(S)
    x = x + mix
    h2 = L.rmsnorm(p["norm2"], x, cfg.norm_eps, opts)
    return x + L.mlp(p["mlp"], h2)


def prefill(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
            opts: ModelOptions, max_len: int,
            true_len: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    """Run the full sequence, return (last-position logits, filled cache).

    ``true_len`` enables *bucketed* prefill: ``tokens`` is a right-padded
    bucket and only the first ``true_len`` positions are real. Causality
    makes the padding invisible to the real positions, so the logits are
    taken at ``true_len - 1`` and the cache is fixed up (``pos = true_len``,
    padded ``slot_pos`` entries invalidated) to be indistinguishable from an
    unpadded prefill (``transformer.py:606-618``). Full-window attention
    only: an SWA circular buffer shorter than the bucket would rotate real
    positions out in favour of padding.
    """
    B, S = tokens.shape[:2]
    specs = layer_specs(cfg)
    if true_len is not None and any(s.mixer != ATTN for s in specs):
        raise ValueError("bucketed prefill (true_len) needs full-window "
                         "attention layers")
    h = embed(params, tokens, cfg, opts)
    positions = torch.arange(S, dtype=torch.int32, device=h.device)
    cache = init_cache(cfg, B, max_len, opts.dtype, h.device)
    for p, spec, cl in zip(params["layers"], specs, cache):
        h = _prefill_layer(p, h, cl, cfg, spec, opts, positions)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps, opts)
    if true_len is None:
        return unembed_logits(params, h[:, -1:], cfg)[:, 0], cache
    logits = unembed_logits(params, h[:, true_len - 1:true_len], cfg)[:, 0]
    for g in cache:
        g["pos"].fill_(true_len)
        sp = g["slot_pos"]
        sp.masked_fill_((sp < 0) | (sp >= true_len), -1)
    return logits, cache
