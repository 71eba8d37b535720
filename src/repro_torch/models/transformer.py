"""Model assembly of the port: init, embed/unembed, backbone, prefill,
one-token decode (uniform, slotted and paged), the serve chunk and verify
passes (slotted and paged) and the shared-prefix suffix prefill, for the
ATTN/SWA and Mamba mixers with a dense SwiGLU or a top-k MoE in the MLP
position, the cross-attention layer (XATTN: self-attention plus a gated
attention over context embeddings ``xctx``, whose K/V prefill caches) with
a dense MLP, and the RWKV-6 time mix with its channel mix
(``src/repro/models/transformer.py``). An ``embeds_in`` model takes
(B, S, D) embeddings where the others take token ids, and has no embedding
table. Every layer function reaches its
MLP through one dispatch (``mlp_block``), so the slotted, paged, chunked
and speculative engines all serve the MoE layer. Mamba and RWKV layers
carry a recurrent state, not K/V: models with them run on the slotted
two-phase engine only, as in JAX.

JAX stacks each block-pattern position's parameters and scans over blocks;
PyTorch runs eagerly, so the port keeps one parameter dict per layer in
execution order (``params["layers"][b * len(pattern) + p]`` is block ``b``,
pattern position ``p``) and the cache as one dict per layer. Layer specs
come from ``layer_specs(cfg)`` in the same order. Training runs
``loss_fn`` over ``train_backbone``, which sums the MoE aux losses that
the serving paths drop.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import (ATTN, DENSE, MAMBA, MOE, RWKV,
                                      RWKVMIX, SWA, XATTN, ArchConfig,
                                      LayerSpec)
from repro_torch.models import layers as L
from repro_torch.models.layers import ModelOptions, Params

Cache = List[Dict[str, torch.Tensor]]

#: q and kv tiles of the suffix prefill's blockwise attention under the
#: shortcut (the JAX ``ModelOptions`` defaults)
SUFFIX_Q_CHUNK, SUFFIX_KV_CHUNK = 512, 1024


def layer_specs(cfg: ArchConfig) -> List[LayerSpec]:
    """The spec of every layer in execution order. The model runs attention
    (full or sliding-window) and Mamba mixers with a dense SwiGLU or a MoE
    MLP, the cross-attention layer with a dense MLP, and the RWKV-6 time
    mix with its channel mix: every layer of the registered configs. Any
    other layer raises ``ValueError``."""
    for spec in cfg.block_pattern:
        known = ((spec.mixer in (ATTN, SWA, MAMBA)
                  and spec.mlp in (DENSE, MOE))
                 or (spec.mixer, spec.mlp) in ((XATTN, DENSE),
                                               (RWKV, RWKVMIX)))
        if not known:
            raise ValueError(
                f"layer {spec} is not one the model runs: ATTN/SWA/MAMBA + "
                "DENSE/MOE, XATTN + DENSE or RWKV + RWKVMIX")
    return [spec for _ in range(cfg.num_blocks) for spec in cfg.block_pattern]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_layer(gen: torch.Generator, cfg: ArchConfig, spec: LayerSpec,
               device, param_dtype=torch.float32) -> Params:
    """One layer's parameters, each tensor drawn in float32 and cast to
    ``param_dtype`` at once: the float32 transient is one tensor (a 738 MB
    expert stack at moonshot-v1-16b-a3b's widths)."""
    if spec.mixer in (RWKV, MAMBA):
        init_mixer = {RWKV: L.init_rwkv, MAMBA: L.init_mamba}[spec.mixer]
        mixer = init_mixer(gen, cfg, device, param_dtype)
    else:
        mixer = L.init_attention(gen, cfg, spec, device, param_dtype)
    init_mlp = {MOE: L.init_moe, RWKVMIX: L.init_rwkv_mix}.get(spec.mlp,
                                                            L.init_mlp)
    return {"norm1": L.init_rmsnorm(cfg, device, param_dtype),
            "norm2": L.init_rmsnorm(cfg, device, param_dtype),
            "mixer": mixer,
            "mlp": init_mlp(gen, cfg, device, param_dtype)}


def init_params(cfg: ArchConfig, generator: torch.Generator, device,
                param_dtype=torch.float32) -> Params:
    """Random parameters with the JAX package's shapes and distributions
    (``transformer.py:50-68``: embed and lm_head N(0, 0.02²), dense weights
    N(0, 1/fan_in), the (E, D, F) expert weights N(0, 1/E) as JAX's
    ``fan_in = shape[0]`` gives them, norms at 1, the RWKV constants as
    ``init_rwkv`` lists them; no embed table for an ``embeds_in`` model,
    ``transformer.py:54``), drawn in float32 from
    ``generator`` directly on ``device`` (the Mamba constants as
    ``init_mamba`` lists them) and cast to ``param_dtype`` as
    JAX casts them (``transformer.py:67``), one tensor at a time. The
    draws differ from JAX's; weights cross between the two only through
    ``repro_torch.convert.params_from_jax``."""
    device = resolve_device(device)
    specs = layer_specs(cfg)

    def normal(shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32).mul_(0.02).to(param_dtype)

    params: Params = {}
    if not cfg.embeds_in:
        params["embed"] = normal((cfg.vocab_size, cfg.d_model))
    params["layers"] = [init_layer(generator, cfg, spec, device, param_dtype)
                        for spec in specs]
    params["final_norm"] = L.init_rmsnorm(cfg, device, param_dtype)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.d_model, cfg.vocab_size))
    return params


# ---------------------------------------------------------------------------
# Embed / unembed / backbone
# ---------------------------------------------------------------------------

def embed(params: Params, tokens_or_embeds: torch.Tensor, cfg: ArchConfig,
          opts: ModelOptions) -> torch.Tensor:
    """Token ids (B, S) -> (B, S, D) from the table; an ``embeds_in``
    model's (B, S, D) embeddings pass through in the activation dtype
    (``transformer.py:145-150``), made contiguous: a caller's strided view
    (a slice of a longer sequence) would otherwise reach the kernels,
    which take contiguous rows. Under tensor parallelism the table holds
    this rank's vocab rows (``TensorParallel.embed``)."""
    if cfg.embeds_in:
        return tokens_or_embeds.to(opts.dtype).contiguous()
    if opts.tp is not None:
        return opts.tp.embed(params["embed"],
                             tokens_or_embeds.long()).to(opts.dtype)
    return params["embed"][tokens_or_embeds.long()].to(opts.dtype)


def unembed_logits(params: Params, h: torch.Tensor, cfg: ArchConfig,
                   opts: Optional[ModelOptions] = None) -> torch.Tensor:
    """fp32 logits; under tensor parallelism ``lm_head`` holds this rank's
    vocab columns, assembled whole on every rank
    (``TensorParallel.logits``)."""
    tp = opts.tp if opts is not None else None
    if tp is not None:
        h = tp.enter(h, tp.vocab is not None)
    w = params["lm_head"] if not cfg.tie_embeddings else params["embed"].T
    logits = (h @ w.to(h.dtype)).float()
    return logits if tp is None else tp.logits(logits)


def _shift_right(x: torch.Tensor) -> torch.Tensor:
    """x (B,S,D) shifted right one token, zeros in front: the RWKV token
    shift of a full sequence (``transformer.py:75``)."""
    return torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1]


def mlp_block(p: Params, x: torch.Tensor, cfg: ArchConfig, spec: LayerSpec,
              opts: ModelOptions, cache_l: Optional[Params] = None
              ) -> torch.Tensor:
    """The pre-norm MLP half of every layer function, ``x + mlp(norm2(x))``:
    the dense SwiGLU, the MoE without its aux loss, which JAX's prefill,
    decode and serve paths drop (``transformer.py:289, 426, 703, 769``), or
    the RWKV channel mix. The channel mix reads norm2(x) shifted right one
    token. With a layer cache (prefill and decode) the token before the
    first is the cache's ``shift_mlp`` — zeros in the fresh cache prefill
    fills, as JAX's pad (``transformer.py:770``); the previous token's at
    decode (``:284``) — and the last one becomes it."""
    h = L.rmsnorm(p["norm2"], x, cfg.norm_eps, opts)
    if spec.mlp == MOE:
        return x + L.moe(p["mlp"], h, cfg, opts)
    if spec.mlp == RWKVMIX:
        if cache_l is None:
            shifted = _shift_right(h)
        else:
            shifted = torch.cat([cache_l["shift_mlp"].to(h.dtype),
                                 h[:, :-1]], dim=1)
            cache_l["shift_mlp"].copy_(h[:, -1:])
        return x + L.rwkv_mix(p["mlp"], h, shifted, opts)
    return x + L.mlp(p["mlp"], h, opts)


def _mix(p: Params, x: torch.Tensor, cfg: ArchConfig, spec: LayerSpec,
         opts: ModelOptions, positions: torch.Tensor,
         xctx: Optional[torch.Tensor]) -> torch.Tensor:
    """The pre-norm mixer half of a full-sequence layer, ``x +
    mixer(norm1(x))`` (the scans' final states dropped)."""
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps, opts)
    if spec.mixer == RWKV:
        return x + L.rwkv(p["mixer"], h, _shift_right(h), cfg, opts)[0]
    if spec.mixer == MAMBA:
        return x + L.mamba(p["mixer"], h, cfg, opts)[0]
    return x + L.attention(p["mixer"], h, cfg, spec, opts, positions, xctx)


def apply_layer(p: Params, x: torch.Tensor, cfg: ArchConfig, spec: LayerSpec,
                opts: ModelOptions, positions: torch.Tensor,
                xctx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pre-norm residual layer (full sequence); ``xctx`` is the context of
    a cross-attention layer."""
    return mlp_block(p, _mix(p, x, cfg, spec, opts, positions, xctx), cfg,
                     spec, opts)


def apply_layer_train(p: Params, x: torch.Tensor, cfg: ArchConfig,
                      spec: LayerSpec, opts: ModelOptions,
                      positions: torch.Tensor,
                      xctx: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``apply_layer`` of training (JAX ``transformer.py:82``): returns
    (x, the MoE aux loss), which a MoE layer takes from ``moe_with_aux``
    and every other layer makes zero."""
    x = _mix(p, x, cfg, spec, opts, positions, xctx)
    if spec.mlp == MOE:
        h = L.rmsnorm(p["norm2"], x, cfg.norm_eps, opts)
        out, aux = L.moe_with_aux(p["mlp"], h, cfg, opts)
        return x + out, aux
    return (mlp_block(p, x, cfg, spec, opts),
            torch.zeros((), dtype=torch.float32, device=x.device))


def backbone(params: Params, h: torch.Tensor, cfg: ArchConfig,
             opts: ModelOptions, positions: torch.Tensor,
             xctx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h: (B,S,D) embedded input -> final (normed) hidden state; ``xctx``
    (B, n_ctx, ctx_dim) feeds the cross-attention layers. The serving
    view: no aux loss (``train_backbone`` has it)."""
    for p, spec in zip(params["layers"], layer_specs(cfg)):
        h = apply_layer(p, h, cfg, spec, opts, positions, xctx)
    return L.rmsnorm(params["final_norm"], h, cfg.norm_eps, opts)


def train_backbone(params: Params, h: torch.Tensor, cfg: ArchConfig,
                   opts: ModelOptions, positions: torch.Tensor,
                   xctx: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``backbone`` (``transformer.py:107-147``): (final normed
    hidden, the MoE aux losses summed in layer order). Under
    ``opts.remat`` each block of the pattern runs under non-reentrant
    ``torch.utils.checkpoint`` (JAX's ``jax.checkpoint`` of ``block_fn``,
    ``:129-130``): its activations are recomputed in the backward."""
    specs = layer_specs(cfg)
    n = len(cfg.block_pattern)

    def block_fn(x, b):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(b * n, (b + 1) * n):
            x, a = apply_layer_train(params["layers"][i], x, cfg, specs[i],
                                     opts, positions, xctx)
            aux = aux + a
        return x, aux

    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for b in range(cfg.num_blocks):
        if opts.remat:
            h, a = torch.utils.checkpoint.checkpoint(block_fn, h, b,
                                                     use_reentrant=False)
        else:
            h, a = block_fn(h, b)
        aux = aux + a
    return L.rmsnorm(params["final_norm"], h, cfg.norm_eps, opts), aux


# ---------------------------------------------------------------------------
# Loss (with optional chunked cross-entropy that never forms (B, S, V))
# ---------------------------------------------------------------------------

def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-token cross-entropy, ``logsumexp - gold`` in fp32
    (``transformer.py:156``)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return lse - gold


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ArchConfig,
            opts: ModelOptions
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token loss (``transformer.py:163-197``). ``batch``: "inputs"
    (B,S) token ids or (B,S,D) embeddings for an ``embeds_in`` model,
    "labels" (B,S), and "xctx" (B, n_ctx, ctx_dim) for a cross-attention
    model. Under ``opts.logit_chunk`` (which must divide S) the logits are
    formed a chunk of positions at a time and their cross-entropies
    summed. Returns (loss, {"loss", "ce", "moe_aux"}): loss = mean ce +
    the summed MoE aux losses."""
    inputs, labels = batch["inputs"], batch["labels"]
    xctx = batch.get("xctx")
    if cfg.embeds_in:
        h = embed(params, inputs, cfg, opts)
    else:
        # F.embedding, where ``embed`` indexes: its CUDA backward sorts the
        # ids and sums each id's rows in a fixed order, so a step repeats
        # bit for bit (the driver's exact recovery rests on it). Serving
        # keeps indexing: a dead slot's id may be -1, which F.embedding
        # refuses. A vocab-parallel table goes through ``TensorParallel``.
        h = (embed(params, inputs, cfg, opts)
             if opts.tp is not None and opts.tp.vocab is not None else
             torch.nn.functional.embedding(inputs.long(),
                                           params["embed"]).to(opts.dtype))
    B, S = labels.shape
    positions = torch.arange(S, dtype=torch.int32, device=h.device)
    h, aux = train_backbone(params, h, cfg, opts, positions, xctx)
    c = opts.logit_chunk
    if c and S > c:
        if S % c:
            raise ValueError(f"logit_chunk {c} must divide the sequence "
                             f"length {S}")
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(0, S, c):
            logits = unembed_logits(params, h[:, i:i + c], cfg, opts)
            total = total + _xent(logits, labels[:, i:i + c]).sum()
        ce = total / (B * S)
    else:
        ce = _xent(unembed_logits(params, h, cfg, opts), labels).mean()
    loss = ce + aux
    return loss, {"loss": loss, "ce": ce, "moe_aux": aux}


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def cache_len(cfg: ArchConfig, spec: LayerSpec, max_len: int) -> int:
    """Cache rows of one layer: SWA layers keep a circular buffer of
    min(window, max_len)."""
    return min(cfg.sliding_window, max_len) if spec.mixer == SWA else max_len


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda", tp=None) -> Cache:
    """Uniform-layout cache, one dict per layer: k/v (B,T,HKV,dh) zeros,
    slot_pos (T,) at -1 (empty) and pos () at -1 (the JAX int32 fill;
    prefill overwrites it); a Mamba layer holds its conv state
    (B,d_conv-1,di) in ``dtype`` and its scan state (B,di,ds) f32 at zero,
    and pos (``transformer.py:220-224``); an RWKV layer its state
    (B,nh,hd,hd) f32 and the two token shifts (B,1,D) at zero, and pos
    (``transformer.py:227-234``); a cross-attention layer also the
    context's xk/xv (B,ctx_len,HKV,dh) zeros (``:216-218``), which prefill
    fills. Under tensor parallelism (``tp``, a ``TensorParallel``) the
    Mamba rows hold this rank's channels of di and the RWKV state its
    heads (the shifts stay whole). On ``cuda`` unless the caller asks for
    the CPU; ``cuda`` without a GPU raises."""
    device = resolve_device(device)
    out = []
    for spec in layer_specs(cfg):
        pos = torch.full((), -1, dtype=torch.int32, device=device)
        if spec.mixer == MAMBA:
            mc = cfg.mamba
            di = mc.expand * cfg.d_model
            if tp is not None:
                di = tp.width(tp.di, di)
            out.append({
                "conv": torch.zeros((batch, mc.d_conv - 1, di), dtype=dtype,
                                    device=device),
                "ssm": torch.zeros((batch, di, mc.d_state),
                                   dtype=torch.float32, device=device),
                "pos": pos,
            })
            continue
        if spec.mixer == RWKV:
            hd = cfg.rwkv_head_dim
            nh = cfg.d_model // hd
            if tp is not None:
                nh = tp.width(tp.rwkv, nh)
            shift = (batch, 1, cfg.d_model)
            out.append({
                "state": torch.zeros((batch, nh, hd, hd),
                                     dtype=torch.float32, device=device),
                "shift": torch.zeros(shift, dtype=dtype, device=device),
                "shift_mlp": torch.zeros(shift, dtype=dtype, device=device),
                "pos": pos,
            })
            continue
        T = cache_len(cfg, spec, max_len)
        kv = (batch, T, cfg.n_kv_heads, cfg.head_dim)
        g = {
            "k": torch.zeros(kv, dtype=dtype, device=device),
            "v": torch.zeros(kv, dtype=dtype, device=device),
            "slot_pos": torch.full((T,), -1, dtype=torch.int32, device=device),
            "pos": pos,
        }
        if spec.mixer == XATTN:
            xkv = (batch, cfg.xattn_ctx_len, cfg.n_kv_heads, cfg.head_dim)
            g["xk"] = torch.zeros(xkv, dtype=dtype, device=device)
            g["xv"] = torch.zeros(xkv, dtype=dtype, device=device)
        out.append(g)
    return out


def clone_cache(cache: Cache) -> Cache:
    return [{k: v.clone() for k, v in g.items()} for g in cache]


# ---------------------------------------------------------------------------
# Decode step (one token)
# ---------------------------------------------------------------------------

def apply_layer_decode(p: Params, x: torch.Tensor, cache_l: Params,
                       cfg: ArchConfig, spec: LayerSpec, opts: ModelOptions,
                       slots: bool = False, paged_tables=None,
                       paged_max_len: int = 0) -> torch.Tensor:
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps, opts)
    if spec.mixer in (RWKV, MAMBA):   # every row at its own step
        decode = L.rwkv_decode if spec.mixer == RWKV else L.mamba_decode
        mix = decode(p["mixer"], h, cache_l, cfg, tp=opts.tp)
        cache_l["pos"] += 1
    elif paged_tables is not None:
        mix = L.attention_decode_paged(p["mixer"], h, cache_l, paged_tables,
                                       cfg, opts, paged_max_len)
    else:
        attn_fn = L.attention_decode_slots if slots else L.attention_decode
        mix = attn_fn(p["mixer"], h, cache_l, cfg, spec, opts)
    return mlp_block(p, x + mix, cfg, spec, opts, cache_l)


def decode_step(params: Params, cache: Cache, tokens: torch.Tensor,
                cfg: ArchConfig, opts: ModelOptions, slots: bool = False,
                inplace: bool = True) -> Tuple[torch.Tensor, Cache]:
    """tokens: (B,) int, or (B, D) embeddings for an ``embeds_in`` model
    (``transformer.py:308-311``) -> (logits (B,V), cache).

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
    return unembed_logits(params, h, cfg, opts)[:, 0], cache


def decode_step_slots(params: Params, cache: Cache, tokens: torch.Tensor,
                      cfg: ArchConfig, opts: ModelOptions,
                      inplace: bool = True) -> Tuple[torch.Tensor, Cache]:
    """Slot-layout decode: each batch row at its own position (serving)."""
    return decode_step(params, cache, tokens, cfg, opts, slots=True,
                       inplace=inplace)


def _check_pageable(cfg: ArchConfig, what: str) -> None:
    """Paged KV (and shared-prefix prefill) covers full-window attention
    only (``transformer.py:343``): a sliding-window layer's circular buffer
    has no block chain, and a Mamba or RWKV layer carries dense per-slot
    state (RWKV also a channel-mix shift that depends on the final
    position)."""
    for spec in cfg.block_pattern:
        if spec.mixer != ATTN:
            raise ValueError(
                f"{what} supports plain-attention architectures only (got "
                f"mixer={spec.mixer!r}, mlp={spec.mlp!r}); run this arch "
                "with the slotted KV backend")


def decode_step_paged(params: Params, cache: Cache, tokens: torch.Tensor,
                      tables: torch.Tensor, cfg: ArchConfig,
                      opts: ModelOptions, max_len: int, inplace: bool = True
                      ) -> Tuple[torch.Tensor, Cache]:
    """Paged-KV decode (``transformer.py:355``): tokens (B,), tables (B, nb)
    block map shared by every layer (one virtual address space per slot,
    one pool per layer). Per layer the cache is {"kp","vp": (P+1, bs, HKV,
    dh), "pos": (B,)} — the port keeps one dict per layer where JAX stacks
    the layers. ``inplace=False`` returns an updated copy."""
    _check_pageable(cfg, "decode_step_paged")
    if not inplace:
        cache = clone_cache(cache)
    h = embed(params, tokens[:, None], cfg, opts)
    for p, spec, cl in zip(params["layers"], layer_specs(cfg), cache):
        h = apply_layer_decode(p, h, cl, cfg, spec, opts, paged_tables=tables,
                               paged_max_len=max_len)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps, opts)
    return unembed_logits(params, h, cfg, opts)[:, 0], cache


# ---------------------------------------------------------------------------
# Serve chunk and verify steps: the unified serve program's prefill half,
# and the speculative verify pass (the same pass, logits at every position)
# ---------------------------------------------------------------------------

def _serve_chunk_block(params: Params, cache: Cache, h: torch.Tensor,
                       cfg: ArchConfig, opts: ModelOptions,
                       attend) -> torch.Tensor:
    """The layer loop of the serve chunk and verify passes
    (``transformer.py:397``): ``attend(p, x, cache_l)`` is the mixer, the
    slotted or the paged chunk attention; the MLP is ``mlp_block``'s, the
    MoE layer's included (``_chunk_mlp``, ``transformer.py:423``)."""
    for p, spec, cl in zip(params["layers"], layer_specs(cfg), cache):
        hh = L.rmsnorm(p["norm1"], h, cfg.norm_eps, opts)
        h = mlp_block(p, h + attend(p["mixer"], hh, cl), cfg, spec, opts)
    return h


def _chunk_logits(params: Params, h: torch.Tensor, clen: torch.Tensor,
                  cfg: ArchConfig, opts: ModelOptions) -> torch.Tensor:
    """Logits at each row's last real chunk position (clamped for rows with
    no chunk — the caller's emit mask discards them)."""
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps, opts)
    last = torch.clamp(clen.long() - 1, 0, h.shape[1] - 1)
    h_last = torch.gather(h, 1, last[:, None, None].expand(-1, 1,
                                                           h.shape[2]))
    return unembed_logits(params, h_last, cfg, opts)[:, 0]


def _verify_logits(params: Params, h: torch.Tensor, cfg: ArchConfig,
                   opts: ModelOptions) -> torch.Tensor:
    """Logits at all W fed positions, (B, W, V) (``transformer.py:499``):
    verify needs the next-token distribution after every drafted prefix."""
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps, opts)
    return unembed_logits(params, h, cfg, opts)


def _slotted_pass(params, cache, tokens, start, clen, cfg, opts):
    h = embed(params, tokens, cfg, opts)
    return _serve_chunk_block(
        params, cache, h, cfg, opts,
        lambda p, x, cl: L.attention_serve_chunk(p, x, cl, cfg, opts, start,
                                                 clen))


def _paged_pass(params, cache, tokens, tables, start, clen, cfg, opts,
                max_len):
    h = embed(params, tokens, cfg, opts)
    return _serve_chunk_block(
        params, cache, h, cfg, opts,
        lambda p, x, cl: L.attention_serve_chunk_paged(
            p, x, cl, tables, cfg, opts, start, clen, max_len))


def serve_chunk_step(params: Params, cache: Cache, tokens: torch.Tensor,
                     start: torch.Tensor, clen: torch.Tensor,
                     reset: torch.Tensor, cfg: ArchConfig,
                     opts: ModelOptions, inplace: bool = True
                     ) -> Tuple[torch.Tensor, Cache]:
    """Chunked-prefill pass over the slot cache (``transformer.py:443``):
    every row absorbs its own variable-length prompt chunk in one program.
    tokens: (B, W) right-padded chunk ids; start/clen: (B,) write position
    and true length; reset: (B,) bool — rows admitted this step drop their
    stale ``slot_pos`` marks before the write. Returns (logits at ``start +
    clen - 1`` per row, cache)."""
    _check_pageable(cfg, "serve_chunk_step")
    if not inplace:
        cache = clone_cache(cache)
    for g in cache:
        g["slot_pos"].masked_fill_(reset[:, None], -1)
    h = _slotted_pass(params, cache, tokens, start, clen, cfg, opts)
    return _chunk_logits(params, h, clen, cfg, opts), cache


def serve_chunk_step_paged(params: Params, cache: Cache,
                           tokens: torch.Tensor, tables: torch.Tensor,
                           start: torch.Tensor, clen: torch.Tensor,
                           cfg: ArchConfig, opts: ModelOptions, max_len: int,
                           inplace: bool = True
                           ) -> Tuple[torch.Tensor, Cache]:
    """Chunked-prefill pass over the paged pools (``transformer.py:472``):
    ``serve_chunk_step`` through the block tables (B, nb). No reset mask:
    paged validity is positional, and released slots point at the trash
    block."""
    _check_pageable(cfg, "serve_chunk_step_paged")
    if not inplace:
        cache = clone_cache(cache)
    h = _paged_pass(params, cache, tokens, tables, start, clen, cfg, opts,
                    max_len)
    return _chunk_logits(params, h, clen, cfg, opts), cache


def serve_verify_step(params: Params, cache: Cache, tokens: torch.Tensor,
                      start: torch.Tensor, clen: torch.Tensor,
                      cfg: ArchConfig, opts: ModelOptions,
                      inplace: bool = True) -> Tuple[torch.Tensor, Cache]:
    """Speculative verify over the slot cache (``transformer.py:507``):
    the ``serve_chunk_step`` write-then-attend pass, returning logits at
    every fed position (B, W, V). No reset mask: verify rows are
    mid-generation, and padding rows keep clen 0, writing nothing."""
    _check_pageable(cfg, "serve_verify_step")
    if not inplace:
        cache = clone_cache(cache)
    h = _slotted_pass(params, cache, tokens, start, clen, cfg, opts)
    return _verify_logits(params, h, cfg, opts), cache


def serve_verify_step_paged(params: Params, cache: Cache,
                            tokens: torch.Tensor, tables: torch.Tensor,
                            start: torch.Tensor, clen: torch.Tensor,
                            cfg: ArchConfig, opts: ModelOptions,
                            max_len: int, inplace: bool = True
                            ) -> Tuple[torch.Tensor, Cache]:
    """``serve_verify_step`` against the paged pools (``transformer.py:531``):
    the ``serve_chunk_step_paged`` pass — the paged prefill kernels under
    the shortcut — with all-position logits (B, W, V)."""
    _check_pageable(cfg, "serve_verify_step_paged")
    if not inplace:
        cache = clone_cache(cache)
    h = _paged_pass(params, cache, tokens, tables, start, clen, cfg, opts,
                    max_len)
    return _verify_logits(params, h, cfg, opts), cache


# ---------------------------------------------------------------------------
# Prefill: full forward that also fills the cache
# ---------------------------------------------------------------------------

def _prefill_layer(p, x, cache_l, cfg, spec, opts, positions, xctx=None):
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps, opts)
    S = x.shape[1]
    if spec.mixer == RWKV:
        # the recurrence's final state is the decode cache's
        # (``transformer.py:752-762``): the kernel stores it at the shortcut
        mix, state = L.rwkv(p["mixer"], h, _shift_right(h), cfg, opts)
        cache_l["state"].copy_(state)
        cache_l["shift"].copy_(h[:, -1:])
        cache_l["pos"].fill_(S)
        return mlp_block(p, x + mix, cfg, spec, opts, cache_l)
    if spec.mixer == MAMBA:
        # the scan's final state and the conv rows are the decode cache's
        # (``transformer.py:741-752``): the kernel stores the state at the
        # shortcut
        mix, h_last, conv = L.mamba(p["mixer"], h, cfg, opts)
        cache_l["ssm"].copy_(h_last)
        cache_l["conv"].copy_(conv)
        cache_l["pos"].fill_(S)
        return mlp_block(p, x + mix, cfg, spec, opts, cache_l)
    xkv = None
    if spec.mixer == XATTN and xctx is not None:
        # the context's K/V, written for decode (``transformer.py:735-740``)
        xkv = L.xattn_kv(p["mixer"], xctx, cfg, x.dtype)
        cache_l["xk"].copy_(xkv[0])
        cache_l["xv"].copy_(xkv[1])
    mix, k, v = L.attention_kv(p["mixer"], h, cfg, spec, opts, positions,
                               xkv)
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
    return mlp_block(p, x + mix, cfg, spec, opts, cache_l)


def prefill(params: Params, tokens: torch.Tensor, cfg: ArchConfig,
            opts: ModelOptions, max_len: int,
            xctx: Optional[torch.Tensor] = None,
            true_len: Optional[int] = None) -> Tuple[torch.Tensor, Cache]:
    """Run the full sequence, return (last-position logits, filled cache).
    ``tokens`` are ids (B, S), or (B, S, D) embeddings for an ``embeds_in``
    model; ``xctx`` (B, ctx_len, ctx_dim) is the cross-attention layers'
    context, whose K/V the cache keeps for decode.

    ``true_len`` enables *bucketed* prefill: ``tokens`` is a right-padded
    bucket and only the first ``true_len`` positions are real. Causality
    makes the padding invisible to the real positions, so the logits are
    taken at ``true_len - 1`` and the cache is fixed up (``pos = true_len``,
    padded ``slot_pos`` entries invalidated) to be indistinguishable from an
    unpadded prefill (``transformer.py:606-618``). Full-window attention
    only: an SWA circular buffer shorter than the bucket would rotate real
    positions out in favour of padding, and a recurrent state (and the
    RWKV shifts) would be left at the padded end.
    """
    B, S = tokens.shape[:2]
    specs = layer_specs(cfg)
    bad = [s for s in cfg.block_pattern if s.mixer not in (ATTN, XATTN)]
    if true_len is not None and bad:
        raise ValueError("bucketed prefill (true_len) needs full-window "
                         f"attention layers; got mixer={bad[0].mixer!r}, "
                         f"mlp={bad[0].mlp!r}")
    h = embed(params, tokens, cfg, opts)
    positions = torch.arange(S, dtype=torch.int32, device=h.device)
    cache = init_cache(cfg, B, max_len, opts.dtype, h.device, opts.tp)
    for p, spec, cl in zip(params["layers"], specs, cache):
        h = _prefill_layer(p, h, cl, cfg, spec, opts, positions, xctx)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps, opts)
    if true_len is None:
        return unembed_logits(params, h[:, -1:], cfg, opts)[:, 0], cache
    logits = unembed_logits(params, h[:, true_len - 1:true_len], cfg,
                            opts)[:, 0]
    for g in cache:
        g["pos"].fill_(true_len)
        sp = g["slot_pos"]
        sp.masked_fill_((sp < 0) | (sp >= true_len), -1)
    return logits, cache


def prefill_suffix(params: Params, tokens: torch.Tensor, prefix_kv: Cache,
                   prefix_len: int, cfg: ArchConfig, opts: ModelOptions,
                   true_len: Optional[int] = None
                   ) -> Tuple[torch.Tensor, Cache]:
    """Prefill only the *suffix* of a prompt whose first ``prefix_len``
    positions' K/V are already resident (``transformer.py:622``): the paged
    engine found the prefix in its radix index, so a shared system prompt
    is prefilled once and each request runs only its tail.

    tokens:    (B, S) suffix ids at positions ``prefix_len + i``
               (right-padded to a bucket when ``true_len`` is given).
    prefix_kv: one {"k","v"}: (B, Tpre, HKV, dh) per layer, gathered from
               the pool; entries at ``>= prefix_len`` are garbage.

    Returns (logits at suffix position ``(true_len or S) - 1``, one
    {"k","v"}: (B, S, HKV, dh) per layer for the caller to scatter). The
    suffix K/V is written into the prefix buffer at ``prefix_len`` (the
    caller guarantees ``prefix_len + S <= Tpre``), so valid entries sit at
    index == position as in a full prefill and the causal mask alone
    separates real keys from garbage.
    """
    _check_pageable(cfg, "prefill_suffix")
    B, S = tokens.shape
    Tpre = prefix_kv[0]["k"].shape[1]
    h = embed(params, tokens, cfg, opts)
    dev = h.device
    q_pos = prefix_len + torch.arange(S, dtype=torch.int32, device=dev)
    k_pos = torch.arange(Tpre, dtype=torch.int32, device=dev)
    suffix_kv = []
    for p, spec, pkv in zip(params["layers"], layer_specs(cfg), prefix_kv):
        h, kv = _prefill_suffix_layer(p, h, pkv, cfg, spec, opts, q_pos,
                                      k_pos)
        suffix_kv.append(kv)
    h = L.rmsnorm(params["final_norm"], h, cfg.norm_eps, opts)
    last = S if true_len is None else true_len
    return (unembed_logits(params, h[:, last - 1:last], cfg, opts)[:, 0],
            suffix_kv)


def _prefill_suffix_layer(p, x, pkv, cfg, spec, opts, q_pos, k_pos):
    """One attention layer of the suffix prefill. Returns (x, {k, v})."""
    h = L.rmsnorm(p["norm1"], x, cfg.norm_eps, opts)
    B, S, _ = x.shape
    q, k, v = L._qkv(p["mixer"], h, cfg, opts)
    q = L.rope(q, q_pos, cfg.rope_theta)
    k = L.rope(k, q_pos, cfg.rope_theta)
    p0 = int(q_pos[0])
    k_full = pkv["k"].to(k.dtype).clone()
    v_full = pkv["v"].to(v.dtype).clone()
    k_full[:, p0:p0 + S] = k
    v_full[:, p0:p0 + S] = v
    kwargs = dict(causal=True, window=0, q_pos=q_pos, k_pos=k_pos)
    k_full, v_full = L._kv_view(opts, k_full, v_full)
    if opts.attn_impl == "ref":
        out = L._sdpa_ref(q, k_full, v_full, **kwargs)
    else:
        # rectangular q/kv: the blockwise form takes it; the flash kernel
        # is square, so the shortcut lowers through here too (as in JAX)
        out = L._sdpa_chunked(q, k_full, v_full, q_chunk=SUFFIX_Q_CHUNK,
                              kv_chunk=SUFFIX_KV_CHUNK, **kwargs)
    x = x + L._wo(p["mixer"], out.reshape(B, S, -1), opts)
    return mlp_block(p, x, cfg, spec, opts), {"k": k, "v": v}
