"""Layer library of the port, the ATTN/SWA + DENSE subset of
``src/repro/models/layers.py``: init + apply for RMSNorm, RoPE, GQA
attention (full sequence, uniform decode, slotted decode) and the SwiGLU
MLP.

Parameters are nested dicts of tensors with the JAX package's keys and
``(d_in, d_out)`` weight layout, so ``x @ w`` is the same product in both
frameworks. ``ModelOptions.attn_impl`` picks between the plain attention
written here ("ref", the oracle) and the shortcut ("kernel": the wrappers
in ``repro_torch.kernels.ops``, which launch the Hopper kernels for CUDA
tensors and run their plain versions for CPU tensors).

Decode writes the new K/V into the cache tensors in place (the PyTorch
counterpart of JAX buffer donation at linkage L2+); the callers clone the
cache first where the linkage level keeps the caller's state intact.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import SWA, ArchConfig, LayerSpec

Params = Dict[str, Any]

ATTN_IMPLS = ("ref", "kernel")


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    """Execution options — orthogonal to the architecture (UKL linkage picks)."""
    attn_impl: str = "ref"              # ref | kernel
    dtype: torch.dtype = torch.bfloat16  # activation dtype
    fused_norm: bool = False            # fused RMSNorm kernel (shortcut)

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}; known: "
                             f"{ATTN_IMPLS}")


# ---------------------------------------------------------------------------
# Initializers (layers.py:82-85 and the init_* functions: same shapes and
# distributions, drawn from a torch.Generator)
# ---------------------------------------------------------------------------

def _dense_init(gen: torch.Generator, shape, device, scale=None):
    fan_in = shape[0]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32) * scale


def init_rmsnorm(cfg: ArchConfig, device) -> Params:
    return {"scale": torch.ones((cfg.d_model,), dtype=torch.float32,
                                device=device)}


def init_attention(gen, cfg: ArchConfig, device) -> Params:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": _dense_init(gen, (d, hq * dh), device),
        "wk": _dense_init(gen, (d, hkv * dh), device),
        "wv": _dense_init(gen, (d, hkv * dh), device),
        "wo": _dense_init(gen, (hq * dh, d), device,
                          scale=1.0 / math.sqrt(hq * dh)),
    }
    if cfg.attn_bias:
        for name, n in (("bq", hq * dh), ("bk", hkv * dh), ("bv", hkv * dh)):
            p[name] = torch.zeros((n,), dtype=torch.float32, device=device)
    return p


def init_mlp(gen, cfg: ArchConfig, device) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi": _dense_init(gen, (d, f), device),
        "wg": _dense_init(gen, (d, f), device),
        "wo": _dense_init(gen, (f, d), device, scale=1.0 / math.sqrt(f)),
    }


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def _rmsnorm_raw(scale, x, eps):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def rmsnorm(params: Params, x: torch.Tensor, eps: float,
            opts: ModelOptions) -> torch.Tensor:
    if opts.fused_norm:
        from repro_torch.kernels import ops as kops
        return kops.rmsnorm(x, params["scale"], eps=eps)
    return _rmsnorm_raw(params["scale"], x, eps)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, dh); positions: broadcastable to (..., S)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freqs       # (..., S, half)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    if 2 * half < dh:  # odd head dims pass the tail through (layers.py:149-150)
        rot = torch.cat([rot, x[..., 2 * half:].to(rot.dtype)], dim=-1)
    return rot.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, causal / sliding-window)
# ---------------------------------------------------------------------------

def _qkv(params, x, cfg: ArchConfig):
    B, S, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ params["wq"].to(x.dtype)
    k = x @ params["wk"].to(x.dtype)
    v = x @ params["wv"].to(x.dtype)
    if cfg.attn_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    return (q.reshape(B, S, hq, dh), k.reshape(B, S, hkv, dh),
            v.reshape(B, S, hkv, dh))


def _window(cfg: ArchConfig, spec: LayerSpec) -> int:
    return cfg.sliding_window if spec.mixer == SWA else 0


def _sdpa_ref(q, k, v, *, causal: bool, window: int, q_pos, k_pos):
    """Reference attention; materializes scores. q:(B,Sq,HQ,dh) k/v:(B,Sk,HKV,dh)."""
    B, Sq, HQ, dh = q.shape
    HKV = k.shape[2]
    G = HQ // HKV
    qg = q.reshape(B, Sq, HKV, G, dh)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() / math.sqrt(dh)
    mask = torch.ones((Sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, HQ, dh)


def attention_kv(params: Params, x: torch.Tensor, cfg: ArchConfig,
                 spec: LayerSpec, opts: ModelOptions, positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence (prefill) attention; also returns the rotated K and V
    so prefill writes the cache without recomputing the projections (the
    JAX prefill recomputes them and leaves XLA to merge the two)."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    window = _window(cfg, spec)
    if opts.attn_impl == "kernel":
        from repro_torch.kernels import ops as kops
        out = kops.flash_attention(q, k, v, causal=True, window=window)
    else:
        out = _sdpa_ref(q, k, v, causal=True, window=window, q_pos=positions,
                        k_pos=positions)
    y = out.reshape(B, S, -1) @ params["wo"].to(x.dtype)
    return y, k, v


def attention(params: Params, x: torch.Tensor, cfg: ArchConfig,
              spec: LayerSpec, opts: ModelOptions,
              positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence (train / prefill) attention."""
    return attention_kv(params, x, cfg, spec, opts, positions)[0]


def _decode_ref(q, ck, cv, valid, dtype):
    """Plain one-token attention: q (B,1,HQ,dh) against the cache under a
    (B,T) validity mask — the inline path of layers.py:390-398/447-452."""
    B, _, hq, dh = q.shape
    hkv = ck.shape[2]
    qg = q.reshape(B, 1, hkv, hq // hkv, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck).float() / math.sqrt(dh)
    s = s.masked_fill(~valid[:, None, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1).to(dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, cv).reshape(B, 1, hq, dh)


def attention_decode(params: Params, x: torch.Tensor, cache: Params,
                     cfg: ArchConfig, spec: LayerSpec,
                     opts: ModelOptions) -> torch.Tensor:
    """One-token decode against a (possibly circular / sliding-window) KV
    cache, every row at one shared position.

    cache: {"k": (B,T,HKV,dh), "v": (B,T,HKV,dh), "slot_pos": (T,), "pos": ()},
    updated in place (the new K/V row, its position mark, pos + 1).
    """
    B = x.shape[0]
    q, k, v = _qkv(params, x, cfg)  # S == 1
    pos = cache["pos"]
    posv = pos.reshape(1)
    q = rope(q, posv, cfg.rope_theta)
    k = rope(k, posv, cfg.rope_theta)
    ck, cv, slot_pos = cache["k"], cache["v"], cache["slot_pos"]
    slot = (posv % ck.shape[1]).long()
    ck.index_copy_(1, slot, k.to(ck.dtype))
    cv.index_copy_(1, slot, v.to(cv.dtype))
    slot_pos.index_copy_(0, slot, posv.to(slot_pos.dtype))
    window = _window(cfg, spec)

    if opts.attn_impl == "kernel":
        from repro_torch.kernels import ops as kops
        out = kops.decode_attention(q, ck, cv, slot_pos, pos, window=window)
    else:
        valid = (slot_pos <= pos) & (slot_pos >= 0)
        if window > 0:
            valid &= pos - slot_pos < window
        out = _decode_ref(q, ck, cv, valid[None].expand(B, -1), x.dtype)
    cache["pos"] += 1
    return out.reshape(B, 1, -1) @ params["wo"].to(x.dtype)


def attention_decode_slots(params: Params, x: torch.Tensor, cache: Params,
                           cfg: ArchConfig, spec: LayerSpec,
                           opts: ModelOptions) -> torch.Tensor:
    """One-token decode where each batch row is an independent serving *slot*
    at its own position — the continuous-batching primitive.

      cache: {"k": (B,T,HKV,dh), "v": (B,T,HKV,dh),
              "slot_pos": (B,T), "pos": (B,)}, updated in place.
    """
    B = x.shape[0]
    q, k, v = _qkv(params, x, cfg)  # S == 1
    pos = cache["pos"]                                   # (B,)
    q = rope(q, pos[:, None], cfg.rope_theta)
    k = rope(k, pos[:, None], cfg.rope_theta)
    ck, cv, slot_pos = cache["k"], cache["v"], cache["slot_pos"]
    rows = torch.arange(B, device=x.device)
    slot = (pos % ck.shape[1]).long()                    # (B,) write index
    ck[rows, slot] = k[:, 0].to(ck.dtype)
    cv[rows, slot] = v[:, 0].to(cv.dtype)
    slot_pos[rows, slot] = pos.to(slot_pos.dtype)
    window = _window(cfg, spec)

    if opts.attn_impl == "kernel":
        from repro_torch.kernels import ops as kops
        out = kops.slot_decode_attention(q, ck, cv, slot_pos, pos,
                                         window=window)
    else:
        valid = (slot_pos <= pos[:, None]) & (slot_pos >= 0)   # (B,T)
        if window > 0:
            valid &= pos[:, None] - slot_pos < window
        out = _decode_ref(q, ck, cv, valid, x.dtype)
    cache["pos"] += 1
    return out.reshape(B, 1, -1) @ params["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# Dense SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = (torch.nn.functional.silu(x @ params["wg"].to(x.dtype))
         * (x @ params["wi"].to(x.dtype)))
    return h @ params["wo"].to(x.dtype)
