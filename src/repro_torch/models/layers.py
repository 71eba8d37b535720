"""Layer library of the port, the ATTN/SWA/XATTN + DENSE/MOE, MAMBA and
RWKV + RWKVMIX layers of ``src/repro/models/layers.py``: init + apply for
RMSNorm, RoPE, GQA attention (full sequence, blockwise, uniform / slotted /
paged decode, the paged serve chunk pass; the gated cross-attention of an
XATTN layer, plain PyTorch as in JAX), the SwiGLU MLP, the top-k MoE
with capacity dispatch, the Mamba-1 selective SSM and the RWKV-6 time mix
(each full sequence and one-token decode), and the RWKV channel mix.

Parameters are nested dicts of tensors with the JAX package's keys and
``(d_in, d_out)`` weight layout, so ``x @ w`` is the same product in both
frameworks. ``ModelOptions.attn_impl`` picks between the plain attention
written here ("ref", the oracle) and the shortcut ("kernel": the wrappers
in ``repro_torch.kernels.ops``, which launch the Hopper kernels for CUDA
tensors and run their plain versions for CPU tensors); ``scan_impl`` does
the same for the MoE router and the Mamba and RWKV recurrences.

Under tensor parallelism (``ModelOptions.tp``, a serving or training
mesh) the attention and MLP layers run at the rank's local head counts
and ``d_ff`` (the ``cfg`` they are given), and the row-parallel ``wo``
products end in one all-reduce over the model axis
(``repro_torch.sharding.comm``); under training the inputs of the
column-parallel projections sum their gradients over it too. The MoE,
Mamba and RWKV layers read their local widths off ``tp`` and their
weights: a MoE layer routes over every expert on every rank (capacity and
the one-hots at the global E) and runs its own experts, its output summed
over the axis; a Mamba layer runs its slice of the inner width, its
``x_proj`` output summed both ways; an RWKV time mix runs its heads (the
group norm per head stays local), the channel mix its slice of ``d_ff``.
Without it nothing changes. JAX's ``constrain_acts``
(``layers.py:65-75``), which pins activations' shardings for GSPMD, has
no counterpart: here every tensor already lives where the rank computes
it.

Decode writes the new K/V (or the Mamba or RWKV state) into the cache
tensors in place (the PyTorch counterpart of JAX buffer donation at
linkage L2+); the callers clone the cache first where the linkage level
keeps the caller's state intact.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import SWA, XATTN, ArchConfig, LayerSpec
from repro_torch.kernels.kv_quant import quant_insert
from repro_torch.kernels.ref import (gather_pool, mamba_scan_ref,
                                     rwkv_scan_ref)

Params = Dict[str, Any]

ATTN_IMPLS = ("ref", "kernel")
SCAN_IMPLS = ("ref", "kernel")
#: MoE routing-group size in tokens: JAX ``ModelOptions.moe_group``'s
#: default, the value its serving paths run with
MOE_GROUP = 4096


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    """Execution options — orthogonal to the architecture (UKL linkage picks)."""
    attn_impl: str = "ref"              # ref | kernel
    scan_impl: str = "ref"              # ref | kernel (JAX: ref|chunked|pallas)
    dtype: torch.dtype = torch.bfloat16  # activation dtype
    fused_norm: bool = False            # fused RMSNorm kernel (shortcut)
    # ---- training (JAX layers.py:41-58) ----
    remat: bool = False                 # recompute each block in backward
    logit_chunk: int = 0                # 0 = whole-seq logits, else chunked
    norm_bf16_grad: bool = False        # RMSNorm dx in the activation dtype
    # ---- a mesh: this rank's tensor parallelism over "model"
    # (``repro_torch.sharding.comm.TensorParallel``); None on one device
    tp: Any = None

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}; known: "
                             f"{ATTN_IMPLS}")
        if self.scan_impl not in SCAN_IMPLS:
            raise ValueError(f"unknown scan_impl {self.scan_impl!r}; known: "
                             f"{SCAN_IMPLS}")


# ---------------------------------------------------------------------------
# Initializers (layers.py:82-85 and the init_* functions: same shapes and
# distributions, drawn in float32 from a torch.Generator, stored in dtype)
# ---------------------------------------------------------------------------

def _dense_init(gen: torch.Generator, shape, device, scale=None,
                dtype=torch.float32):
    """A float32 normal draw scaled in place, then cast to ``dtype`` (the
    JAX ``init_params`` cast): one float32 tensor is the transient."""
    fan_in = shape[0]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32).mul_(scale).to(dtype)


def init_rmsnorm(cfg: ArchConfig, device, dtype=torch.float32) -> Params:
    return {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}


def init_attention(gen, cfg: ArchConfig, spec: LayerSpec, device,
                   dtype=torch.float32) -> Params:
    """``layers.py:158-178``: a cross-attention layer (``XATTN``) adds its
    own projections ``xq`` (D, HQ*dh), ``xk``/``xv`` (ctx_dim, HKV*dh) and
    ``xo`` at the self-attention's scales, and the gate ``xgate`` (1,) at
    zero (the cross-attention starts closed)."""
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": _dense_init(gen, (d, hq * dh), device, dtype=dtype),
        "wk": _dense_init(gen, (d, hkv * dh), device, dtype=dtype),
        "wv": _dense_init(gen, (d, hkv * dh), device, dtype=dtype),
        "wo": _dense_init(gen, (hq * dh, d), device,
                          scale=1.0 / math.sqrt(hq * dh), dtype=dtype),
    }
    if cfg.attn_bias:
        for name, n in (("bq", hq * dh), ("bk", hkv * dh), ("bv", hkv * dh)):
            p[name] = torch.zeros((n,), dtype=dtype, device=device)
    if spec.mixer == XATTN:
        dc = cfg.xattn_ctx_dim
        p["xq"] = _dense_init(gen, (d, hq * dh), device, dtype=dtype)
        p["xk"] = _dense_init(gen, (dc, hkv * dh), device, dtype=dtype)
        p["xv"] = _dense_init(gen, (dc, hkv * dh), device, dtype=dtype)
        p["xo"] = _dense_init(gen, (hq * dh, d), device,
                              scale=1.0 / math.sqrt(hq * dh), dtype=dtype)
        p["xgate"] = torch.zeros((1,), dtype=dtype, device=device)
    return p


def init_mlp(gen, cfg: ArchConfig, device, dtype=torch.float32) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi": _dense_init(gen, (d, f), device, dtype=dtype),
        "wg": _dense_init(gen, (d, f), device, dtype=dtype),
        "wo": _dense_init(gen, (f, d), device, scale=1.0 / math.sqrt(f),
                          dtype=dtype),
    }


def init_moe(gen, cfg: ArchConfig, device, dtype=torch.float32) -> Params:
    """``layers.py:738-747``: the (E, D, F) expert weights take
    ``_dense_init``'s ``fan_in = shape[0]``, so their std is 1/sqrt(E)
    (0.125 at E 64), as in JAX."""
    assert cfg.moe is not None
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    return {
        "router": _dense_init(gen, (d, e), device, scale=0.02, dtype=dtype),
        "wi": _dense_init(gen, (e, d, f), device, dtype=dtype),
        "wg": _dense_init(gen, (e, d, f), device, dtype=dtype),
        "wo": _dense_init(gen, (e, f, d), device, scale=1.0 / math.sqrt(f),
                          dtype=dtype),
    }


def init_mamba(gen, cfg: ArchConfig, device, dtype=torch.float32) -> Params:
    """``layers.py:825-842``: in_proj, conv_w (std 0.2), x_proj, dt_proj
    (std dt_rank^-1/2) and out_proj (std di^-1/2) normal, ``A_log`` =
    log(1..ds) on every channel, ``D`` at 1 and ``dt_bias`` the inverse
    softplus of U(0, 1)·0.1 clipped at 1e-3; every leaf stored in
    ``dtype``, A_log and D too (JAX's ``init_params`` cast,
    ``transformer.py:67``)."""
    mc = cfg.mamba
    d = cfg.d_model
    di = mc.expand * d
    dt_rank = max(d // 16, 1)
    u = torch.rand((di,), generator=gen, device=device, dtype=torch.float32)
    A = torch.arange(1, mc.d_state + 1, dtype=torch.float32, device=device)
    return {
        "in_proj": _dense_init(gen, (d, 2 * di), device, dtype=dtype),
        "conv_w": _dense_init(gen, (mc.d_conv, di), device, scale=0.2,
                              dtype=dtype),
        "x_proj": _dense_init(gen, (di, dt_rank + 2 * mc.d_state), device,
                              dtype=dtype),
        "dt_proj": _dense_init(gen, (dt_rank, di), device,
                               scale=dt_rank ** -0.5, dtype=dtype),
        "dt_bias": torch.log(torch.expm1(
            torch.clamp(u * 0.1, min=1e-3))).to(dtype),
        "A_log": torch.log(A).expand(di, -1).to(dtype).contiguous(),
        "D": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": _dense_init(gen, (di, d), device,
                                scale=1.0 / math.sqrt(di), dtype=dtype),
    }


def init_rwkv(gen, cfg: ArchConfig, device, dtype=torch.float32) -> Params:
    """``layers.py:966-988``: the (D, D) projections ``wr``, ``wk``,
    ``wv``, ``wg`` and ``wo`` at N(0, 1/D), the decay projection ``ww`` at
    std 0.01, the per-head bonus ``u`` (nh, hd) at 0.5, the decay bias at
    -6, the five token-shift mixes at 0.5 and the group-norm scale at 1."""
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    nh = d // hd

    def full(value):
        return torch.full((d,), value, dtype=dtype, device=device)

    p = {name: _dense_init(gen, (d, d), device, dtype=dtype)
         for name in ("wr", "wk", "wv", "wg")}
    p["ww"] = _dense_init(gen, (d, d), device, scale=0.01, dtype=dtype)
    p["wo"] = _dense_init(gen, (d, d), device, scale=1.0 / math.sqrt(d),
                          dtype=dtype)
    p["w_bias"] = full(-6.0)              # base decay ~ exp(-exp(-6))
    p["u"] = _dense_init(gen, (nh, hd), device, scale=0.5, dtype=dtype)
    for name in ("r", "k", "v", "w", "g"):
        p["mix_" + name] = full(0.5)
    p["ln_scale"] = full(1.0)
    return p


def init_rwkv_mix(gen, cfg: ArchConfig, device,
                  dtype=torch.float32) -> Params:
    """``layers.py:712-721``."""
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wk": _dense_init(gen, (d, f), device, dtype=dtype),
        "wv": _dense_init(gen, (f, d), device, scale=1.0 / math.sqrt(f),
                          dtype=dtype),
        "wr": _dense_init(gen, (d, d), device, dtype=dtype),
        "mix_k": torch.full((d,), 0.5, dtype=dtype, device=device),
        "mix_r": torch.full((d,), 0.5, dtype=dtype, device=device),
    }


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def _rmsnorm_raw(scale, x, eps):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


class _RMSNormBF16Grad(torch.autograd.Function):
    """``_rmsnorm_bf16_grad`` (JAX ``layers.py:103-123``): the plain norm
    forward; backward the analytic derivative with dx cast to x's dtype
    before it leaves the op (in JAX the point is bf16 all-reduces of the
    norm's cotangents; with fp32 activations the cast is a no-op)."""

    @staticmethod
    def forward(ctx, scale, x, eps: float):
        ctx.save_for_backward(scale, x)
        ctx.eps = eps
        return _rmsnorm_raw(scale, x, eps)

    @staticmethod
    def backward(ctx, dy):
        from repro_torch.kernels.ref import rmsnorm_bwd_ref
        scale, x = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd_ref(x, scale, dy, eps=ctx.eps)
        return dscale, dx, None


def rmsnorm(params: Params, x: torch.Tensor, eps: float,
            opts: ModelOptions) -> torch.Tensor:
    """``layers.py:126``: the kernel wrapper under ``fused_norm`` (with its
    autograd ``Function`` when training), else the plain norm, whose
    gradient comes from autograd or, under ``norm_bf16_grad``, from
    ``_RMSNormBF16Grad``."""
    if opts.fused_norm:
        from repro_torch.kernels import ops as kops
        return kops.rmsnorm(x, params["scale"], eps=eps)
    if opts.norm_bf16_grad:
        return _RMSNormBF16Grad.apply(params["scale"], x, eps)
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

def _qkv(params, x, cfg: ArchConfig, opts: ModelOptions):
    """The column-parallel projections: under tensor parallelism ``cfg``
    holds the local head counts (and a rank whose KV heads do not split
    holds ``wk``/``wv`` whole, ``serve_shard``); under training the
    input's gradient is summed over the model axis (``enter``)."""
    B, S, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    if opts.tp is not None:
        x = opts.tp.enter(x, opts.tp.heads)
    q = x @ params["wq"].to(x.dtype)
    k = x @ params["wk"].to(x.dtype)
    v = x @ params["wv"].to(x.dtype)
    if cfg.attn_bias:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    return (q.reshape(B, S, hq, dh), k.reshape(B, S, hkv, dh),
            v.reshape(B, S, hkv, dh))


def _kv_view(opts: ModelOptions, *tensors):
    """The KV heads this rank's queries read (every one on one device): the
    head axis is dim 2 of K/V rows and pools, dim 1 of a pool's scales."""
    if opts.tp is None or opts.tp.kv_heads is None:
        return tensors
    return tuple(None if t is None else
                 opts.tp.kv_view(t, 2 if t.dim() == 4 else 1)
                 for t in tensors)


def _wo(params, out: torch.Tensor, opts: ModelOptions) -> torch.Tensor:
    """An attention output projection: row-parallel over the heads under
    tensor parallelism (one ``all_reduce``)."""
    y = out @ params["wo"].to(out.dtype)
    return y if opts.tp is None else opts.tp.row_parallel(y, opts.tp.heads)


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


def _sdpa_chunked(q, k, v, *, causal: bool, window: int, q_pos, k_pos,
                  q_chunk: int, kv_chunk: int):
    """Blockwise flash-style attention in plain PyTorch (``layers.py:214``,
    without the ``causal_skip`` schedule): an online softmax over kv chunks,
    looped over q chunks, never materializing (Sq, Sk). q:(B,Sq,HQ,dh)
    k/v:(B,Sk,HKV,dh); q_pos (Sq,), k_pos (Sk,) give the mask."""
    B, Sq, HQ, dh = q.shape
    Sk, HKV = k.shape[1], k.shape[2]
    G = HQ // HKV
    qc, kc = min(q_chunk, Sq), min(kv_chunk, Sk)
    nq, nk = -(-Sq // qc), -(-Sk // kc)
    pq, pk = nq * qc - Sq, nk * kc - Sk
    pad = torch.nn.functional.pad
    q = pad(q, (0, 0, 0, 0, 0, pq))
    k, v = pad(k, (0, 0, 0, 0, 0, pk)), pad(v, (0, 0, 0, 0, 0, pk))
    q_pos = pad(q_pos, (0, pq), value=-(10 ** 9))
    k_pos = pad(k_pos, (0, pk), value=2 ** 30)
    scale = 1.0 / math.sqrt(dh)
    neg_inf = torch.tensor(float("-inf"), device=q.device)
    outs = []
    for qi in range(nq):
        qb = q[:, qi * qc:(qi + 1) * qc].reshape(B, qc, HKV, G, dh)
        qp = q_pos[qi * qc:(qi + 1) * qc]
        m = torch.full((B, HKV, G, qc), float("-inf"), device=q.device)
        l = torch.zeros((B, HKV, G, qc), device=q.device)
        o = torch.zeros((B, HKV, G, qc, dh), device=q.device)
        for ki in range(nk):
            kb, vb = k[:, ki * kc:(ki + 1) * kc], v[:, ki * kc:(ki + 1) * kc]
            kp = k_pos[ki * kc:(ki + 1) * kc]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb).float() * scale
            msk = torch.ones((qc, kc), dtype=torch.bool, device=q.device)
            if causal:
                msk &= qp[:, None] >= kp[None, :]
            if window > 0:
                msk &= qp[:, None] - kp[None, :] < window
            s = torch.where(msk, s, neg_inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # guard fully masked rows
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.where(msk, torch.exp(s - m_safe[..., None]), 0.0)
            fin = torch.isfinite(m)
            corr = torch.where(fin, torch.exp(torch.where(fin, m - m_safe,
                                                          neg_inf)), 0.0)
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(qb.dtype), vb).float()
            m = m_new
        o = o / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o.to(q.dtype))
    out = torch.stack(outs).permute(1, 0, 4, 2, 3, 5)    # (B,nq,qc,HKV,G,dh)
    return out.reshape(B, nq * qc, HQ, dh)[:, :Sq]


def xattn_kv(params: Params, xctx: torch.Tensor, cfg: ArchConfig,
             dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention's K and V over the context embeddings ``xctx``
    (B, n_ctx, ctx_dim): (B, n_ctx, HKV, dh) each, unrotated
    (``layers.py:338-339``, ``transformer.py:736-737``)."""
    B = xctx.shape[0]
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    x = xctx.to(dtype)
    return ((x @ params["xk"].to(dtype)).reshape(B, -1, hkv, dh),
            (x @ params["xv"].to(dtype)).reshape(B, -1, hkv, dh))


def _xattn(params: Params, x: torch.Tensor, xk: torch.Tensor,
           xv: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The gated cross-attention term, ``tanh(xgate) * (attn(x xq, xk, xv)
    @ xo)``: every query attends every context position, with no mask and
    no rope (``layers.py:333-350``: q_pos and k_pos are zero). Plain
    PyTorch under either ``attn_impl``, as JAX leaves it outside its Pallas
    kernels; one-token decode reads ``xk``/``xv`` from the cache
    (``_xattn_cached``, ``layers.py:681-690``), the same function."""
    B, S, _ = x.shape
    xq = (x @ params["xq"].to(x.dtype)).reshape(B, S, cfg.n_heads,
                                                 cfg.head_dim)
    zq = torch.zeros((S,), dtype=torch.int32, device=x.device)
    zk = torch.zeros((xk.shape[1],), dtype=torch.int32, device=x.device)
    out = _sdpa_ref(xq, xk.to(x.dtype), xv.to(x.dtype), causal=False,
                    window=0, q_pos=zq, k_pos=zk)
    gate = torch.tanh(params["xgate"]).to(x.dtype)
    return gate * (out.reshape(B, S, -1) @ params["xo"].to(x.dtype))


def attention_kv(params: Params, x: torch.Tensor, cfg: ArchConfig,
                 spec: LayerSpec, opts: ModelOptions, positions: torch.Tensor,
                 xkv=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence (prefill) attention; also returns the rotated K and V
    so prefill writes the cache without recomputing the projections (the
    JAX prefill recomputes them and leaves XLA to merge the two). A
    cross-attention layer adds its gated term over ``xkv``, the context's
    (K, V) from ``xattn_kv``."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, cfg, opts)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    window = _window(cfg, spec)
    ka, va = _kv_view(opts, k, v)
    if opts.attn_impl == "kernel":
        from repro_torch.kernels import ops as kops
        out = kops.flash_attention(q, ka, va, causal=True, window=window)
    else:
        out = _sdpa_ref(q, ka, va, causal=True, window=window,
                        q_pos=positions, k_pos=positions)
    y = _wo(params, out.reshape(B, S, -1), opts)
    if spec.mixer == XATTN:
        if xkv is None:
            raise ValueError("a cross-attention layer needs the context "
                             "embeddings (xctx)")
        y = y + _xattn(params, x, *xkv, cfg)
    return y, k, v


def attention(params: Params, x: torch.Tensor, cfg: ArchConfig,
              spec: LayerSpec, opts: ModelOptions, positions: torch.Tensor,
              xctx=None) -> torch.Tensor:
    """Full-sequence (train / prefill) attention; ``xctx`` (B, n_ctx,
    ctx_dim) is a cross-attention layer's context (the other layers
    ignore it)."""
    xkv = (xattn_kv(params, xctx, cfg, x.dtype)
           if xctx is not None and spec.mixer == XATTN else None)
    return attention_kv(params, x, cfg, spec, opts, positions, xkv)[0]


def _attend_ref(q, ck, cv, valid, dtype):
    """Plain attention of S queries per row against the cache under a
    per-row (B,S,T) validity mask — the inline paths of layers.py:390-398,
    447-452, 529-534 and 667-672. q (B,S,HQ,dh), ck/cv (B,T,HKV,dh)."""
    B, S, hq, dh = q.shape
    hkv = ck.shape[2]
    qg = q.reshape(B, S, hkv, hq // hkv, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck).float() / math.sqrt(dh)
    s = s.masked_fill(~valid[:, None, None], float("-inf"))
    p = torch.softmax(s, dim=-1).to(dtype)
    return torch.einsum("bhgqk,bkhd->bqhgd", p, cv).reshape(B, S, hq, dh)


def _decode_ref(q, ck, cv, valid, dtype):
    """One-token ``_attend_ref``: q (B,1,HQ,dh) under a (B,T) mask."""
    return _attend_ref(q, ck, cv, valid[:, None], dtype)


def _decode_out(params, x, out, cache, cfg, spec, opts):
    """The one-token mixer output: the attention through ``wo``, plus a
    cross-attention layer's gated term over the cache's ``xk``/``xv``
    (``layers.py:401-404, 455-458``)."""
    y = _wo(params, out.reshape(x.shape[0], 1, -1), opts)
    if spec.mixer == XATTN:
        y = y + _xattn(params, x, cache["xk"], cache["xv"], cfg)
    return y


def attention_decode(params: Params, x: torch.Tensor, cache: Params,
                     cfg: ArchConfig, spec: LayerSpec,
                     opts: ModelOptions) -> torch.Tensor:
    """One-token decode against a (possibly circular / sliding-window) KV
    cache, every row at one shared position.

    cache: {"k": (B,T,HKV,dh), "v": (B,T,HKV,dh), "slot_pos": (T,), "pos": ()},
    updated in place (the new K/V row, its position mark, pos + 1); a
    cross-attention layer's also holds the context's "xk"/"xv".
    """
    B = x.shape[0]
    q, k, v = _qkv(params, x, cfg, opts)  # S == 1
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
    ck, cv = _kv_view(opts, ck, cv)

    if opts.attn_impl == "kernel":
        from repro_torch.kernels import ops as kops
        out = kops.decode_attention(q, ck, cv, slot_pos, pos, window=window)
    else:
        valid = (slot_pos <= pos) & (slot_pos >= 0)
        if window > 0:
            valid &= pos - slot_pos < window
        out = _decode_ref(q, ck, cv, valid[None].expand(B, -1), x.dtype)
    cache["pos"] += 1
    return _decode_out(params, x, out, cache, cfg, spec, opts)


def attention_decode_slots(params: Params, x: torch.Tensor, cache: Params,
                           cfg: ArchConfig, spec: LayerSpec,
                           opts: ModelOptions) -> torch.Tensor:
    """One-token decode where each batch row is an independent serving *slot*
    at its own position — the continuous-batching primitive.

      cache: {"k": (B,T,HKV,dh), "v": (B,T,HKV,dh),
              "slot_pos": (B,T), "pos": (B,)}, updated in place.
    """
    B = x.shape[0]
    q, k, v = _qkv(params, x, cfg, opts)  # S == 1
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
    ck, cv = _kv_view(opts, ck, cv)

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
    return _decode_out(params, x, out, cache, cfg, spec, opts)


def attention_serve_chunk(params: Params, x: torch.Tensor, cache: Params,
                          cfg: ArchConfig, opts: ModelOptions,
                          start: torch.Tensor,
                          clen: torch.Tensor) -> torch.Tensor:
    """Variable-length *chunk* attention against the slot cache — the
    slotted unified serve step's prefill half and the slotted verify pass
    (``layers.py:543-604``).

      x:     (B, W, D) chunk hidden states, right-padded per row
      cache: {"k"/"v": (B,T,HKV,dh), "slot_pos": (B,T), "pos": (B,)},
             updated in place
      start: (B,) first position each row's chunk occupies
      clen:  (B,) real tokens in the row's chunk (0 = no chunk)

    The chunk K/V lands at ``(start + j) % T`` for ``j < clen``; padding
    positions write back the value they read, so a row near max_len never
    clobbers resident state. Then all W queries attend over the updated
    row under the per-query causal mask ``0 <= slot_pos <= q_pos``: each
    real query computes what a full prefill computes for it, and garbage
    that fused decode microsteps marked valid past ``start + clen`` stays
    masked until the chunk that covers it overwrites it. The einsum and
    softmax are the plain slotted decode's, so a width-1 chunk is exactly
    a decode step. ``pos`` becomes ``start + clen``: positions are the
    host's in chunked serving. No kernel: the reference's is a dense
    masked einsum too.
    """
    B, W, _ = x.shape
    q, k, v = _qkv(params, x, cfg, opts)                 # (B, W, H, dh)
    q_pos = start[:, None] + torch.arange(W, dtype=start.dtype,
                                          device=x.device)[None]
    q = rope(q, q_pos, cfg.rope_theta)
    k = rope(k, q_pos, cfg.rope_theta)
    ck, cv, slot_pos = cache["k"], cache["v"], cache["slot_pos"]
    rows = torch.arange(B, device=x.device)[:, None]
    idx = (q_pos % ck.shape[1]).long()                   # (B, W) write slots
    real = torch.arange(W, device=x.device)[None] < clen[:, None]
    m = real[..., None, None]
    ck[rows, idx] = torch.where(m, k.to(ck.dtype), ck[rows, idx])
    cv[rows, idx] = torch.where(m, v.to(cv.dtype), cv[rows, idx])
    slot_pos[rows, idx] = torch.where(real, q_pos.to(slot_pos.dtype),
                                      slot_pos[rows, idx])
    valid = ((slot_pos[:, None, :] >= 0)
             & (slot_pos[:, None, :] <= q_pos[:, :, None]))   # (B, W, T)
    out = _attend_ref(q, *_kv_view(opts, ck, cv), valid, x.dtype)
    cache["pos"].copy_(start + clen)
    return _wo(params, out.reshape(B, W, -1), opts)


def _paged_write(cache: Params, blk: torch.Tensor, off: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor):
    """Write K/V at pool positions (blk, off), in place: a plain store on
    an unquantized pool, ``quant_insert`` on a quantized one. Returns the
    scale tensors (``None, None`` when unquantized)."""
    kp, vp = cache["kp"], cache["vp"]
    if "ks" not in cache:
        kp[blk, off] = k.to(kp.dtype)
        vp[blk, off] = v.to(vp.dtype)
        return None, None
    quant_insert(kp, cache["ks"], blk, off, k)
    quant_insert(vp, cache["vs"], blk, off, v)
    return cache["ks"], cache["vs"]


def _paged_view(pool, tables, scales, max_len: int, dtype):
    """Each slot's logical view of a pool, (B, max_len, HKV, dh), in the
    activation dtype; a quantized pool is decoded after the gather (the
    same bits as JAX's decode of the whole pool, for less work)."""
    return gather_pool(pool, tables, scales)[:, :max_len].to(dtype)


def attention_decode_paged(params: Params, x: torch.Tensor, cache: Params,
                           tables: torch.Tensor, cfg: ArchConfig,
                           opts: ModelOptions, max_len: int) -> torch.Tensor:
    """One-token decode against a *paged* KV cache (``layers.py:463``).

      cache:  {"kp": (P+1, bs, HKV, dh), "vp": (P+1, bs, HKV, dh),
               "pos": (B,)}, updated in place; quantized pools (int8 /
               fp8) add their per-block scales "ks"/"vs": (P+1, HKV)
      tables: (B, nb) int32 — per-slot logical-block -> pool-row map

    Row P of the pool is the trash block: empty and finished slots point at
    it, so their garbage writes never touch a live sequence. The fresh K/V
    of slot b lands at (tables[b, pos // bs], pos % bs); the engine has
    allocated (and copy-on-write forked) that block before the program.
    Several dead slots may write the trash row at one offset; which write
    wins is unspecified, and harmless because the trash row is never read
    as live. A quantized pool takes the write through ``quant_insert``,
    which re-encodes the touched blocks (``layers.py:501-508``). The plain
    path gathers each slot's logical view (decoded to the activation dtype
    when quantized), sliced to ``max_len``, and runs exactly the slotted
    decode's masked softmax; the kernel path reads the pool in place
    through the table, fusing the decode.
    """
    B = x.shape[0]
    q, k, v = _qkv(params, x, cfg, opts)  # S == 1
    pos = cache["pos"]                                   # (B,)
    q = rope(q, pos[:, None], cfg.rope_theta)
    k = rope(k, pos[:, None], cfg.rope_theta)
    kp, vp = cache["kp"], cache["vp"]
    bs, nb = kp.shape[1], tables.shape[1]
    logical = torch.clamp(pos // bs, 0, nb - 1).long()
    blk = torch.gather(tables, 1, logical[:, None])[:, 0].long()
    off = (pos % bs).long()
    ks, vs = _paged_write(cache, blk, off, k[:, 0], v[:, 0])
    kp, vp, ks, vs = _kv_view(opts, kp, vp, ks, vs)

    if opts.attn_impl == "kernel":
        from repro_torch.kernels import ops as kops
        out = kops.paged_decode_attention(q, kp, vp, tables, pos, ks, vs)
    else:
        valid = (torch.arange(max_len, device=x.device)[None]
                 <= pos[:, None])
        out = _decode_ref(q, _paged_view(kp, tables, ks, max_len, x.dtype),
                          _paged_view(vp, tables, vs, max_len, x.dtype),
                          valid, x.dtype)
    cache["pos"] += 1
    return _wo(params, out.reshape(B, 1, -1), opts)


def attention_serve_chunk_paged(params: Params, x: torch.Tensor,
                                cache: Params, tables: torch.Tensor,
                                cfg: ArchConfig, opts: ModelOptions,
                                start: torch.Tensor, clen: torch.Tensor,
                                max_len: int) -> torch.Tensor:
    """Variable-length *chunk* attention against the paged pools — the
    unified serve step's prefill half (``layers.py:606``).

      x:     (B, W, D) chunk hidden states, right-padded per row
      start: (B,) first position each row's chunk occupies
      clen:  (B,) real tokens in the row's chunk (0 = no chunk)

    Real chunk K/V lands at (tables[b, p // bs], p % bs); padding rows
    write the trash row (the engine allocated and forked every block of the
    real span, so those destinations belong to the row alone). On a
    quantized pool the writes go through ``quant_insert``
    (``layers.py:640-646``): padding requantizes only the trash row. Then
    all W queries attend with the per-query causal mask ``t <= start + w``:
    garbage past a row's resident end sits above every real query's
    position. ``pos`` becomes ``start + clen``: positions are the host's in
    chunked serving.
    """
    B, W, _ = x.shape
    q, k, v = _qkv(params, x, cfg, opts)                 # (B, W, H, dh)
    q_pos = start[:, None] + torch.arange(W, dtype=start.dtype,
                                          device=x.device)[None]
    q = rope(q, q_pos, cfg.rope_theta)
    k = rope(k, q_pos, cfg.rope_theta)
    kp, vp = cache["kp"], cache["vp"]
    bs, nb, trash = kp.shape[1], tables.shape[1], kp.shape[0] - 1
    real = torch.arange(W, device=x.device)[None] < clen[:, None]  # (B, W)
    logical = torch.clamp(q_pos // bs, 0, nb - 1).long()
    blk = torch.where(real, torch.gather(tables, 1, logical),
                      trash).long()
    off = (q_pos % bs).long()
    ks, vs = _paged_write(cache, blk, off, k, v)
    kp, vp, ks, vs = _kv_view(opts, kp, vp, ks, vs)

    if opts.attn_impl == "kernel":
        from repro_torch.kernels import ops as kops
        out = kops.paged_prefill_attention(q, kp, vp, tables, start, ks, vs)
    else:
        valid = (torch.arange(max_len, device=x.device)[None, None, :]
                 <= q_pos[:, :, None])                    # (B, W, max_len)
        out = _attend_ref(q, _paged_view(kp, tables, ks, max_len, x.dtype),
                          _paged_view(vp, tables, vs, max_len, x.dtype),
                          valid, x.dtype)
    cache["pos"].copy_(start + clen)
    return _wo(params, out.reshape(B, W, -1), opts)


# ---------------------------------------------------------------------------
# Dense SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp(params: Params, x: torch.Tensor,
        opts: ModelOptions = ModelOptions()) -> torch.Tensor:
    """The SwiGLU MLP; under tensor parallelism ``wi``/``wg`` hold this
    rank's slice of ``d_ff`` and ``wo`` is row-parallel."""
    if opts.tp is not None:
        x = opts.tp.enter(x, opts.tp.ff)
    h = (torch.nn.functional.silu(x @ params["wg"].to(x.dtype))
         * (x @ params["wi"].to(x.dtype)))
    y = h @ params["wo"].to(x.dtype)
    return y if opts.tp is None else opts.tp.row_parallel(y, opts.tp.ff)


def rwkv_mix(params: Params, x: torch.Tensor, shifted: torch.Tensor,
             opts: ModelOptions = ModelOptions()) -> torch.Tensor:
    """RWKV channel mix (``layers.py:724``). ``shifted`` is x shifted right
    one token. Under tensor parallelism with ``d_ff`` split, ``wk`` holds
    this rank's columns of it and ``wv`` its rows (row-parallel); ``wr``
    is whole, so only the key mix enters the model axis."""
    tp = opts.tp
    mk = params["mix_k"].to(x.dtype)
    mr = params["mix_r"].to(x.dtype)
    xk = x * mk + shifted * (1 - mk)
    xr = x * mr + shifted * (1 - mr)
    if tp is not None:
        xk = tp.enter(xk, tp.ff)
    k = torch.square(torch.relu(xk @ params["wk"].to(x.dtype)))
    kv = k @ params["wv"].to(x.dtype)
    if tp is not None:
        kv = tp.row_parallel(kv, tp.ff)
    return torch.sigmoid(xr @ params["wr"].to(x.dtype)) * kv


# ---------------------------------------------------------------------------
# Mixture of Experts (top-k, capacity-based dispatch; layers.py:750-818)
# ---------------------------------------------------------------------------

def top_k_stable(probs: torch.Tensor, k: int):
    """``lax.top_k`` over the last dim: descending, ties to the lower
    index. A stable descending sort keeps equal values in index order;
    ``torch.topk`` guarantees no order among ties."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def router_probs(router: torch.Tensor, xt: torch.Tensor,
                 opts: ModelOptions) -> torch.Tensor:
    """The router's softmax over the experts, ``layers.py:778-786``: f32
    under ``scan_impl == "kernel"``; under "ref" cast to x's dtype, as JAX
    keeps the (G,gs,E) tensor downstream in the activation dtype."""
    probs = torch.softmax((xt @ router.to(xt.dtype)).float(), dim=-1)
    return probs if opts.scan_impl == "kernel" else probs.to(xt.dtype)


def _route(router: torch.Tensor, xt: torch.Tensor, K: int,
           opts: ModelOptions):
    """The routing step of ``moe`` (``layers.py:772-787``): xt (G,gs,D)
    -> (gates (G,gs,K), idx (G,gs,K) int32). Under ``scan_impl ==
    "kernel"`` the router kernel alone: f32 gates, the (N, E)
    probabilities never formed. Under "ref" the top-k of
    ``router_probs``, gates in x's dtype."""
    G, gs, D = xt.shape
    if opts.scan_impl == "kernel":
        from repro_torch.kernels import ops as kops
        gates, idx = kops.moe_route(xt.reshape(G * gs, D),
                                    router.to(xt.dtype), K)
        return gates.reshape(G, gs, K), idx.reshape(G, gs, K)
    return top_k_stable(router_probs(router, xt, opts), K)


def _expert_matmul(xe: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(G,E,C,a) @ (E,a,b) -> (G,E,C,b) as one batched product over E with
    the weights in their stored layout: only the small activation is
    permuted, the (E,a,b) weight is never copied."""
    G, E, C, a = xe.shape
    rows = xe.permute(1, 0, 2, 3).reshape(E, G * C, a)
    out = torch.bmm(rows, w)                               # (E, G*C, b)
    return out.reshape(E, G, C, -1).permute(1, 0, 2, 3)


def _moe(params: Params, x: torch.Tensor, cfg: ArchConfig,
         opts: ModelOptions):
    """``moe``'s output, with the grouped tokens and the routing one-hots
    the aux loss reads."""
    mcfg = cfg.moe
    tp = opts.tp
    split = tp is not None and tp.experts is not None
    if split:           # routing and dispatch: partial gradients on x
        x = tp.enter(x, True)
    B, S, D = x.shape
    N = B * S
    E, K = mcfg.num_experts, mcfg.top_k
    gs = min(MOE_GROUP, S)
    while S % gs != 0:                 # largest divisor of S not above cap
        gs -= 1
    G = N // gs
    xt = x.reshape(G, gs, D)

    gates, idx = _route(params["router"], xt, K, opts)
    gates = gates.float()
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    C = min(max(int(gs * K * mcfg.capacity_factor / E), 1), gs)
    onehot = torch.nn.functional.one_hot(idx.long(), E).to(torch.int32)
    flat = onehot.reshape(G, gs * K, E)
    pos_in_e = torch.cumsum(flat, dim=1) * flat - 1           # (G,gs*K,E)
    pos = pos_in_e.amax(dim=-1).reshape(G, gs, K)
    keep = (pos >= 0) & (pos < C)
    gates = gates * keep

    pos_oh = torch.nn.functional.one_hot(
        torch.where(keep, pos, C).long(), C + 1).to(x.dtype)[..., :C]
    disp = torch.einsum("gske,gskc->gsec", onehot.to(x.dtype), pos_oh)
    comb = torch.einsum("gske,gskc,gsk->gsec", onehot.float(),
                        pos_oh.float(), gates).to(x.dtype)

    if split:           # this rank's experts' slots
        lo, hi = tp.experts
        disp, comb = disp[:, :, lo:hi], comb[:, :, lo:hi]
    xe = torch.einsum("gsd,gsec->gecd", xt, disp)             # (G,E,C,D)
    if tp is not None and tp.ep is not None:
        ye = _experts_resident(params, xe, tp)
    else:
        ye = _experts(params, xe)
    y = torch.einsum("gecd,gsec->gsd", ye, comb)
    if split:
        y = tp.row_parallel(y, True)
    return y.reshape(B, S, D), xt, onehot


def _experts(params: Params, xe: torch.Tensor) -> torch.Tensor:
    """The SwiGLU experts over their slots: (G,E,C,D) -> (G,E,C,D)."""
    h = (torch.nn.functional.silu(
        _expert_matmul(xe, params["wg"].to(xe.dtype)))
        * _expert_matmul(xe, params["wi"].to(xe.dtype)))
    return _expert_matmul(h, params["wo"].to(xe.dtype))


def _experts_resident(params: Params, xe: torch.Tensor, tp) -> torch.Tensor:
    """``ep_resident``: every expert's slots (G,E,C,D) go to the rank that
    holds the expert (``tp.ep``: rank r holds experts [r·E/W, (r+1)·E/W)),
    which runs every rank's slots of its experts at once, and come back
    (the reverse exchange): (G,E,C,D). Every rank sends its own tokens,
    model ranks of one data row the same ones."""
    G, E, C, D = xe.shape
    W = tp.ep.size
    e = E // W
    recv = tp.all_to_all(xe.permute(1, 0, 2, 3))               # (E,G,C,D)
    rows = recv.reshape(W, e, G, C, D).permute(0, 2, 1, 3, 4)
    ye = _experts(params, rows.reshape(W * G, e, C, D))        # (W·G,e,C,D)
    back = ye.reshape(W, G, e, C, D).permute(0, 2, 1, 3, 4)
    return tp.all_to_all(back.reshape(E, G, C, D)).permute(1, 0, 2, 3)


def moe(params: Params, x: torch.Tensor, cfg: ArchConfig,
        opts: ModelOptions) -> torch.Tensor:
    """Grouped capacity-based top-k MoE (GShard formulation), the output of
    ``layers.py:750-818`` line for line; the serving paths drop the aux
    loss, as JAX's do, so it is never formed here (``moe_with_aux``).

    Tokens split into groups of the largest divisor of S not above
    ``MOE_GROUP``; capacity is per group, C = min(max(int(gs·K·cf/E), 1),
    gs), and an expert's slots go to its tokens in (s, k) order — the rest
    are dropped. The dispatch and combine one-hots are (G,gs,E,C); the
    combine weights are formed in fp32, then cast to x's dtype. Every
    expert runs its C slots of every group, as in the reference.
    """
    return _moe(params, x, cfg, opts)[0]


def moe_with_aux(params: Params, x: torch.Tensor, cfg: ArchConfig,
                 opts: ModelOptions) -> Tuple[torch.Tensor, torch.Tensor]:
    """(output, router aux loss), JAX's ``moe`` contract, for training
    (ROADMAP module item 11): the Switch-style load-balancing loss over
    ``router_probs``, averaged over groups (``layers.py:814-817``)."""
    y, xt, onehot = _moe(params, x, cfg, opts)
    E = cfg.moe.num_experts
    me = router_probs(params["router"], xt, opts).float().mean(dim=1)  # (G,E)
    frac = onehot.sum(dim=2).float().mean(dim=1)              # (G,E)
    aux = (me * frac).sum(-1).mean() * E * cfg.moe.router_aux_coef
    if opts.tp is not None and opts.tp.experts is not None:
        # every rank forms the whole aux loss, and the router's and x's
        # gradients are summed over the model axis: count it once
        aux = opts.tp.once(aux)
    return y, aux


# ---------------------------------------------------------------------------
# Mamba-1 selective SSM (layers.py:825-960)
# ---------------------------------------------------------------------------

def _mamba_gates(params: Params, x: torch.Tensor, cfg: ArchConfig,
                 conv_state=None, tp=None):
    """The computation before the scan (``layers.py:845``): in_proj split
    into xin and the gate z, the causal depthwise conv over ``conv_state``
    (zeros when None) followed by xin, summed in JAX's order over the
    d_conv taps, silu, x_proj split into the low-rank dt, B and C, dt =
    softplus(dt_lr @ dt_proj + dt_bias), all in x's dtype, and A =
    -exp(A_log) in float32. Returns (dt, A, Bv, Cv, xc, z, the new conv
    state: the last d_conv - 1 rows of the padded *pre-conv* xin).

    Under tensor parallelism over the inner width (``tp.di``) every leaf
    holds this rank's channels (``in_proj`` its channels of xin and of z):
    the conv, dt and the scan's channels are local, and ``x_proj``, a
    row-parallel product, is summed over the model axis both ways (its
    dt, B and C feed this rank's channels again, whose gradients are
    partial)."""
    mc = cfg.mamba
    di = params["conv_w"].shape[1]                  # this rank's channels
    dt_rank = max(cfg.d_model // 16, 1)
    split = tp is not None and tp.di is not None
    if split:
        x = tp.enter(x, True)
    B, S, _ = x.shape
    xin, z = (x @ params["in_proj"].to(x.dtype)).split(di, dim=-1)
    w = params["conv_w"].to(x.dtype)                        # (d_conv, di)
    pad = (torch.zeros((B, mc.d_conv - 1, di), dtype=x.dtype,
                       device=x.device)
           if conv_state is None else conv_state.to(x.dtype))
    xp = torch.cat([pad, xin], dim=1)
    new_conv_state = xp[:, -(mc.d_conv - 1):] if mc.d_conv > 1 else pad
    xc = 0
    for i in range(mc.d_conv):
        xc = xc + xp[:, i:i + S] * w[i]
    xc = torch.nn.functional.silu(xc)
    proj = xc @ params["x_proj"].to(x.dtype)
    if split:
        proj = tp.sum_both(proj)
    dt_lr, Bv, Cv = proj.split([dt_rank, mc.d_state, mc.d_state], dim=-1)
    dt = torch.nn.functional.softplus(dt_lr @ params["dt_proj"].to(x.dtype)
                                      + params["dt_bias"].to(x.dtype))
    A = -torch.exp(params["A_log"]).float()                  # (di, ds)
    return dt, A, Bv, Cv, xc, z, new_conv_state


def _mamba_discretize(x, dt, A, Bv):
    """``layers.py:880``: a = exp(dt·A) and bx = (dt·x)·B, float32, with
    ``dt·x`` formed in the inputs' dtype."""
    a = torch.exp(dt.float()[..., None] * A)
    bx = (dt * x).float()[..., None] * Bv.float()[..., None, :]
    return a, bx


def _mamba_out(params: Params, y: torch.Tensor, xc: torch.Tensor,
               z: torch.Tensor, x: torch.Tensor, tp=None) -> torch.Tensor:
    """The D skip and the silu(z) gate around the scan, then out_proj
    (``layers.py:943-945``; row-parallel over the inner width)."""
    y = (y + xc.float() * params["D"]).to(x.dtype)
    y = y * torch.nn.functional.silu(z)
    out = y @ params["out_proj"].to(x.dtype)
    return out if tp is None else tp.row_parallel(out, tp.di is not None)


def mamba(params: Params, x: torch.Tensor, cfg: ArchConfig,
          opts: ModelOptions):
    """Full-sequence Mamba-1 layer (``layers.py:939``). Under ``scan_impl
    == "kernel"`` the scan is the kernel wrapper; under "ref" its plain
    version. Returns (the output, the scan's final state (B,di,ds) f32, the
    conv state (B,d_conv-1,di) in x's dtype, di this rank's channels): the
    serving prefill's (``transformer.py:741-752``)."""
    dt, A, Bv, Cv, xc, z, conv_state = _mamba_gates(params, x, cfg,
                                                    tp=opts.tp)
    if opts.scan_impl == "kernel":
        from repro_torch.kernels import ops as kops
        y, h_last = kops.mamba_scan(xc, dt, A, Bv.contiguous(),
                                    Cv.contiguous())
    else:
        y, h_last = mamba_scan_ref(xc, dt, A, Bv, Cv)
    return _mamba_out(params, y, xc, z, x, opts.tp), h_last, conv_state


def mamba_decode(params: Params, x: torch.Tensor, cache: Params,
                 cfg: ArchConfig, tp=None) -> torch.Tensor:
    """One-token Mamba step (``layers.py:948``), plain PyTorch in both
    packages. cache: {"conv": (B,d_conv-1,di), "ssm": (B,di,ds) f32, ...}
    (di this rank's channels under ``tp``); both are updated in place,
    every row at its own step."""
    dt, A, Bv, Cv, xc, z, new_conv = _mamba_gates(params, x, cfg,
                                                  conv_state=cache["conv"],
                                                  tp=tp)
    a, bx = _mamba_discretize(xc, dt, A, Bv)
    h = cache["ssm"] * a[:, 0] + bx[:, 0]                    # (B,di,ds)
    y = torch.einsum("bdn,bn->bd", h, Cv[:, 0].float())[:, None]
    cache["conv"].copy_(new_conv)
    cache["ssm"].copy_(h)
    return _mamba_out(params, y, xc, z, x, tp)


# ---------------------------------------------------------------------------
# RWKV-6 time mix (layers.py:966-1118)
# ---------------------------------------------------------------------------

def _rwkv_gates(params: Params, x: torch.Tensor, shifted: torch.Tensor,
                cfg: ArchConfig, tp=None):
    """The token-shift mixes and the projections (``layers.py:991``): r, k,
    v (B,S,nh,hd) and the gate g (B,S,nh·hd) in x's dtype, and the decay
    w = exp(-exp(wlog)) in (0, 1), float32, wlog formed in x's dtype. nh
    is this rank's heads (``u``'s rows): under tensor parallelism over the
    heads (``tp.rwkv``) every projection is column-parallel, so x and the
    shifted x enter the model axis (the mixes' gradients, partial, are
    summed over it by the training step)."""
    hd = cfg.rwkv_head_dim
    nh = params["u"].shape[0]                        # this rank's heads
    if tp is not None:
        split = tp.rwkv is not None
        x, shifted = tp.enter(x, split), tp.enter(shifted, split)
    B, S, _ = x.shape

    def mix(name):
        m = params["mix_" + name].to(x.dtype)
        return x * m + shifted * (1 - m)

    r = (mix("r") @ params["wr"].to(x.dtype)).reshape(B, S, nh, hd)
    k = (mix("k") @ params["wk"].to(x.dtype)).reshape(B, S, nh, hd)
    v = (mix("v") @ params["wv"].to(x.dtype)).reshape(B, S, nh, hd)
    g = torch.nn.functional.silu(mix("g") @ params["wg"].to(x.dtype))
    wlog = (mix("w") @ params["ww"].to(x.dtype)
            + params["w_bias"].to(x.dtype))
    w = torch.exp(-torch.exp(wlog.float())).reshape(B, S, nh, hd)
    return r, k, v, g, w


def _rwkv_out(params: Params, y: torch.Tensor, g: torch.Tensor,
              x: torch.Tensor, cfg: ArchConfig, tp=None) -> torch.Tensor:
    """Per-head group norm of the f32 recurrence output (the population
    variance, as ``jnp.var``), the gate, the output projection
    (``layers.py:1073``; row-parallel over the heads)."""
    B, S, _ = x.shape
    hd = cfg.rwkv_head_dim
    yh = y.reshape(B, S, -1, hd)
    mu = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, correction=0)
    yh = (yh - mu) * torch.rsqrt(var + 1e-5)
    y = yh.reshape(B, S, -1) * params["ln_scale"]
    out = (y.to(x.dtype) * g) @ params["wo"].to(x.dtype)
    return out if tp is None else tp.row_parallel(out, tp.rwkv is not None)


def rwkv(params: Params, x: torch.Tensor, shifted: torch.Tensor,
         cfg: ArchConfig, opts: ModelOptions):
    """Full-sequence RWKV-6 time mix (``layers.py:1089``). Under
    ``scan_impl == "kernel"`` the recurrence is the kernel wrapper, fed
    float32 r, k, v (``layers.py:1098``); under "ref" its plain version.
    Returns (the output, the final state (B,nh,hd,hd) f32, nh this rank's
    heads): the serving prefill's, ``rwkv_scan_ref``'s ``S_last`` in JAX
    (``transformer.py:752-762``)."""
    r, k, v, g, w = _rwkv_gates(params, x, shifted, cfg, opts.tp)
    u = params["u"].float()
    if opts.scan_impl == "kernel":
        from repro_torch.kernels import ops as kops
        y, state = kops.rwkv_scan(r.float(), k.float(), v.float(), w, u)
    else:
        y, state = rwkv_scan_ref(r, k, v, w, u)
    return _rwkv_out(params, y, g, x, cfg, opts.tp), state


def rwkv_decode(params: Params, x: torch.Tensor, cache: Params,
                cfg: ArchConfig, tp=None) -> torch.Tensor:
    """One-token RWKV-6 step (``layers.py:1105``), plain PyTorch in both
    packages. cache: {"state": (B,nh,hd,hd) f32 (this rank's heads under
    ``tp``), "shift": (B,1,D), ...}; the state and the shift (x) are
    updated in place, every row at its own step."""
    shifted = cache["shift"].to(x.dtype)
    r, k, v, g, w = _rwkv_gates(params, x, shifted, cfg, tp)
    u = params["u"].float()
    rf, kf, vf, wf = (t.float()[:, 0] for t in (r, k, v, w))
    state = cache["state"]
    kv = kf[..., :, None] * vf[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", rf, state + u[None, :, :, None] * kv)
    state.copy_(wf[..., :, None] * state + kv)
    cache["shift"].copy_(x)
    return _rwkv_out(params, y.reshape(x.shape[0], 1, -1), g, x, cfg, tp)
