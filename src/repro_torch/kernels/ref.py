"""Plain PyTorch versions of the port's kernels.

Each follows its JAX oracle in ``src/repro/kernels/ref.py`` line for line
(``flash_attention_ref`` :11, ``decode_attention_ref`` :31,
``slot_decode_attention_ref`` :45, ``paged_decode_attention_ref`` :61,
``paged_prefill_attention_ref`` :79, ``rmsnorm_ref`` :108). The paged
ones take the quantized pools' per-block scales (``ks``/``vs``), the plain
versions of the fused-dequant kernels. The wrappers run
them for tensors on the CPU; on the card they are what each kernel is held
against. One rule is the kernels', not the JAX oracles': a decode row with
no valid key gives zeros (the Pallas ``_decode_kernel`` clamps its
denominator at 1e-30) where a ``-inf`` softmax would give NaN. And
``moe_route_ref`` repeats the Pallas ``_route_kernel``'s arithmetic
(``moe_route.py:19-36``), not the oracle's (``ref.py:150``).
``rwkv_scan_ref`` (``ref.py:132``) and ``mamba_scan_ref`` (``ref.py:114``)
also return the final state, as the port's kernels do. The two kernels
with a backward have plain backwards here too: ``flash_attention_bwd_ref``
(autograd through ``flash_attention_ref``) and ``rmsnorm_bwd_ref`` (the
analytic derivative).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.kv_quant import dequantize, raw


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        return_lse: bool = False):
    """q:(B,Sq,HQ,dh) k,v:(B,Sk,HKV,dh) -> (B,Sq,HQ,dh). GQA by head
    grouping. With ``return_lse`` also the rows' log-sum-exp of the masked,
    scaled scores, (B,HQ,Sq) float32 (+inf for a row that sees no key, as
    the kernel writes it): the plain version of the forward kernel's
    ``lse`` output."""
    B, Sq, HQ, dh = q.shape
    Sk, HKV = k.shape[1], k.shape[2]
    G = HQ // HKV
    qg = q.reshape(B, Sq, HKV, G, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() / math.sqrt(dh)
    qp = torch.arange(Sq, device=q.device)
    kp = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp[:, None] >= kp[None, :]
    if window > 0:
        mask &= qp[:, None] - kp[None, :] < window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(q.dtype), v)
    out = out.reshape(B, Sq, HQ, dh)
    if not return_lse:
        return out
    lse = torch.logsumexp(s, dim=-1).reshape(B, HQ, Sq)
    return out, lse.masked_fill(lse == float("-inf"), float("inf"))


def flash_attention_bwd_ref(q, k, v, do, *, causal: bool = True,
                            window: int = 0):
    """The plain backward of ``flash_attention_ref``: autograd through it,
    as JAX's ``_flash_bwd`` (``flash_attention.py:110-128``) differentiates
    its chunked jnp reference. do (B,Sq,HQ,dh) -> (dq, dk, dv) in the
    inputs' dtypes; GQA sums dk and dv over each KV head's group."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        o = flash_attention_ref(*leaves, causal=causal, window=window)
        return torch.autograd.grad(o, leaves, do)


def slot_decode_attention_ref(q, k, v, valid, *, scale=None):
    """Every batch row is an independent serving slot with its own validity
    mask. q:(B,HQ,dh); k,v:(B,T,HKV,dh); valid:(B,T) bool -> (B,HQ,dh).
    f32 K/V under a bf16 q (decoded quantized pools) compute in f32, as
    JAX promotes: q widened, p rounded to q's dtype before the product."""
    B, HQ, dh = q.shape
    HKV = k.shape[2]
    G = HQ // HKV
    scale = scale or 1.0 / math.sqrt(dh)
    ct = torch.promote_types(q.dtype, k.dtype)
    qg = q.reshape(B, HKV, G, dh).to(ct)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k.to(ct)).float() * scale
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(q.dtype).to(ct), v.to(ct))
    out = torch.where(valid.any(-1)[:, None, None, None], out,
                      torch.zeros((), dtype=out.dtype, device=out.device))
    return out.reshape(B, HQ, dh).to(q.dtype)


def decode_attention_ref(q, k, v, valid, *, scale=None):
    """q:(B,HQ,dh); k,v:(B,T,HKV,dh); valid:(T,) bool mask of live cache
    slots, shared by every row."""
    mask = valid[None].expand(q.shape[0], valid.shape[0])
    return slot_decode_attention_ref(q, k, v, mask, scale=scale)


def gather_pool(pool, tables, scales=None):
    """(P+1,bs,HKV,dh) pool through (B,nb) tables -> (B, nb*bs, HKV, dh):
    each slot's logical view, block i of the chain at keys i*bs..i*bs+bs-1.
    With ``scales`` (P+1, HKV) the quantized view is decoded to f32 after
    the gather: the same products as decoding the whole pool first (JAX
    ``ref.py:71-73``), for the gathered blocks only."""
    B, nb = tables.shape
    idx = tables.long()
    g = raw(pool)[idx].view(pool.dtype)                 # (B, nb, bs, HKV, dh)
    if scales is not None:
        g = dequantize(g, scales[idx][:, :, None, :, None])
    return g.reshape(B, nb * pool.shape[1], *pool.shape[2:])


def paged_decode_attention_ref(q, kp, vp, tables, valid, *, scale=None,
                               ks=None, vs=None):
    """Paged decode: gather each slot's logical view through its block
    table, then slot-decode over it (JAX ``ref.py:61``). q:(B,HQ,dh);
    kp,vp:(P+1,bs,HKV,dh); tables:(B,nb) int; valid:(B,nb*bs) bool ->
    (B,HQ,dh). ``ks``/``vs`` (P+1,HKV) f32: quantized pools, decoded as
    ``q.float() * s`` (the plain version of the fused-dequant kernel)."""
    return slot_decode_attention_ref(q, gather_pool(kp, tables, ks),
                                     gather_pool(vp, tables, vs), valid,
                                     scale=scale)


def paged_prefill_attention_ref(q, kp, vp, tables, start, *, scale=None,
                                ks=None, vs=None):
    """Paged chunked prefill: gather each slot's logical view, then W
    queries per row under the causal mask ``k_pos <= start + w`` (JAX
    ``ref.py:79``). q:(B,W,HQ,dh); kp,vp:(P+1,bs,HKV,dh); tables:(B,nb)
    int; start:(B,) int -> (B,W,HQ,dh). Query rows past a row's true chunk
    length are garbage by contract. ``ks``/``vs``: quantized pools, as in
    ``paged_decode_attention_ref``."""
    B, W, HQ, dh = q.shape
    HKV = kp.shape[2]
    G = HQ // HKV
    scale = scale or 1.0 / math.sqrt(dh)
    kg, vg = gather_pool(kp, tables, ks), gather_pool(vp, tables, vs)
    ct = torch.promote_types(q.dtype, kg.dtype)
    q_pos = start[:, None].long() + torch.arange(W, device=q.device)[None]
    k_pos = torch.arange(kg.shape[1], device=q.device)
    live = k_pos[None, None, :] <= q_pos[:, :, None]              # (B,W,T)
    qg = q.reshape(B, W, HKV, G, dh).to(ct)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kg.to(ct)).float() * scale
    s = s.masked_fill(~live[:, None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(q.dtype).to(ct), vg.to(ct))
    return out.reshape(B, W, HQ, dh).to(q.dtype)


def rmsnorm_ref(x, scale, *, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_bwd_ref(x, scale, dy, *, eps: float = 1e-5):
    """The analytic derivative of ``rmsnorm_ref`` in fp32: with r =
    rsqrt(mean(x^2) + eps), dx = r (g s - x r^2 mean(g s x)) and dscale =
    sum over rows of g x r, for dy = g. Returns (dx in x's dtype, dscale in
    scale's dtype). JAX's Pallas rmsnorm has no custom VJP; this is the
    derivative its plain form has."""
    xf, g, s = x.float(), dy.float(), scale.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    gs = g * s
    dx = r * (gs - xf * (r * r) * torch.mean(gs * xf, dim=-1, keepdim=True))
    dscale = (g * xf * r).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


NEG_INF = -1e30


def moe_route_ref(x, router, k: int):
    """The Pallas router ``_route_kernel`` (``moe_route.py:19-36``) step for
    step: x (N,D) and router (D,E) cast to f32 before the product (f32
    accumulation), softmax as ``exp(l - max) / sum``, then k rounds of max,
    argmax and a mask to -1e30. ``torch.argmax`` returns the first maximum,
    so ties go to the lowest index, as ``jnp.argmax`` does (``torch.topk``
    guarantees no order). Returns (gates (N,k) f32, idx (N,k) int32)."""
    logits = x.float() @ router.float()
    p = torch.exp(logits - logits.max(dim=-1, keepdim=True).values)
    work = p / p.sum(dim=-1, keepdim=True)
    gates, idx = [], []
    for _ in range(k):
        best = work.max(dim=-1).values
        bidx = torch.argmax(work, dim=-1)
        gates.append(best)
        idx.append(bidx)
        work = work.scatter(-1, bidx[:, None], NEG_INF)
    return (torch.stack(gates, -1),
            torch.stack(idx, -1).to(torch.int32))


def rwkv_scan_ref(r, k, v, w, u):
    """The RWKV-6 time-mix recurrence (JAX ``ref.py:132`` and
    ``layers.py:1009``), one token at a time. r, k, v, w: (B,S,nh,hd), read
    as float32; u: (nh,hd). Per token ``y_t = r_t · (S + uᵀ⊙k_tᵀv_t)``,
    then ``S = w_tᵀ⊙S + k_tᵀv_t``: the decay scales the k axis. Returns
    (y (B,S,nh,hd) f32, the final state (B,nh,hd,hd) f32 indexed [b, h, k,
    v]; zeros when S is 0)."""
    B, S, nh, hd = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    state = torch.zeros((B, nh, hd, hd), dtype=torch.float32,
                        device=r.device)
    ys = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", rf[:, t], state + uf * kv))
        state = wf[:, t, :, :, None] * state + kv
    y = (torch.stack(ys, 1) if ys else
         torch.zeros((B, 0, nh, hd), dtype=torch.float32, device=r.device))
    return y, state


def mamba_scan_ref(x, dt, A, Bv, Cv):
    """The Mamba selective scan with its discretization fused (JAX
    ``ref.py:114`` and ``layers.py:887``), one token at a time. x, dt:
    (B,S,di); A: (di,ds); Bv, Cv: (B,S,ds). Per token ``a = exp(dt·A)``,
    ``bx = (dt·x)·B``, ``h = a·h + bx``, ``y = Σ_n h·C``, all in float32
    but ``dt·x``, which is formed in the inputs' dtype and widened after, as
    both JAX oracles and ``_mamba_discretize`` form it (the Pallas kernel
    widens x and dt first: the two agree in float32 and differ by a bf16
    rounding in bfloat16). Returns (y (B,S,di) f32, the final state
    (B,di,ds) f32; zeros when S is 0)."""
    B, S, di = x.shape
    Af = A.float()
    dtf, bxf = dt.float(), (dt * x).float()
    Bf, Cf = Bv.float(), Cv.float()
    h = torch.zeros((B, di, A.shape[1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(S):
        a = torch.exp(dtf[:, t, :, None] * Af)
        h = a * h + bxf[:, t, :, None] * Bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    y = (torch.stack(ys, 1) if ys else
         torch.zeros((B, 0, di), dtype=torch.float32, device=x.device))
    return y, h
