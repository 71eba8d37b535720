"""Plain PyTorch versions of the port's kernels.

Each follows its JAX oracle in ``src/repro/kernels/ref.py`` line for line
(``flash_attention_ref`` :11, ``decode_attention_ref`` :31,
``slot_decode_attention_ref`` :45, ``paged_decode_attention_ref`` :61,
``paged_prefill_attention_ref`` :79, ``rmsnorm_ref`` :108; the paged ones
without the quantized ``ks``/``vs`` path). The wrappers run
them for tensors on the CPU; on the card they are what each kernel is held
against. One rule is the kernels', not the JAX oracles': a decode row with
no valid key gives zeros (the Pallas ``_decode_kernel`` clamps its
denominator at 1e-30) where a ``-inf`` softmax would give NaN.
"""
from __future__ import annotations

import math

import torch


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q:(B,Sq,HQ,dh) k,v:(B,Sk,HKV,dh) -> (B,Sq,HQ,dh). GQA by head grouping."""
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
    return out.reshape(B, Sq, HQ, dh)


def slot_decode_attention_ref(q, k, v, valid, *, scale=None):
    """Every batch row is an independent serving slot with its own validity
    mask. q:(B,HQ,dh); k,v:(B,T,HKV,dh); valid:(B,T) bool -> (B,HQ,dh)."""
    B, HQ, dh = q.shape
    HKV = k.shape[2]
    G = HQ // HKV
    scale = scale or 1.0 / math.sqrt(dh)
    qg = q.reshape(B, HKV, G, dh)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k).float() * scale
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(q.dtype), v)
    out = torch.where(valid.any(-1)[:, None, None, None], out,
                      torch.zeros((), dtype=out.dtype, device=out.device))
    return out.reshape(B, HQ, dh)


def decode_attention_ref(q, k, v, valid, *, scale=None):
    """q:(B,HQ,dh); k,v:(B,T,HKV,dh); valid:(T,) bool mask of live cache
    slots, shared by every row."""
    mask = valid[None].expand(q.shape[0], valid.shape[0])
    return slot_decode_attention_ref(q, k, v, mask, scale=scale)


def gather_pool(pool, tables):
    """(P+1,bs,HKV,dh) pool through (B,nb) tables -> (B, nb*bs, HKV, dh):
    each slot's logical view, block i of the chain at keys i*bs..i*bs+bs-1."""
    B, nb = tables.shape
    return pool[tables.long()].reshape(B, nb * pool.shape[1], *pool.shape[2:])


def paged_decode_attention_ref(q, kp, vp, tables, valid, *, scale=None):
    """Paged decode: gather each slot's logical view through its block
    table, then slot-decode over it (JAX ``ref.py:61``, unquantized).
    q:(B,HQ,dh); kp,vp:(P+1,bs,HKV,dh); tables:(B,nb) int;
    valid:(B,nb*bs) bool -> (B,HQ,dh)."""
    return slot_decode_attention_ref(q, gather_pool(kp, tables),
                                     gather_pool(vp, tables), valid,
                                     scale=scale)


def paged_prefill_attention_ref(q, kp, vp, tables, start, *, scale=None):
    """Paged chunked prefill: gather each slot's logical view, then W
    queries per row under the causal mask ``k_pos <= start + w`` (JAX
    ``ref.py:79``, unquantized). q:(B,W,HQ,dh); kp,vp:(P+1,bs,HKV,dh);
    tables:(B,nb) int; start:(B,) int -> (B,W,HQ,dh). Query rows past a
    row's true chunk length are garbage by contract."""
    B, W, HQ, dh = q.shape
    HKV = kp.shape[2]
    G = HQ // HKV
    scale = scale or 1.0 / math.sqrt(dh)
    kg, vg = gather_pool(kp, tables), gather_pool(vp, tables)
    q_pos = start[:, None].long() + torch.arange(W, device=q.device)[None]
    k_pos = torch.arange(kg.shape[1], device=q.device)
    live = k_pos[None, None, :] <= q_pos[:, :, None]              # (B,W,T)
    qg = q.reshape(B, W, HKV, G, dh)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kg).float() * scale
    s = s.masked_fill(~live[:, None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(q.dtype), vg)
    return out.reshape(B, W, HQ, dh)


def rmsnorm_ref(x, scale, *, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
