"""Plain PyTorch versions of the port's kernels.

Each follows its JAX oracle in ``src/repro/kernels/ref.py`` line for line
(``flash_attention_ref`` :11, ``decode_attention_ref`` :31,
``slot_decode_attention_ref`` :45, ``rmsnorm_ref`` :108). The wrappers run
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


def rmsnorm_ref(x, scale, *, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
