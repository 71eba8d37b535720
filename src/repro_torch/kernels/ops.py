"""The kernels' public wrappers — the UKL "shortcut" entry points of the
port (``src/repro/kernels/ops.py``).

Dispatch is by the device of the tensors a wrapper is given: CPU tensors
run the plain PyTorch version, CUDA tensors launch the hand-written Hopper
kernel — or the call raises. There is no quiet fallback. The decode
validity masks are built here exactly as in the JAX wrappers (:33-58), so
the kernels stay branch-free on positions.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mamba_ssm as _mamba
from repro_torch.kernels import moe_route as _route
from repro_torch.kernels import paged_decode as _paged
from repro_torch.kernels import paged_prefill as _paged_pf
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import rwkv6 as _rwkv
from repro_torch.kernels import slot_decode as _slot


def launch_counts() -> Dict[str, int]:
    """Kernel launches since ``reset_launch_counts`` (keys: ``rmsnorm``,
    ``flash_attention``, ``slot_decode``, ``paged_decode``,
    ``paged_prefill``, the fused-dequant ``paged_decode_quant`` and
    ``paged_prefill_quant``, ``moe_route``, ``rwkv_scan`` and
    ``mamba_scan``)."""
    return dict(_build.launches)


def reset_launch_counts() -> None:
    _build.reset_launches()


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(q, ck, cv, slot_pos, pos, *, window: int = 0):
    """q: (B,1,HQ,dh) fresh query; ck/cv: (B,T,HKV,dh) cache; slot_pos: (T,)
    positions; pos: () current position, shared by the batch."""
    valid = (slot_pos <= pos) & (slot_pos >= 0)
    if window > 0:
        valid &= pos - slot_pos < window
    return _dec.decode_attention(q[:, 0], ck, cv, valid)[:, None]


def slot_decode_attention(q, ck, cv, slot_pos, pos, *, window: int = 0):
    """Slot-aware decode: every batch row is at its own position.

    q: (B,1,HQ,dh) fresh query; ck/cv: (B,T,HKV,dh) slotted cache;
    slot_pos: (B,T) per-slot cache-entry positions; pos: (B,) per-slot
    sequence positions.
    """
    valid = (slot_pos <= pos[:, None]) & (slot_pos >= 0)
    if window > 0:
        valid &= pos[:, None] - slot_pos < window
    return _slot.slot_decode_attention(q[:, 0], ck, cv, valid)[:, None]


def paged_decode_attention(q, kp, vp, tables, pos, ks=None, vs=None):
    """Paged decode: block-table indirection instead of dense slot rows.

    q: (B,1,HQ,dh) fresh query; kp/vp: (P+1,bs,HKV,dh) pools (row P is
    the trash block); tables: (B,nb) int32; pos: (B,) per-slot positions.
    Validity is logical-position order, ``arange(nb*bs) <= pos`` (JAX
    ``ops.py:61-75``): block chains are never circular. ``ks``/``vs``
    (P+1,HKV) f32 mark int8 / fp8 pools: the fused-dequant kernel decodes
    each tile with its block's scale.
    """
    nb, bs = tables.shape[1], kp.shape[1]
    valid = torch.arange(nb * bs, dtype=torch.int32,
                         device=q.device)[None] <= pos[:, None]
    return _paged.paged_decode_attention(q[:, 0], kp, vp, tables, valid,
                                         ks, vs)[:, None]


def paged_prefill_attention(q, kp, vp, tables, start, ks=None, vs=None):
    """Paged chunked prefill: every slot's prompt chunk attends over its
    resident block chain (JAX ``ops.py:78-89``). q: (B,W,HQ,dh) with the
    chunk's own K/V already in the pools; tables: (B,nb) int32; start: (B,)
    first chunk position per row; ``ks``/``vs``: quantized pools, as in
    ``paged_decode_attention``."""
    return _paged_pf.paged_prefill_attention(q, kp, vp, tables,
                                             start.to(torch.int32), ks, vs)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5):
    return _rms.rmsnorm(x, scale, eps=eps)


def moe_route(x: torch.Tensor, router: torch.Tensor, k: int):
    """The MoE router (JAX ``ops.py:112``): x (N,D) in float32 or bfloat16,
    router (D,E) in x's dtype (the layer casts it, as ``layers.py:775``
    does) -> (gates (N,k) f32, idx (N,k) int32)."""
    return _route.moe_route(x, router, k)


def rwkv_scan(r, k, v, w, u):
    """The RWKV-6 time-mix recurrence (JAX ``ops.py:108``): r, k, v, w
    (B,S,nh,hd) in float32 or bfloat16 and u (nh,hd) in either (the
    layer casts them to float32, as ``layers.py:1098`` does; the kernel
    widens them exactly) -> (y (B,S,nh,hd) f32, the final state
    (B,nh,hd,hd) f32). JAX's returns y alone; the final state is what the
    serving prefill keeps. JAX's ``chunk`` was a TPU tile and does not
    change the result; it is not an argument here."""
    return _rwkv.rwkv_scan(r, k, v, w, u)


def mamba_scan(x, dt, A, Bv, Cv):
    """The Mamba selective scan with its discretization fused (JAX
    ``ops.py:103``, ``mamba_scan_fused``): x, dt (B,S,di) and Bv, Cv
    (B,S,ds) in float32 or bfloat16, A (di,ds) float32 -> (y (B,S,di) f32,
    the final state (B,di,ds) f32). JAX's returns y alone; the final state
    is what the serving prefill keeps. ``dt·x`` is formed in the inputs'
    dtype, as JAX's oracles form it. JAX's ``chunk`` and ``di_tile`` were
    TPU tiles and do not change the result; they are not arguments here."""
    return _mamba.mamba_scan(x, dt, A, Bv, Cv)
