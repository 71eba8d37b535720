"""Slot-aware one-token decode attention: the port of
``src/repro/kernels/slot_decode.py`` (Pallas ``slot_decode_attention`` with
the ``decode_attention.py:_decode_kernel`` body), written by hand in
``csrc/decode_attention.cu``.

Every batch row is an independent serving slot with its own ``(T,)``
validity mask. The TPU wrapper transposed the cache to ``(B, HKV, T, dh)``
and padded T and dh; the CUDA kernel reads the engine's ``(B, T, HKV, dh)``
cache in place through its strides.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import slot_decode_attention_ref

MAX_HEAD_DIM = 256


def slot_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
    """q:(B,HQ,dh); k,v:(B,T,HKV,dh); valid:(B,T) bool -> (B,HQ,dh)."""
    if not _build.on_cuda(q, k, v, valid):
        return slot_decode_attention_ref(q, k, v, valid)
    B, HQ, dh = q.shape
    T, HKV = k.shape[1], k.shape[2]
    if (k.shape != (B, T, HKV, dh) or v.shape != k.shape
            or valid.shape != (B, T) or HQ % HKV
            or not 1 <= dh <= MAX_HEAD_DIM):
        raise ValueError(f"slot_decode_attention: bad shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} valid {tuple(valid.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or valid.dtype != torch.bool:
        raise TypeError("slot_decode_attention: q, k, v must share a dtype "
                        "and valid must be bool")
    if (any(t.stride(-1) != 1 for t in (q, k, v))
            or valid.stride(-1) != 1):
        raise ValueError("slot_decode_attention: the last dim of q, k, v "
                         "and valid must be contiguous")
    code = _build.dtype_code(q, "slot_decode_attention")
    o = torch.empty((B, HQ, dh), dtype=q.dtype, device=q.device)
    st = _build.strides((q, (0, 1)), (k, (0, 1, 2)), (v, (0, 1, 2)),
                        (valid, (0,)), (o, (0, 1)))
    err = _build.library().rt_slot_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        o.data_ptr(), B, T, HQ, HKV, dh, st, 1.0 / math.sqrt(dh), code,
        _build.stream(q))
    _build.check(err, "slot_decode_attention")
    _build.launches["slot_decode"] += 1
    return o
