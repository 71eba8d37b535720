"""Slot-aware one-token decode attention: the port of
``src/repro/kernels/slot_decode.py`` (Pallas ``slot_decode_attention`` with
the ``decode_attention.py:_decode_kernel`` body), written by hand in
``csrc/decode_attention.cu``.

Every batch row is an independent serving slot with its own ``(T,)``
validity mask. The TPU wrapper transposed the cache to ``(B, HKV, T, dh)``
and padded T and dh; the CUDA kernel reads the engine's ``(B, T, HKV, dh)``
cache in place through its strides.

On the TPU the grid walked T in order. On the card the cache is split over
T (flash-decoding): ``num_splits`` picks how many key ranges each (slot,
KV head) is cut into, each split writes its partial output, running max
and sum to an fp32 workspace allocated here, and a second launch merges
them. The wrapper still counts one launch per call.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import slot_decode_attention_ref

MAX_HEAD_DIM = 256
#: the H100's streaming multiprocessors: the splits aim to give each a block
SMS = 132
#: keys a split takes at least (where T allows) and at most (the kernel's
#: bit mask of a split's valid keys: ``MAX_SPLIT_KEYS`` in the source)
MIN_SPLIT_KEYS, MAX_SPLIT_KEYS = 256, 4096


def num_splits(B: int, HKV: int, T: int) -> int:
    """How many key ranges each (slot, KV head) of a ``(B, T, HKV, dh)``
    cache is split into: enough that the B*HKV (slot, KV head) pairs give
    every SM a block, at least ``MIN_SPLIT_KEYS`` keys a split where T
    allows, at most ``MAX_SPLIT_KEYS``. At least 1; at most T (for T >= 1),
    so that every split ``[s*T//n, (s+1)*T//n)`` is non-empty. (More blocks
    than one wave measured slower on the H100: ``PERF.md``.)"""
    if T <= 0:
        return 1
    n = -(-SMS // max(1, B * HKV))
    n = min(n, max(1, T // MIN_SPLIT_KEYS))
    return max(n, -(-T // MAX_SPLIT_KEYS))


def slot_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
    """q:(B,HQ,dh); k,v:(B,T,HKV,dh); valid:(B,T) bool -> (B,HQ,dh)."""
    if not _build.on_cuda(q, k, v, valid):
        return slot_decode_attention_ref(q, k, v, valid)
    _build.forward_only("slot_decode_attention", q, k, v)
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
    nsplit = num_splits(B, HKV, T)
    # each split's partial O (B, HQ, nsplit, dh), then its (m, l) pairs
    ws = (torch.empty(B * HQ * nsplit * (dh + 2), dtype=torch.float32,
                      device=q.device) if nsplit > 1 else None)
    st = _build.strides((q, (0, 1)), (k, (0, 1, 2)), (v, (0, 1, 2)),
                        (valid, (0,)), (o, (0, 1)))
    err = _build.library().rt_slot_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
        o.data_ptr(), None if ws is None else ws.data_ptr(), B, T, HQ, HKV,
        dh, nsplit, st, 1.0 / math.sqrt(dh), code, _build.stream(q))
    _build.check(err, "slot_decode_attention")
    _build.launches["slot_decode"] += 1
    return o


def decode_info(paged: bool, dtype: torch.dtype, kv_code: int, G: int,
                dh: int) -> dict:
    """The split kernel's launch over slot rows (``paged`` False, kv_code
    -1) or a block pool of storage ``kv_code`` (-1: q's dtype; else
    ``_build.KV_CODES``): its dynamic shared memory and how many of its
    blocks fit on one SM of the current device."""
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = _build.library().rt_decode_info(
        int(paged), _build.DTYPE_CODES[dtype], kv_code, G, dh,
        ctypes.byref(smem), ctypes.byref(blocks))
    _build.check(err, "decode attention launch info")
    return {"smem_bytes": smem.value, "blocks_per_sm": blocks.value}


def launch_info(dtype: torch.dtype, G: int, dh: int) -> dict:
    """The split kernel's launch for queries of ``dtype``, G query heads per
    KV head and head dim ``dh``: its dynamic shared memory and how many of
    its blocks fit on one SM of the current device."""
    return decode_info(False, dtype, -1, G, dh)
