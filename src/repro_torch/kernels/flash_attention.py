"""Causal / sliding-window GQA flash attention forward: the port of
``src/repro/kernels/flash_attention.py`` (the Pallas ``_flash_kernel``),
written by hand in ``csrc/flash_attention.cu``.

The TPU wrapper transposed to ``(B, H, S, dh)`` and padded ``dh`` to 128
lanes and ``S`` to whole tiles; the CUDA kernel reads the model's
``(B, S, H, dh)`` layout through its strides and masks the ragged edges
itself, so this wrapper copies nothing. The Pallas backward
(``_flash_bwd``) is not a kernel and serving does not need it.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

MAX_HEAD_DIM = 256


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q:(B,Sq,HQ,dh) k,v:(B,Sk,HKV,dh) -> (B,Sq,HQ,dh)."""
    if not _build.on_cuda(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    B, Sq, HQ, dh = q.shape
    Sk, HKV = k.shape[1], k.shape[2]
    if (k.shape != (B, Sk, HKV, dh) or v.shape != k.shape
            or HQ % HKV or not 1 <= dh <= MAX_HEAD_DIM):
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} (need "
                         f"HQ % HKV == 0 and dh <= {MAX_HEAD_DIM})")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention: q, k, v must share a dtype")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim must be contiguous")
    code = _build.dtype_code(q, "flash_attention")
    o = torch.empty((B, Sq, HQ, dh), dtype=q.dtype, device=q.device)
    st = _build.strides((q, (0, 1, 2)), (k, (0, 1, 2)), (v, (0, 1, 2)),
                        (o, (0, 1, 2)))
    err = _build.library().rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq, Sk,
        HQ, HKV, dh, st, int(causal), int(window), 1.0 / math.sqrt(dh),
        code, _build.stream(q))
    _build.check(err, "flash_attention")
    _build.launches["flash_attention"] += 1
    return o


def launch_info(dtype: torch.dtype, dh: int) -> dict:
    """The CUDA kernel's launch for ``dtype`` at head dim ``dh``: its
    dynamic shared memory and how many of its blocks fit on one SM of the
    current device."""
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = _build.library().rt_flash_info(
        _build.DTYPE_CODES[dtype], dh, ctypes.byref(smem),
        ctypes.byref(blocks))
    _build.check(err, "flash_attention launch info")
    return {"smem_bytes": smem.value, "blocks_per_sm": blocks.value}
