"""Causal / sliding-window GQA flash attention, forward and backward: the
port of ``src/repro/kernels/flash_attention.py`` (the Pallas
``_flash_kernel`` and the ``custom_vjp`` around it), written by hand in
``csrc/flash_attention.cu`` (forward) and ``csrc/flash_attention_bwd.cu``
(backward).

The TPU wrapper transposed to ``(B, H, S, dh)`` and padded ``dh`` to 128
lanes and ``S`` to whole tiles; the CUDA forward reads the model's
``(B, S, H, dh)`` layout through its strides and masks the ragged edges
itself, so this wrapper copies nothing. The Pallas backward
(``_flash_bwd``) is no kernel: it differentiates the chunked jnp
reference. Here it is the hand-written ``flash_attention_bwd``, and
``FlashAttention`` (a ``torch.autograd.Function``) joins the two:
``flash_attention`` takes that path whenever autograd needs a gradient,
so training runs both kernels and serving the forward alone.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref)

MAX_HEAD_DIM = 256
#: the backward kernel pads the head dim to 64 or 128 (every config's:
#: 64, 80, 112, 128)
MAX_BWD_HEAD_DIM = 128


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, window: int) -> torch.Tensor:
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


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        causal: bool = True, window: int = 0):
    """The gradients of ``flash_attention``: q, o, do (B,S,HQ,dh), k, v
    (B,S,HKV,dh) -> (dq, dk, dv) in the inputs' dtype. CPU tensors take the
    plain backward (``flash_attention_bwd_ref``); CUDA tensors the kernel,
    which takes self-attention (Sq == Sk), float32 or bfloat16 and dh <=
    ``MAX_BWD_HEAD_DIM``, and raises on anything else. The kernel's two
    launches count as one call."""
    if not _build.on_cuda(q, k, v, o, do):
        return flash_attention_bwd_ref(q, k, v, do, causal=causal,
                                       window=window)
    B, S, HQ, dh = q.shape
    HKV = k.shape[2]
    if (k.shape != (B, S, HKV, dh) or v.shape != k.shape
            or o.shape != q.shape or do.shape != q.shape or HQ % HKV):
        raise ValueError(f"flash_attention_bwd: bad shapes q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)} (needs "
                         f"self-attention, Sq == Sk, and HQ % HKV == 0)")
    if not 1 <= dh <= MAX_BWD_HEAD_DIM:
        raise ValueError(f"flash_attention_bwd: head dim {dh} above the "
                         f"backward kernel's limit of {MAX_BWD_HEAD_DIM}")
    if len({t.dtype for t in (q, k, v, o, do)}) != 1:
        raise TypeError("flash_attention_bwd: q, k, v, o, do must share a "
                        "dtype")
    code = _build.dtype_code(q, "flash_attention_bwd")
    q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ws = torch.empty((2, B, HQ, S), dtype=torch.float32, device=q.device)
    err = _build.library().rt_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        ws.data_ptr(), B, S, HQ, HKV, dh, int(causal), int(window),
        1.0 / math.sqrt(dh), code, _build.stream(q))
    _build.check(err, "flash_attention_bwd")
    _build.launches["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: the forward kernel, and the
    backward kernel on the saved q, k, v and output (the plain versions of
    both for CPU tensors). The counterpart of JAX's ``custom_vjp``
    (``flash_attention.py:98-128``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        o = _forward(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, o)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q:(B,Sq,HQ,dh) k,v:(B,Sk,HKV,dh) -> (B,Sq,HQ,dh). Through
    ``FlashAttention`` when autograd needs a gradient of q, k or v; the
    forward alone otherwise."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, window)


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


def bwd_launch_info(dtype: torch.dtype, dh: int) -> dict:
    """The backward's two kernels (dq, then dkdv) for ``dtype`` at head dim
    ``dh``: dynamic shared memory and blocks per SM of each."""
    smem, blocks = (ctypes.c_int * 2)(), (ctypes.c_int * 2)()
    err = _build.library().rt_flash_bwd_info(
        _build.DTYPE_CODES[dtype], dh, smem, blocks)
    _build.check(err, "flash_attention_bwd launch info")
    return {"smem_bytes": list(smem), "blocks_per_sm": list(blocks)}
