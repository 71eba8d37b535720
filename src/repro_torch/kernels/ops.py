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
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import slot_decode as _slot


def launch_counts() -> Dict[str, int]:
    """Kernel launches since ``reset_launch_counts`` (keys: ``rmsnorm``,
    ``flash_attention``, ``slot_decode``)."""
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


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-5):
    return _rms.rmsnorm(x, scale, eps=eps)
