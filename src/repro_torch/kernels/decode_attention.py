"""One-token decode attention with one ``(T,)`` mask for the whole batch:
the port of ``src/repro/kernels/decode_attention.py:decode_attention``.

As in JAX (:55-67) the uniform case is the slot kernel with the shared mask
broadcast over the batch (a stride-0 view: the kernel reads the one row).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.slot_decode import slot_decode_attention


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """q:(B,HQ,dh); k,v:(B,T,HKV,dh); valid:(T,) bool. -> (B,HQ,dh)."""
    mask = valid[None].expand(q.shape[0], valid.shape[0])
    return slot_decode_attention(q, k, v, mask)
