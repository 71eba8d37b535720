"""The RWKV-6 time-mix recurrence: the port of ``src/repro/kernels/rwkv6.py``
(the Pallas ``_rwkv_kernel``), written by hand in ``csrc/rwkv_scan.cu``.

One thread block per (batch, head) walks the whole sequence with the
(hd, hd) state in registers, one value column per thread, and stores the
final state: the serving prefill takes it for the decode cache (the TPU
kernel kept it in VMEM scratch and dropped it). The TPU wrapper's
``chunk`` was its tile along the sequence and does not change the result;
the CUDA kernel stages its own runs of tokens, so the argument is dropped.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rwkv_scan_ref

MAX_HD = 128


def rwkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor):
    """r, k, v, w: (B,S,nh,hd); u: (nh,hd) -> (y (B,S,nh,hd) f32, the final
    state (B,nh,hd,hd) f32 [b, h, k, v]). CPU tensors take the plain
    version; CUDA tensors the kernel, which takes contiguous float32 inputs
    and hd <= 128 and raises on anything else."""
    if not _build.on_cuda(r, k, v, w, u):
        return rwkv_scan_ref(r, k, v, w, u)
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"rwkv_scan: r, k, v, w must share one (B, S, nh, "
                         f"hd) shape; got {[tuple(t.shape) for t in (r, k, v, w)]}")
    B, S, nh, hd = r.shape
    if u.shape != (nh, hd):
        raise ValueError(f"rwkv_scan: u must have shape ({nh}, {hd}), got "
                         f"{tuple(u.shape)}")
    if not 1 <= hd <= MAX_HD:
        raise ValueError(f"rwkv_scan: the kernel takes head dims 1..{MAX_HD}, "
                         f"got {hd}")
    if any(t.dtype != torch.float32 for t in (r, k, v, w, u)):
        raise TypeError("rwkv_scan: the CUDA kernel takes float32 r, k, v, w "
                        "and u (the layer casts them, as layers.py:1098 does)")
    if not all(t.is_contiguous() for t in (r, k, v, w, u)):
        raise ValueError("rwkv_scan: the CUDA kernel takes contiguous inputs")
    y = torch.empty_like(r)
    state = torch.empty((B, nh, hd, hd), dtype=torch.float32,
                        device=r.device)
    err = _build.library().rt_rwkv_scan(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        y.data_ptr(), state.data_ptr(), B, S, nh, hd, _build.stream(r))
    _build.check(err, "rwkv_scan")
    _build.launches["rwkv_scan"] += 1
    return y, state
