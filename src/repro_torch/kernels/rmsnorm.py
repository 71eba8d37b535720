"""Fused RMSNorm: the port of ``src/repro/kernels/rmsnorm.py`` (the Pallas
``_rmsnorm_kernel``), written by hand in ``csrc/rmsnorm.cu``.

One device-memory round trip: the fp32 reduction and the scale multiply
happen in registers and only the normalised output is written.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm_ref


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D); scale: (D,) in float32 or bfloat16 (bfloat16
    parameters), widened in the kernel. CPU tensors take the plain version,
    CUDA tensors the kernel."""
    if not _build.on_cuda(x, scale):
        return rmsnorm_ref(x, scale, eps=eps)
    D = x.shape[-1]
    if scale.shape != (D,):
        raise ValueError(f"rmsnorm: scale must have shape ({D},), got "
                         f"{tuple(scale.shape)}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: the CUDA kernel takes contiguous x and "
                         "scale")
    code = _build.dtype_code(x, "rmsnorm")
    scale_code = _build.dtype_code(scale, "rmsnorm (scale)")
    y = torch.empty_like(x)
    err = _build.library().rt_rmsnorm(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(), x.numel() // D, D,
        float(eps), code, scale_code, _build.stream(x))
    _build.check(err, "rmsnorm")
    _build.launches["rmsnorm"] += 1
    return y
