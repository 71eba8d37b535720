"""The Mamba selective scan with its discretization fused: the port of
``src/repro/kernels/mamba_ssm.py`` (the Pallas ``_mamba_kernel``), written
by hand in ``csrc/mamba_scan.cu``.

One thread per (batch row, channel) walks the whole sequence with its
``ds`` states in registers and stores the final state: the serving prefill
takes it for the decode cache (the TPU kernel kept it in VMEM scratch and
dropped it). The TPU wrapper's ``chunk`` and ``di_tile`` were its tiles
along the sequence and the channels (padded to whole tiles) and do not
change the result; the CUDA kernel masks the ragged channel block and
stages its own runs of tokens, so both arguments are dropped.

The kernel keeps the JAX oracles' dtype contract (``kernels/ref.py:114``,
``models/layers.py:880-893``), which is the one JAX serves with: ``dt·x``
is formed in the inputs' dtype and widened after. The Pallas kernel widens
x and dt before the product; in bfloat16 the two differ by that one
rounding.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mamba_scan_ref

MAX_DS = 32


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bv: torch.Tensor, Cv: torch.Tensor):
    """x, dt: (B,S,di); A: (di,ds); Bv, Cv: (B,S,ds) -> (y (B,S,di) f32,
    the final state (B,di,ds) f32). CPU tensors take the plain version;
    CUDA tensors the kernel, which takes contiguous inputs, x, dt, Bv and
    Cv all float32 or all bfloat16, A float32 and 1 <= ds <= 32, and
    raises on anything else."""
    if not _build.on_cuda(x, dt, A, Bv, Cv):
        return mamba_scan_ref(x, dt, A, Bv, Cv)
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"mamba_scan: x and dt must share one (B, S, di) "
                         f"shape; got {tuple(x.shape)}, {tuple(dt.shape)}")
    B, S, di = x.shape
    if A.dim() != 2 or A.shape[0] != di:
        raise ValueError(f"mamba_scan: A must have shape ({di}, ds), got "
                         f"{tuple(A.shape)}")
    ds = A.shape[1]
    if Bv.shape != (B, S, ds) or Cv.shape != (B, S, ds):
        raise ValueError(f"mamba_scan: Bv and Cv must have shape "
                         f"{(B, S, ds)}; got {tuple(Bv.shape)}, "
                         f"{tuple(Cv.shape)}")
    if not 1 <= ds <= MAX_DS or di < 1:
        raise ValueError(f"mamba_scan: the kernel takes state sizes "
                         f"1..{MAX_DS} and di >= 1, got ds {ds}, di {di}")
    if A.dtype != torch.float32 or any(t.dtype != x.dtype
                                       for t in (dt, Bv, Cv)):
        raise TypeError("mamba_scan: the CUDA kernel takes x, dt, Bv and Cv "
                        "in one dtype and A in float32")
    code = _build.dtype_code(x, "mamba_scan")
    if not all(t.is_contiguous() for t in (x, dt, A, Bv, Cv)):
        raise ValueError("mamba_scan: the CUDA kernel takes contiguous inputs")
    y = torch.empty((B, S, di), dtype=torch.float32, device=x.device)
    h_last = torch.empty((B, di, ds), dtype=torch.float32, device=x.device)
    err = _build.library().rt_mamba_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bv.data_ptr(),
        Cv.data_ptr(), y.data_ptr(), h_last.data_ptr(), B, S, di, ds, code,
        _build.stream(x))
    _build.check(err, "mamba_scan")
    _build.launches["mamba_scan"] += 1
    return y, h_last
