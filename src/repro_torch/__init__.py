"""PyTorch/CUDA port of the repro package, for NVIDIA Hopper (H100).

The package mirrors ``src/repro``'s layout module for module, so each piece
has its JAX counterpart at the same path; the JAX package is the reference
it is tested against. It imports ``torch`` and never ``jax`` or ``repro``.
Entry points run on ``cuda`` unless the caller asks for the CPU; asking for
``cuda`` without a GPU raises (``resolve_device``). Every Pallas TPU kernel
on the serving path is a CUDA kernel written by hand in ``csrc/``.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. ``cuda`` without a GPU raises —
    the port never carries on on the CPU unless asked to. On the GPU, TF32
    is switched off for matmuls and convolutions: the JAX reference
    computes in float32."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' (--device cpu) to run on the "
                "CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"the port runs on 'cuda' or 'cpu', not {device!r}")
    return dev
