"""The MoE router: the port of ``src/repro/kernels/moe_route.py`` (the
Pallas ``_route_kernel``), written by hand in ``csrc/moe_route.cu``.

``x @ router`` in fp32, the softmax and k rounds of max / argmax / mask,
without the (N, E) probabilities ever reaching device memory. The TPU
wrapper padded N to whole ``block_n`` tiles; the CUDA kernel masks the
ragged tile itself, so any N >= 1 works. The router is read through L2 by
every block (it does not fit a Hopper block's shared memory); at small N
the blocks split D, and their partial logits go through a float32 scratch
this wrapper allocates.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import moe_route_ref

MAX_D, MAX_E = 8192, 256
#: the kernel's token tile and D chunk (``TN`` and ``DC`` in the source)
TOKENS_PER_BLOCK, D_CHUNK = 16, 128
#: blocks the D split aims for when the token tiles alone are few: two per
#: SM of an H100
TARGET_BLOCKS = 264


def d_splits(N: int, D: int) -> int:
    """How many slices of D the kernel's blocks split: enough blocks to
    fill the card when N is small, none when the token tiles fill it. The
    count is one the kernel's even split reproduces (its check)."""
    chunks = -(-D // D_CHUNK)
    tiles = -(-N // TOKENS_PER_BLOCK)
    want = min(chunks, max(1, -(-TARGET_BLOCKS // tiles)))
    per = -(-chunks // want)
    return -(-chunks // per)


def moe_route(x: torch.Tensor, router: torch.Tensor, k: int):
    """x: (N,D); router: (D,E) in x's dtype -> (gates (N,k) f32, idx (N,k)
    int32): the top-k softmax probabilities and their experts, ties to the
    lowest index. CPU tensors take the plain version, CUDA tensors the
    kernel."""
    if not _build.on_cuda(x, router):
        return moe_route_ref(x, router, k)
    if x.dim() != 2 or router.dim() != 2 or router.shape[0] != x.shape[1]:
        raise ValueError(f"moe_route: x must be (N, D) and router (D, E); "
                         f"got {tuple(x.shape)} and {tuple(router.shape)}")
    N, D = x.shape
    E = router.shape[1]
    if not (N >= 1 and 1 <= D <= MAX_D and 1 <= E <= MAX_E
            and 1 <= k <= E):
        raise ValueError(f"moe_route: the kernel takes N >= 1, D <= {MAX_D}, "
                         f"E <= {MAX_E} and 1 <= k <= E; got N {N}, D {D}, "
                         f"E {E}, k {k}")
    if x.dtype != router.dtype:
        raise TypeError(f"moe_route: router must be in x's dtype "
                        f"({x.dtype}), got {router.dtype}")
    if not (x.is_contiguous() and router.is_contiguous()):
        raise ValueError("moe_route: the CUDA kernel takes contiguous x and "
                         "router")
    code = _build.dtype_code(x, "moe_route")
    splits = d_splits(N, D)
    gates = torch.empty((N, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((N, k), dtype=torch.int32, device=x.device)
    partial = torch.empty((splits, N, E), dtype=torch.float32,
                          device=x.device)
    err = _build.library().rt_moe_route(
        x.data_ptr(), router.data_ptr(), gates.data_ptr(), idx.data_ptr(),
        partial.data_ptr(), N, D, E, int(k), splits, code, _build.stream(x))
    _build.check(err, "moe_route")
    _build.launches["moe_route"] += 1
    return gates, idx
