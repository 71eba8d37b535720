"""Int8 gradient compression for the data-parallel reduce
(``src/repro/optim/compress.py``).

Every rank agrees on a per-tensor scale (the max of the ranks' max |x|,
one all-reduce MAX of a scalar), quantizes to int8, gathers every rank's
int8 payload and sums the dequantized payloads locally in fp32. What
crosses the wire is one byte an element a rank, where the fp32 mean
reduce (``psum_mean``) hands the collective four; ``comm.traffic()``
counts both. The error is bounded by the quantization step: at most
1/254 of the tensor's max |x| an element, as JAX's example asserts.

The collectives are ``AxisComm``'s (the data axis of a live mesh), so a
CUDA tensor over gloo works as over NCCL.
"""
from __future__ import annotations

import torch

from repro_torch import tree


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(x / scale) clipped to [-127, 127], int8 (ties to even, as
    ``jnp.round``)."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(
        torch.int8)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum_mean(grads, comm):
    """The mean of ``grads`` (a tree) over ``comm``'s ranks, each leaf
    through int8 payloads: a scale from the ranks' max |x|, every rank's
    codes gathered (``AxisComm.all_gather``, int8), summed in fp32 in
    rank order, times the scale, over the rank count."""
    n = comm.size

    def one(x):
        gmax = comm.max_(torch.max(torch.abs(x.float())).reshape(1))[0]
        scale = torch.clamp(gmax / 127.0, min=1e-30)
        q = quantize(x, scale)
        gathered = comm.all_gather(q[None], 0)            # (n, ...) int8
        total = gathered.float().sum(dim=0) * scale
        return (total / n).to(x.dtype)

    return tree.tree_map(one, grads)


def psum_mean(grads, comm):
    """The uncompressed baseline: an fp32 all-reduce mean a leaf."""
    n = comm.size
    return tree.tree_map(
        lambda x: (comm.sum_(x.float().clone()) / n).to(x.dtype), grads)
