"""Threefry-2x32 key chains in integer torch ops: the part of
``jax.random`` the serving sampler uses (``PRNGKey``, ``fold_in``,
``split``, 32-bit ``random_bits``, ``uniform``, ``gumbel``,
``categorical``), bit for bit as jax computes them with
``jax_threefry_partitionable`` on (its default since jax 0.5), on the CPU
and on CUDA alike.

A key is a tensor ``(..., 2)`` of int64 holding the two uint32 words of
jax's raw ``uint32[2]`` key: torch has few uint32 ops on CUDA, so every
word lives in an int64 masked back to 32 bits after each add and rotate.
Leading dimensions of a key are a batch: ``random_bits(keys (B, 2),
(V,))`` draws (B, V), each row under its own key, as ``jax.vmap`` does.

The counterparts are ``jax._src.prng``: ``threefry_seed``,
``_threefry2x32_lowering``, ``iota_2x32_shape``,
``_threefry_split_foldlike``, ``_threefry_fold_in`` and
``_threefry_random_bits_partitionable``; and ``jax._src.random``:
``_uniform`` and ``_gumbel`` (mode "low").
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

MASK = 0xFFFFFFFF
#: threefry's rotation constants, alternating by round group
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: the key-schedule parity constant
PARITY = 0x1BD11BDA
#: float32's smallest normal (``jnp.finfo(float32).tiny``): the uniform's
#: lower bound under the Gumbel draw
TINY = torch.finfo(torch.float32).tiny


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The Threefry-2x32 hash of the counter pairs (x1, x2) under the key
    (k1, k2), 20 rounds (``_threefry2x32_lowering``). Every operand is an
    int64 tensor of uint32 words; they broadcast. Returns (y1, y2), new
    tensors of the broadcast shape. The rounds work in place on them: at
    an engine's widths the draw is a few hundred elementwise launches, and
    fresh tensors for each would only add allocation."""
    ks = (k1, k2, k1 ^ k2 ^ PARITY)
    x1 = (x1 + k1).bitwise_and_(MASK)
    x2 = (x2 + k2).bitwise_and_(MASK)
    x1, x2 = torch.broadcast_tensors(x1, x2)
    x1, x2 = x1.contiguous(), x2.contiguous()
    hi = torch.empty_like(x2)
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x1.add_(x2).bitwise_and_(MASK)
            torch.bitwise_left_shift(x2, r, out=hi).bitwise_and_(MASK)
            x2.bitwise_right_shift_(32 - r).bitwise_or_(hi).bitwise_xor_(x1)
        x1.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x2.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(MASK)
    return x1, x2


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words (seed >> 32, seed & MASK) —
    (0, seed) for a 32-bit seed (``threefry_seed``). Made on ``device``
    without a copy from the host."""
    return torch.stack([
        torch.full((), (int(seed) >> 32) & MASK, dtype=torch.int64,
                   device=device),
        torch.full((), int(seed) & MASK, dtype=torch.int64, device=device)])


def _hash_counts(key: torch.Tensor, lo: torch.Tensor):
    """Hash the counters (0, lo) — ``iota_2x32_shape``'s high and low
    words of a flat index below 2**32 — under each key of ``key (..., 2)``:
    returns (bits1, bits2) of shape ``key.shape[:-1] + lo.shape``."""
    extra = (1,) * lo.dim()
    k1 = key[..., 0].reshape(key.shape[:-1] + extra)
    k2 = key[..., 1].reshape(key.shape[:-1] + extra)
    return threefry2x32(k1, k2, torch.zeros_like(lo), lo)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the seed words of
    ``data``, (0, data), under ``key`` (``_threefry_fold_in``)."""
    lo = torch.full((), int(data) & MASK, dtype=torch.int64,
                    device=key.device)
    b1, b2 = _hash_counts(key, lo)
    return torch.stack([b1, b2], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: key ``(..., 2)`` -> ``(..., num,
    2)``, new key i the hash of counter i (``_threefry_split_foldlike``)."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = _hash_counts(key, lo)
    return torch.stack([b1, b2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits for each element of ``shape`` under each key of
    ``key (..., 2)``: the hash of the element's flat index, its two words
    xor-ed (``_threefry_random_bits_partitionable``). Returns int64 words
    of shape ``key.shape[:-1] + shape``."""
    n = 1
    for d in shape:
        n *= int(d)
    lo = torch.arange(n, dtype=torch.int64, device=key.device).reshape(
        tuple(shape))
    b1, b2 = _hash_counts(key, lo)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: the top 23 bits as the mantissa
    of a float in [1, 2), minus 1, scaled to [minval, maxval) and clamped
    below at minval (``_uniform``)."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)   # in float32, as jax forms it
    return torch.clamp_min(floats * span + float(lo), float(lo))


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low") in float32: -log(-log(u)), u
    uniform on [tiny, 1)."""
    return -torch.log(-torch.log(uniform(key, shape, minval=TINY)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis (the Gumbel-max
    trick): argmax(logits + gumbel), the first index on ties. ``key``
    (B, 2) and ``logits`` (B, V) draw one token a row."""
    noise = gumbel(key, logits.shape[-1:])
    return torch.argmax(logits + noise, dim=-1)
