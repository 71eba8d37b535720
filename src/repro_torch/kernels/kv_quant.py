"""Per-block symmetric KV quantization: the ``kv_dtype`` axis of the paged
cache (``src/repro/kernels/kv_quant.py``).

One f32 scale per (block, KV head), kept in ``"ks"``/``"vs"`` tensors of
shape (P+1, HKV) beside each layer's (P+1, bs, HKV, dh) ``"kp"``/``"vp"``
pools. Quantization is symmetric (no zero point):

  int8   q = round(x / s) in [-127, 127],  s = amax / 127  (half to even)
  fp8    q = cast_e4m3(x / s),             s = amax / 448  (e4m3 max normal)

``kv_dtype == "bf16"`` is the uncompressed control: the pools store the
activation dtype (fp32 in the port's launcher) and the cache carries no
scale tensors, so every write path takes its unquantized branch.

A write requantizes at *block* granularity: the touched blocks are decoded,
the new tokens inserted, a fresh per-head amax taken over the whole block,
and the block re-encoded under it. Untouched blocks keep their bytes and
scales exactly. This module is plain PyTorch, as the JAX module is plain
jnp; the fused-dequant attention kernels that read the pools are
``paged_decode`` and ``paged_prefill``.

The 1-byte pools are indexed, copied and selected through their raw-byte
view (``raw``), which every device supports for float8 too; only the
conversions to and from f32 touch the float8 type.
"""
from __future__ import annotations

import torch

#: the ``kv_dtype`` axis of the paged backend ("bf16" = uncompressed control)
KV_DTYPES = ("bf16", "int8", "fp8")

#: largest representable magnitude per quantized storage format
_QMAX = {"int8": 127.0, "fp8": 448.0}

#: the quantized storage dtypes
QUANT_DTYPES = (torch.int8, torch.float8_e4m3fn)


def storage_dtype(kv_dtype: str, base_dtype: torch.dtype) -> torch.dtype:
    """The pool element dtype for a ``kv_dtype`` mode (``base_dtype`` is the
    engine's activation dtype, what the uncompressed control stores)."""
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"unknown kv_dtype {kv_dtype!r}; known: {KV_DTYPES}")
    if kv_dtype == "bf16":
        return base_dtype
    return torch.int8 if kv_dtype == "int8" else torch.float8_e4m3fn


def qmax(kv_dtype: str) -> float:
    return _QMAX[kv_dtype]


def qmax_of(dtype: torch.dtype) -> float:
    """``qmax`` keyed by a concrete storage dtype (the write paths see only
    the pool's dtype, not the mode string)."""
    return 127.0 if dtype == torch.int8 else 448.0


def raw(t: torch.Tensor) -> torch.Tensor:
    """The raw-byte view of a float8 tensor (the tensor itself otherwise):
    gathers, scatters, copies and selections on it move exact bits."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def quantize(x: torch.Tensor, scale: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """Encode f32 ``x`` under broadcastable ``scale`` into ``dtype``."""
    m = qmax_of(dtype)
    y = torch.clamp(x / scale, -m, m)
    if dtype == torch.int8:
        y = torch.round(y)
    return y.to(dtype)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Decode a quantized tile: f32 values ``q * scale``."""
    return q.float() * scale


def block_scales(amax: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Per-(block, head) scales from per-(block, head) amax; all-zero blocks
    get scale 1.0 so decode stays division-free and NaN-free."""
    return torch.where(amax > 0, amax / qmax_of(dtype), 1.0).float()


def dequantize_pool(pool: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Whole-pool decode: pool (P+1, bs, HKV, dh) x scales (P+1, HKV)."""
    return dequantize(pool, scales[:, None, :, None])


def quant_insert(pool: torch.Tensor, scales: torch.Tensor, blk: torch.Tensor,
                 off: torch.Tensor, vals: torch.Tensor) -> None:
    """Write ``vals`` at flat pool positions ``(blk, off)`` with block-level
    requantization, in place: the quantized counterpart of
    ``pool[blk, off] = vals``, bit-exact with the JAX ``quant_insert``.

    pool: (P+1, bs, HKV, dh) int8 or float8_e4m3fn; scales: (P+1, HKV) f32;
    blk/off: matching integer index shapes ((B,) decode, (B, W) chunk, (S,)
    admission scatter); vals: blk.shape + (HKV, dh). Only blocks named in
    ``blk`` are re-encoded; every other block keeps its bytes and scale.

    Destinations repeat only on the trash row (dead slots, chunk padding):
    which of those writes wins is unspecified, and harmless, because the
    trash row is never read as live. The whole-pool form (decode, insert,
    mark the touched blocks by a scatter, requantize, select) keeps the
    update free of host syncs, as the K microsteps of an L3 program need.
    """
    poolf = dequantize_pool(pool, scales)
    blk, off = blk.long(), off.long()
    poolf[blk, off] = vals.float()
    touched = torch.zeros(pool.shape[0], dtype=torch.bool, device=pool.device)
    touched[blk] = True
    amax = poolf.abs().amax(dim=(1, 3))                        # (P+1, HKV)
    new_s = torch.where(touched[:, None], block_scales(amax, pool.dtype),
                        scales)
    q = quantize(poolf, new_s[:, None, :, None], pool.dtype)
    raw(pool).copy_(torch.where(touched[:, None, None, None], raw(q),
                                raw(pool)))
    scales.copy_(new_s)
