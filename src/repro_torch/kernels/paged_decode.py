"""Paged one-token decode attention: the port of
``src/repro/kernels/paged_decode.py`` (Pallas ``paged_decode_attention``,
bodies ``_paged_kernel`` and the fused-dequant ``_paged_kernel_quant``),
written by hand in ``csrc/paged_attention.cu``.

Every slot's cache is a chain of fixed-size blocks in one pool; the block
table maps each slot's logical blocks to pool rows. The TPU kernel gathered
through a scalar-prefetched table in its BlockSpec index map; the CUDA
kernel reads the table itself and addresses each pool row in place, so the
gathered view is never built. Quantized pools (int8 or float8 e4m3 codes
with per-(block, KV head) f32 scales ``ks``/``vs``) launch the
fused-dequant variant, which decodes each key's tile in shared memory.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.kv_quant import QUANT_DTYPES
from repro_torch.kernels.ref import paged_decode_attention_ref

MAX_HEAD_DIM = 256


def check_pool(kp, vp, tables, dh: int, what: str) -> None:
    """Shape, type and stride checks shared by both paged kernels."""
    if vp.shape != kp.shape or kp.dim() != 4 or kp.shape[3] != dh:
        raise ValueError(f"{what}: bad pool shapes kp {tuple(kp.shape)} vp "
                         f"{tuple(vp.shape)} (want (P+1, bs, HKV, {dh}))")
    if tables.dim() != 2 or tables.dtype != torch.int32:
        raise TypeError(f"{what}: tables must be a (B, nb) int32 tensor")
    if (any(t.stride(-1) != 1 for t in (kp, vp, tables))
            or not 1 <= dh <= MAX_HEAD_DIM):
        raise ValueError(f"{what}: the last dim of kp, vp and tables must be "
                         f"contiguous and dh <= {MAX_HEAD_DIM}")


def check_scales(q, kp, vp, ks, vs, what: str) -> bool:
    """Validate the quantization arguments of both paged kernels, on every
    device; True for quantized pools. Unquantized pools share q's dtype and
    take no scales; quantized ones are int8 or float8_e4m3fn codes with
    ``ks``/``vs`` (P+1, HKV) f32 scales, the last dim contiguous."""
    if (ks is None) != (vs is None):
        raise ValueError(f"{what}: pass both ks and vs, or neither")
    if ks is None:
        if not q.dtype == kp.dtype == vp.dtype:
            raise TypeError(f"{what}: unquantized pools must share q's dtype "
                            f"(q {q.dtype}, kp {kp.dtype}, vp {vp.dtype})")
        return False
    if kp.dtype not in QUANT_DTYPES or vp.dtype != kp.dtype:
        raise TypeError(f"{what}: ks/vs mark quantized pools, which hold "
                        f"int8 or float8_e4m3fn (kp {kp.dtype}, vp "
                        f"{vp.dtype})")
    want = (kp.shape[0], kp.shape[2])
    for name, s in (("ks", ks), ("vs", vs)):
        if s.dtype != torch.float32 or tuple(s.shape) != want \
                or s.stride(-1) != 1:
            raise ValueError(f"{what}: {name} must be a float32 {want} "
                             f"tensor with a contiguous last dim (got "
                             f"{s.dtype} {tuple(s.shape)})")
    return True


def paged_decode_attention(q: torch.Tensor, kp: torch.Tensor,
                           vp: torch.Tensor, tables: torch.Tensor,
                           valid: torch.Tensor, ks=None, vs=None
                           ) -> torch.Tensor:
    """q:(B,HQ,dh); kp,vp:(P+1,bs,HKV,dh) pools (row P is the trash block);
    tables:(B,nb) int32; valid:(B,nb*bs) bool -> (B,HQ,dh) in q's dtype.
    ``ks``/``vs`` (P+1,HKV) f32: the pools are quantized (int8 / fp8)."""
    quant = check_scales(q, kp, vp, ks, vs, "paged_decode_attention")
    tensors = (q, kp, vp, tables, valid) + ((ks, vs) if quant else ())
    if not _build.on_cuda(*tensors):
        return paged_decode_attention_ref(q, kp, vp, tables, valid, ks=ks,
                                          vs=vs)
    B, HQ, dh = q.shape
    bs, HKV = kp.shape[1], kp.shape[2]
    nb = tables.shape[1]
    check_pool(kp, vp, tables, dh, "paged_decode_attention")
    if (tables.shape[0] != B or valid.shape != (B, nb * bs)
            or HQ % HKV):
        raise ValueError(f"paged_decode_attention: bad shapes q "
                         f"{tuple(q.shape)} tables {tuple(tables.shape)} "
                         f"valid {tuple(valid.shape)} pools {tuple(kp.shape)}")
    if valid.dtype != torch.bool:
        raise TypeError("paged_decode_attention: valid must be bool")
    if q.stride(-1) != 1 or valid.stride(-1) != 1:
        raise ValueError("paged_decode_attention: the last dim of q and "
                         "valid must be contiguous")
    code = _build.dtype_code(q, "paged_decode_attention")
    o = torch.empty((B, HQ, dh), dtype=q.dtype, device=q.device)
    dims = [(q, (0, 1)), (kp, (0, 1, 2)), (vp, (0, 1, 2)), (tables, (0,)),
            (valid, (0,)), (o, (0, 1))]
    lib, scale, stream = _build.library(), 1.0 / math.sqrt(dh), \
        _build.stream(q)
    if quant:
        st = _build.strides(*dims, (ks, (0,)), (vs, (0,)))
        err = lib.rt_paged_decode_attention_quant(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), ks.data_ptr(),
            vs.data_ptr(), tables.data_ptr(), valid.data_ptr(), o.data_ptr(),
            B, nb, bs, HQ, HKV, dh, st, scale, code,
            _build.KV_CODES[kp.dtype], stream)
        _build.check(err, "paged_decode_attention (quantized)")
        _build.launches["paged_decode_quant"] += 1
        return o
    st = _build.strides(*dims)
    err = lib.rt_paged_decode_attention(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tables.data_ptr(),
        valid.data_ptr(), o.data_ptr(), B, nb, bs, HQ, HKV, dh, st, scale,
        code, stream)
    _build.check(err, "paged_decode_attention")
    _build.launches["paged_decode"] += 1
    return o
