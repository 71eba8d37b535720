"""Paged chunked-prefill attention: the port of
``src/repro/kernels/paged_prefill.py`` (Pallas ``paged_prefill_attention``,
bodies ``_paged_prefill_kernel`` and the fused-dequant
``_paged_prefill_kernel_quant``), written by hand in
``csrc/paged_prefill.cu``.

Each slot's W chunk queries attend over its resident block chain under the
causal mask ``k_pos <= start + w``; the chunk's own K/V is already in the
pool. The TPU kernel kept all W·G query rows of a (slot, KV head) in one
program and transposed q to get them there; the CUDA kernel tiles the rows
64 to a block and reads q in its (B, W, HQ, dh) layout through strides.
bf16 queries run on the tensor cores, fp32 queries as register tiles on
the CUDA cores (``csrc/register_tiles.cuh``). Quantized pools
(``ks``/``vs``) launch the fused-dequant variant: for bf16 queries its
arithmetic differs from the plain version's in one place, P is rounded to
bf16 after the V scale is folded in (``tests/test_torch_prefill_tiles.py``
holds that contract against JAX).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_decode import check_pool, check_scales
from repro_torch.kernels.ref import paged_prefill_attention_ref


def paged_prefill_attention(q: torch.Tensor, kp: torch.Tensor,
                            vp: torch.Tensor, tables: torch.Tensor,
                            start: torch.Tensor, ks=None, vs=None
                            ) -> torch.Tensor:
    """q:(B,W,HQ,dh); kp,vp:(P+1,bs,HKV,dh) pools; tables:(B,nb) int32;
    start:(B,) int32 first chunk position per row -> (B,W,HQ,dh) in q's
    dtype. ``ks``/``vs`` (P+1,HKV) f32: the pools are quantized."""
    quant = check_scales(q, kp, vp, ks, vs, "paged_prefill_attention")
    tensors = (q, kp, vp, tables, start) + ((ks, vs) if quant else ())
    if not _build.on_cuda(*tensors):
        return paged_prefill_attention_ref(q, kp, vp, tables, start, ks=ks,
                                           vs=vs)
    _build.forward_only("paged_prefill_attention", *tensors)
    B, W, HQ, dh = q.shape
    bs, HKV = kp.shape[1], kp.shape[2]
    nb = tables.shape[1]
    check_pool(kp, vp, tables, dh, "paged_prefill_attention")
    if tables.shape[0] != B or start.shape != (B,) or HQ % HKV:
        raise ValueError(f"paged_prefill_attention: bad shapes q "
                         f"{tuple(q.shape)} tables {tuple(tables.shape)} "
                         f"start {tuple(start.shape)} pools "
                         f"{tuple(kp.shape)}")
    if start.dtype != torch.int32:
        raise TypeError("paged_prefill_attention: start must be int32")
    if q.stride(-1) != 1 or not start.is_contiguous():
        raise ValueError("paged_prefill_attention: q's last dim and start "
                         "must be contiguous")
    code = _build.dtype_code(q, "paged_prefill_attention")
    o = torch.empty((B, W, HQ, dh), dtype=q.dtype, device=q.device)
    dims = [(q, (0, 1, 2)), (kp, (0, 1, 2)), (vp, (0, 1, 2)), (tables, (0,)),
            (o, (0, 1, 2))]
    lib, scale, stream = _build.library(), 1.0 / math.sqrt(dh), \
        _build.stream(q)
    if quant:
        st = _build.strides(*dims, (ks, (0,)), (vs, (0,)))
        err = lib.rt_paged_prefill_attention_quant(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), ks.data_ptr(),
            vs.data_ptr(), tables.data_ptr(), start.data_ptr(), o.data_ptr(),
            B, W, nb, bs, HQ, HKV, dh, st, scale, code,
            _build.KV_CODES[kp.dtype], stream)
        _build.check(err, "paged_prefill_attention (quantized)")
        _build.launches["paged_prefill_quant"] += 1
        return o
    st = _build.strides(*dims)
    err = lib.rt_paged_prefill_attention(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tables.data_ptr(),
        start.data_ptr(), o.data_ptr(), B, W, nb, bs, HQ, HKV, dh, st, scale,
        code, stream)
    _build.check(err, "paged_prefill_attention")
    _build.launches["paged_prefill"] += 1
    return o


def launch_info(dtype: torch.dtype, kv_dtype, dh: int) -> dict:
    """The CUDA kernel's launch for queries of ``dtype`` over a pool of
    ``kv_dtype`` (None: q's dtype; torch.int8 / torch.float8_e4m3fn) at
    head dim ``dh``: its dynamic shared memory and how many of its blocks
    fit on one SM of the current device."""
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    kv = -1 if kv_dtype is None else _build.KV_CODES[kv_dtype]
    err = _build.library().rt_paged_prefill_info(
        _build.DTYPE_CODES[dtype], kv, dh, ctypes.byref(smem),
        ctypes.byref(blocks))
    _build.check(err, "paged_prefill_attention launch info")
    return {"smem_bytes": smem.value, "blocks_per_sm": blocks.value}
