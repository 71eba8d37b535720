"""Paged chunked-prefill attention: the port of
``src/repro/kernels/paged_prefill.py`` (Pallas ``paged_prefill_attention``,
body ``_paged_prefill_kernel``), written by hand in
``csrc/paged_attention.cu``.

Each slot's W chunk queries attend over its resident block chain under the
causal mask ``k_pos <= start + w``; the chunk's own K/V is already in the
pool. The TPU kernel kept all W·G query rows of a (slot, KV head) in one
program and transposed q to get them there; the CUDA kernel tiles the rows
over the grid and reads q in its (B, W, HQ, dh) layout through strides.
The quantized variant (``ks``/``vs``, ``_paged_prefill_kernel_quant``) is
not ported yet.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_decode import check_pool, check_unquantized
from repro_torch.kernels.ref import paged_prefill_attention_ref


def paged_prefill_attention(q: torch.Tensor, kp: torch.Tensor,
                            vp: torch.Tensor, tables: torch.Tensor,
                            start: torch.Tensor, ks=None, vs=None
                            ) -> torch.Tensor:
    """q:(B,W,HQ,dh); kp,vp:(P+1,bs,HKV,dh) pools; tables:(B,nb) int32;
    start:(B,) int32 first chunk position per row -> (B,W,HQ,dh)."""
    check_unquantized(ks, vs, "paged_prefill_attention")
    if not _build.on_cuda(q, kp, vp, tables, start):
        return paged_prefill_attention_ref(q, kp, vp, tables, start)
    B, W, HQ, dh = q.shape
    bs, HKV = kp.shape[1], kp.shape[2]
    nb = tables.shape[1]
    check_pool(kp, vp, tables, dh, "paged_prefill_attention")
    if tables.shape[0] != B or start.shape != (B,) or HQ % HKV:
        raise ValueError(f"paged_prefill_attention: bad shapes q "
                         f"{tuple(q.shape)} tables {tuple(tables.shape)} "
                         f"start {tuple(start.shape)} pools "
                         f"{tuple(kp.shape)}")
    if not (q.dtype == kp.dtype == vp.dtype) or start.dtype != torch.int32:
        raise TypeError("paged_prefill_attention: q, kp, vp must share a "
                        "dtype and start must be int32")
    if q.stride(-1) != 1 or not start.is_contiguous():
        raise ValueError("paged_prefill_attention: q's last dim and start "
                         "must be contiguous")
    code = _build.dtype_code(q, "paged_prefill_attention")
    o = torch.empty((B, W, HQ, dh), dtype=q.dtype, device=q.device)
    st = _build.strides((q, (0, 1, 2)), (kp, (0, 1, 2)), (vp, (0, 1, 2)),
                        (tables, (0,)), (o, (0, 1, 2)))
    err = _build.library().rt_paged_prefill_attention(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tables.data_ptr(),
        start.data_ptr(), o.data_ptr(), B, W, nb, bs, HQ, HKV, dh, st,
        1.0 / math.sqrt(dh), code, _build.stream(q))
    _build.check(err, "paged_prefill_attention")
    _build.launches["paged_prefill"] += 1
    return o
