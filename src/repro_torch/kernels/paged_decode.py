"""Paged one-token decode attention: the port of
``src/repro/kernels/paged_decode.py`` (Pallas ``paged_decode_attention``,
body ``_paged_kernel``), written by hand in ``csrc/paged_attention.cu``.

Every slot's cache is a chain of fixed-size blocks in one pool; the block
table maps each slot's logical blocks to pool rows. The TPU kernel gathered
through a scalar-prefetched table in its BlockSpec index map; the CUDA
kernel reads the table itself and addresses each pool row in place, so the
gathered view is never built. The quantized variant (``ks``/``vs``,
``_paged_kernel_quant``) is not ported yet.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_decode_attention_ref

MAX_HEAD_DIM = 256


def check_unquantized(ks, vs, what: str) -> None:
    """The paged kernels take unquantized pools only, for now."""
    if ks is not None or vs is not None:
        raise NotImplementedError(
            f"{what} with per-block scales (ks/vs, quantized pools) is not "
            "ported yet (ROADMAP kernel item 6, after module item 9: "
            "quantized KV)")


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


def paged_decode_attention(q: torch.Tensor, kp: torch.Tensor,
                           vp: torch.Tensor, tables: torch.Tensor,
                           valid: torch.Tensor, ks=None, vs=None
                           ) -> torch.Tensor:
    """q:(B,HQ,dh); kp,vp:(P+1,bs,HKV,dh) pools (row P is the trash block);
    tables:(B,nb) int32; valid:(B,nb*bs) bool -> (B,HQ,dh)."""
    check_unquantized(ks, vs, "paged_decode_attention")
    if not _build.on_cuda(q, kp, vp, tables, valid):
        return paged_decode_attention_ref(q, kp, vp, tables, valid)
    B, HQ, dh = q.shape
    bs, HKV = kp.shape[1], kp.shape[2]
    nb = tables.shape[1]
    check_pool(kp, vp, tables, dh, "paged_decode_attention")
    if (tables.shape[0] != B or valid.shape != (B, nb * bs)
            or HQ % HKV):
        raise ValueError(f"paged_decode_attention: bad shapes q "
                         f"{tuple(q.shape)} tables {tuple(tables.shape)} "
                         f"valid {tuple(valid.shape)} pools {tuple(kp.shape)}")
    if not (q.dtype == kp.dtype == vp.dtype) or valid.dtype != torch.bool:
        raise TypeError("paged_decode_attention: q, kp, vp must share a "
                        "dtype and valid must be bool")
    if q.stride(-1) != 1 or valid.stride(-1) != 1:
        raise ValueError("paged_decode_attention: the last dim of q and "
                         "valid must be contiguous")
    code = _build.dtype_code(q, "paged_decode_attention")
    o = torch.empty((B, HQ, dh), dtype=q.dtype, device=q.device)
    st = _build.strides((q, (0, 1)), (kp, (0, 1, 2)), (vp, (0, 1, 2)),
                        (tables, (0,)), (valid, (0,)), (o, (0, 1)))
    err = _build.library().rt_paged_decode_attention(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tables.data_ptr(),
        valid.data_ptr(), o.data_ptr(), B, nb, bs, HQ, HKV, dh, st,
        1.0 / math.sqrt(dh), code, _build.stream(q))
    _build.check(err, "paged_decode_attention")
    _build.launches["paged_decode"] += 1
    return o
