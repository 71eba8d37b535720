"""Paged one-token decode attention: the port of
``src/repro/kernels/paged_decode.py`` (Pallas ``paged_decode_attention``,
bodies ``_paged_kernel`` and the fused-dequant ``_paged_kernel_quant``),
written by hand in ``csrc/decode_attention.cu`` on slot decode's split
core.

Every slot's cache is a chain of fixed-size blocks in one pool; the block
table maps each slot's logical blocks to pool rows. The TPU kernel gathered
through a scalar-prefetched table in its BlockSpec index map; the CUDA
kernel resolves each key's pool row itself as it stages the key and
addresses the row in place, so the gathered view is never built. As in
slot decode, the slot's T = nb*bs logical keys are split over
``num_splits`` ranges with an fp32 workspace and a combine launch, and the
wrapper counts one launch per call. Quantized pools (int8 or float8 e4m3
codes with per-(block, KV head) f32 scales ``ks``/``vs``) are staged as
codes and decoded on chip: for fp32 queries ``code * scale`` bit for bit
as the plain version decodes; for bf16 queries the codes go to the tensor
cores as bf16 with the K scale on the score and the V scale on the
probability before P is rounded to bf16
(``tests/test_torch_paged_decode_tiles.py`` holds that contract against
JAX).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.kv_quant import QUANT_DTYPES
from repro_torch.kernels.ref import paged_decode_attention_ref
from repro_torch.kernels.slot_decode import decode_info, num_splits

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
    _build.forward_only("paged_decode_attention", *tensors)
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
    nsplit = num_splits(B, HKV, nb * bs)
    # each split's partial O (B, HQ, nsplit, dh), then its (m, l) pairs
    ws = (torch.empty(B * HQ * nsplit * (dh + 2), dtype=torch.float32,
                      device=q.device) if nsplit > 1 else None)
    dims = [(q, (0, 1)), (kp, (0, 1, 2)), (vp, (0, 1, 2)), (tables, (0,)),
            (valid, (0,)), (o, (0, 1))]
    if quant:
        dims += [(ks, (0,)), (vs, (0,))]
    st = _build.strides(*dims)
    err = _build.library().rt_paged_decode_attention(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        ks.data_ptr() if quant else None, vs.data_ptr() if quant else None,
        tables.data_ptr(), valid.data_ptr(), o.data_ptr(),
        None if ws is None else ws.data_ptr(), B, nb, bs, HQ, HKV, dh,
        nsplit, st, 1.0 / math.sqrt(dh), code,
        _build.KV_CODES[kp.dtype] if quant else -1, _build.stream(q))
    name = "paged_decode_quant" if quant else "paged_decode"
    _build.check(err, f"paged_decode_attention ({name})")
    _build.launches[name] += 1
    return o


def launch_info(dtype: torch.dtype, kv_dtype, G: int, dh: int) -> dict:
    """The split kernel's launch for queries of ``dtype`` over a pool of
    ``kv_dtype`` (None: q's dtype; torch.int8 / torch.float8_e4m3fn), G
    query heads per KV head and head dim ``dh``: its dynamic shared memory
    and how many of its blocks fit on one SM of the current device."""
    kv = -1 if kv_dtype is None else _build.KV_CODES[kv_dtype]
    return decode_info(True, dtype, kv, G, dh)
