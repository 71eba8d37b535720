"""Causal / sliding-window GQA flash attention, forward and backward: the
port of ``src/repro/kernels/flash_attention.py`` (the Pallas
``_flash_kernel`` and the ``custom_vjp`` around it), written by hand in
``csrc/flash_attention.cu`` (forward) and ``csrc/flash_attention_bwd.cu``
(backward).

The TPU wrapper transposed to ``(B, H, S, dh)`` and padded ``dh`` to 128
lanes and ``S`` to whole tiles; the CUDA forward reads the model's
``(B, S, H, dh)`` layout through its strides and masks the ragged edges
itself, so this wrapper copies nothing. The Pallas backward
(``_flash_bwd``) is no kernel: it differentiates the chunked jnp
reference. Here it is the hand-written ``flash_attention_bwd``, and
``FlashAttention`` (a ``torch.autograd.Function``) joins the two:
``flash_attention`` takes that path whenever autograd needs a gradient,
so training runs both kernels and serving the forward alone. The
training forward also writes the rows' log-sum-exp
(``flash_attention_with_lse``), which the backward takes instead of
recomputing it; serving asks for none and its output is the same.
"""
from __future__ import annotations

import ctypes
import functools
import heapq
import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_ref)

MAX_HEAD_DIM = 256
#: the head dims the backward kernel is built for (every config's: 64,
#: 80, 112, 128); any other dh up to the last runs the next one with zero
#: columns
BWD_HEAD_DIMS = (64, 80, 112, 128)
MAX_BWD_HEAD_DIM = BWD_HEAD_DIMS[-1]
#: keys a dkdv block (``BKV`` in the source)
BWD_KEYS = 64
#: a dkdv block's cost beyond its steps, in steps: staging its K and V,
#: and in a key tile of several chunks its partial, written and read back
#: by the reduce launch (fitted to the chunk sweep on the H100,
#: ``chip_smoke.py bwd-chunks``: at 2-4 each the chunk picked was within 2 %
#: of the best measured at the training path's and the zoo's shapes)
BWD_BLOCK_STEPS, BWD_PARTIAL_STEPS = 3, 3


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, window: int, with_lse: bool = False):
    if not _build.on_cuda(q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   return_lse=with_lse)
    B, Sq, HQ, dh = q.shape
    Sk, HKV = k.shape[1], k.shape[2]
    if (k.shape != (B, Sk, HKV, dh) or v.shape != k.shape
            or HQ % HKV or not 1 <= dh <= MAX_HEAD_DIM):
        raise ValueError(f"flash_attention: bad shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)} (need "
                         f"HQ % HKV == 0 and dh <= {MAX_HEAD_DIM})")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention: q, k, v must share a dtype")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim must be contiguous")
    code = _build.dtype_code(q, "flash_attention")
    o = torch.empty((B, Sq, HQ, dh), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, HQ, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    st = _build.strides((q, (0, 1, 2)), (k, (0, 1, 2)), (v, (0, 1, 2)),
                        (o, (0, 1, 2)))
    err = _build.library().rt_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), B, Sq, Sk, HQ, HKV, dh, st,
        int(causal), int(window), 1.0 / math.sqrt(dh), code,
        _build.stream(q))
    _build.check(err, "flash_attention")
    _build.launches["flash_attention"] += 1
    return (o, lse) if with_lse else o


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: int = 0):
    """The forward with the rows' log-sum-exp: (o, lse), lse (B, HQ, Sq)
    float32, natural log of the scaled scores' exponentials summed over
    the keys a row sees (+inf for a row that sees none). One forward
    launch; ``o`` equals ``flash_attention``'s bit for bit. CPU tensors
    take the plain version (``flash_attention_ref(..., return_lse=True)``).
    What ``flash_attention_bwd`` takes on the card."""
    return _forward(q, k, v, causal, window, with_lse=True)


class BwdGeometry(NamedTuple):
    dp: int        # the instantiation's head dim (BWD_HEAD_DIMS)
    bqs: int       # queries a dkdv step
    chunk: int     # (head, query tile) steps a dkdv block, at most
    chunks: int    # the key tiles' chunks, summed: dkdv blocks a (b, hk)
    split: bool    # some key tile has several chunks: partials, a reduce
    launches: int  # CUDA launches a call: dq, dkdv and, when split, reduce


def bwd_head_dim(dh: int) -> int:
    """The backward's instantiation for head dim ``dh``."""
    return next(d for d in BWD_HEAD_DIMS if dh <= d)


def bwd_query_step(dtype: torch.dtype, dp: int) -> int:
    """Queries a dkdv step (``DkvTc::BQS`` / ``DkvFma::BQS`` in the
    source): 64 for bf16 up to dh 80, else 32 (the dK and dV accumulators
    of the wider heads leave no registers for more)."""
    return 64 if dtype == torch.bfloat16 and dp <= 80 else 32


def bwd_query_tiles(kt: int, S: int, causal: bool, window: int,
                    bqs: int) -> Tuple[int, int]:
    """The query tiles [x, y) of ``bqs`` rows that see a key of key tile
    ``kt`` (``query_tiles`` in the source): from the tile's first key on
    when causal, up to its last key + window - 1 with a window."""
    k0 = kt * BWD_KEYS
    k_last = min(k0 + BWD_KEYS, S) - 1
    q_lo = k0 if causal else 0
    q_hi = min(S, k_last + window) if window > 0 else S
    x = q_lo // bqs
    return x, (-(-q_hi // bqs) if q_lo < q_hi else x)


def bwd_steps(S: int, G: int, causal: bool, window: int,
              bqs: int) -> List[int]:
    """Each key tile's (head, query tile) steps: G times its query
    tiles."""
    return [G * (y - x) for x, y in (
        bwd_query_tiles(kt, S, causal, window, bqs)
        for kt in range(-(-S // BWD_KEYS)))]


def _bwd_makespan(steps: List[int], bh: int, chunk: int, slots: int) -> float:
    """The dkdv launch's length in steps: its blocks, in launch order (a
    key tile's chunks, each for every (batch, KV head)), each to the slot
    that frees first."""
    costs = []
    for n in steps:
        nch = max(1, -(-n // chunk))
        extra = BWD_BLOCK_STEPS + (BWD_PARTIAL_STEPS if nch > 1 else 0)
        costs += [min(chunk, n - i * chunk) + extra
                  for i in range(nch) for _ in range(bh)]
    if len(costs) <= slots:
        return max(costs)
    free = [0.0] * slots
    for w in costs:
        heapq.heapreplace(free, free[0] + w)
    return max(free)


@functools.lru_cache(maxsize=None)
def bwd_geometry(B: int, S: int, HQ: int, HKV: int, dh: int, causal: bool,
                 window: int, dtype: torch.dtype, slots: int,
                 chunk: Optional[int] = None) -> BwdGeometry:
    """The backward's launch for these shapes; ``slots`` is how many dkdv
    blocks the card holds at once (SMs x blocks an SM). A key tile's steps
    are cut into chunks of at most ``chunk`` (a tile of no step still
    takes one, which writes zeros). Candidates: the steps over 1-8 waves of
    the slots, and the longest tile's steps over 1-8; taken, the one whose
    simulated dispatch (``_bwd_makespan``) ends first, the larger on a
    tie. Small chunks balance the causal triangle but each block costs
    BWD_BLOCK_STEPS more and each split tile's BWD_PARTIAL_STEPS. A given
    ``chunk`` is taken as it is (the measurement of the trade-off)."""
    dp = bwd_head_dim(dh)
    bqs = bwd_query_step(dtype, dp)
    steps = bwd_steps(S, HQ // HKV, causal, window, bqs)
    bh = B * HKV
    if chunk is None:
        cands = {max(1, -(-bh * sum(steps) // (w * slots))) for w in
                 range(1, 9)} | {max(1, -(-max(steps) // k)) for k in
                                 range(1, 9)}
        chunk = min(cands, key=lambda c: (
            _bwd_makespan(steps, bh, c, slots), -c))
    per = [max(1, -(-n // chunk)) for n in steps]
    split = any(p > 1 for p in per)
    return BwdGeometry(dp, bqs, chunk, sum(per), split, 3 if split else 2)


@functools.lru_cache(maxsize=None)
def _bwd_slots(dtype: torch.dtype, dp: int, device: int) -> int:
    blocks = bwd_launch_info(dtype, dp)["blocks_per_sm"][1]
    if blocks < 1:
        raise RuntimeError(f"flash_attention_bwd: the dkdv kernel for "
                           f"{dtype} dh {dp} fits no SM")
    return _build._sm_count(device) * blocks


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor,
                        lse: torch.Tensor = None, *, causal: bool = True,
                        window: int = 0, _chunk: Optional[int] = None):
    """The gradients of ``flash_attention``: q, o, do (B,S,HQ,dh), k, v
    (B,S,HKV,dh), lse (B,HQ,S) float32 from ``flash_attention_with_lse``
    -> (dq, dk, dv) in the inputs' dtype. CPU tensors take the plain
    backward (``flash_attention_bwd_ref``, which needs no lse); CUDA
    tensors the kernel, which takes self-attention (Sq == Sk), float32 or
    bfloat16, dh <= ``MAX_BWD_HEAD_DIM`` and the forward's lse, and raises
    on anything else (it never recomputes a missing lse). The kernel's
    CUDA launches (``bwd_geometry(...).launches``) count as one call.
    ``_chunk`` forces the dkdv chunk (``bwd_geometry``'s), for measuring
    the trade-off."""
    if not _build.on_cuda(q, k, v, o, do):
        return flash_attention_bwd_ref(q, k, v, do, causal=causal,
                                       window=window)
    B, S, HQ, dh = q.shape
    HKV = k.shape[2]
    if (k.shape != (B, S, HKV, dh) or v.shape != k.shape
            or o.shape != q.shape or do.shape != q.shape or HQ % HKV):
        raise ValueError(f"flash_attention_bwd: bad shapes q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)} (needs "
                         f"self-attention, Sq == Sk, and HQ % HKV == 0)")
    if not 1 <= dh <= MAX_BWD_HEAD_DIM:
        raise ValueError(f"flash_attention_bwd: head dim {dh} above the "
                         f"backward kernel's limit of {MAX_BWD_HEAD_DIM}")
    if len({t.dtype for t in (q, k, v, o, do)}) != 1:
        raise TypeError("flash_attention_bwd: q, k, v, o, do must share a "
                        "dtype")
    if lse is None:
        raise ValueError("flash_attention_bwd: the CUDA kernel takes the "
                         "forward's row log-sum-exp (flash_attention_with_"
                         "lse); none was given")
    if (lse.shape != (B, HQ, S) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError(f"flash_attention_bwd: lse must be ({B}, {HQ}, {S})"
                         f" float32 on {q.device}, got {tuple(lse.shape)} "
                         f"{lse.dtype} on {lse.device}")
    code = _build.dtype_code(q, "flash_attention_bwd")
    q, k, v, o, do, lse = (t.contiguous() for t in (q, k, v, o, do, lse))
    dp = bwd_head_dim(dh)
    g = bwd_geometry(B, S, HQ, HKV, dh, causal, window, q.dtype,
                     _bwd_slots(q.dtype, dp, q.device.index
                                if q.device.index is not None
                                else torch.cuda.current_device()),
                     chunk=_chunk)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # delta (B*HQ*S floats, rounded up to 4), then the chunks' partials
    n_delta = -(-B * HQ * S // 4) * 4
    n_part = 2 * g.chunks * B * HKV * BWD_KEYS * dp if g.split else 0
    ws = torch.empty(n_delta + n_part, dtype=torch.float32, device=q.device)
    err = _build.library().rt_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), ws.data_ptr(), B, S, HQ, HKV, dh, int(causal),
        int(window), 1.0 / math.sqrt(dh), g.chunk, g.chunks, code,
        _build.stream(q))
    _build.check(err, "flash_attention_bwd")
    _build.launches["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: the forward kernel (writing the
    rows' log-sum-exp), and the backward kernel on the saved q, k, v,
    output and lse (the plain versions of both for CPU tensors). The
    counterpart of JAX's ``custom_vjp`` (``flash_attention.py:98-128``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        o, lse = _forward(q, k, v, causal, window, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse,
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q:(B,Sq,HQ,dh) k,v:(B,Sk,HKV,dh) -> (B,Sq,HQ,dh). Through
    ``FlashAttention`` when autograd needs a gradient of q, k or v; the
    forward alone otherwise."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, window)


def launch_info(dtype: torch.dtype, dh: int) -> dict:
    """The CUDA kernel's launch for ``dtype`` at head dim ``dh``: its
    dynamic shared memory and how many of its blocks fit on one SM of the
    current device."""
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = _build.library().rt_flash_info(
        _build.DTYPE_CODES[dtype], dh, ctypes.byref(smem),
        ctypes.byref(blocks))
    _build.check(err, "flash_attention launch info")
    return {"smem_bytes": smem.value, "blocks_per_sm": blocks.value}


def bwd_launch_info(dtype: torch.dtype, dh: int) -> dict:
    """The backward's dq and dkdv kernels for ``dtype`` at head dim ``dh``:
    dynamic shared memory and blocks per SM of each."""
    smem, blocks = (ctypes.c_int * 2)(), (ctypes.c_int * 2)()
    err = _build.library().rt_flash_bwd_info(
        _build.DTYPE_CODES[dtype], dh, smem, blocks)
    _build.check(err, "flash_attention_bwd launch info")
    return {"smem_bytes": list(smem), "blocks_per_sm": list(blocks)}
