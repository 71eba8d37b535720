"""Fused RMSNorm: the port of ``src/repro/kernels/rmsnorm.py`` (the Pallas
``_rmsnorm_kernel``), written by hand in ``csrc/rmsnorm.cu``.

One device-memory round trip: the row is held in registers between the
fp32 sum of squares and the write, and only the normalised output is
written. ``launch_geometry`` is the one place the launch is decided.
JAX's Pallas rmsnorm has no backward kernel (no custom VJP); for training
``RMSNorm`` (a ``torch.autograd.Function``) runs this kernel forward and
the analytic derivative in plain PyTorch backward (``rmsnorm_bwd_ref``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm_bwd_ref, rmsnorm_ref

#: elements a lane holds before the row spreads over another warp, and the
#: most it may hold once the block has MAX_WARPS warps on the row (the
#: element path: ELEMS // 2): the row and the lane's slice of the scale,
#: widened to fp32, stay within the 128 registers of MAX_WARPS-warp blocks.
#: With fewer rows than SMs (decode) a call is one row's latency, so the
#: lanes hold ELEMS_FEW_ROWS and the row spreads over more warps.
ELEMS_PREFERRED, ELEMS_MOST, ELEMS_FEW_ROWS = 32, 64, 8
#: warps a block holds (``MAX_THREADS`` in the source), and the warps of
#: rows a block aims for when a row takes fewer
MAX_WARPS, BLOCK_WARPS = 16, 8
#: H100 SXM; the wrapper passes the device's own count
SMS = 132


class Geometry(NamedTuple):
    vec: int          # elements a pack: 16 bytes' worth, or 1
    nv: int           # packs a lane holds; 0: the row streams twice
    warps: int        # warps a row
    rows: int         # rows a block
    grid: int         # blocks; each walks row groups grid apart


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def launch_geometry(n_rows: int, D: int, itemsize: int, vector: bool,
                    sms: int = SMS) -> Geometry:
    """The launch for ``n_rows`` rows of D elements of ``itemsize`` bytes:
    16-byte packs when ``vector`` (the pointers aligned and D a multiple of
    the pack), single elements otherwise. A warp owns a row wherever the
    row fits ELEMS_PREFERRED elements a lane (ELEMS_FEW_ROWS when there
    are fewer rows than SMs); wider rows take more warps (one barrier), up
    to MAX_WARPS, then up to ELEMS_MOST a lane; rows wider still stream
    (``nv`` 0). Rows share a block up to BLOCK_WARPS warps, but never so
    many that fewer blocks than SMs (or rows) would run; the grid stops at
    the blocks the SMs hold at once and the blocks loop over the rest."""
    vec = 16 // itemsize if vector else 1
    per = 1 if vector else 2        # the element path holds half as many
    packs = -(-D // vec)
    pref = ELEMS_FEW_ROWS if n_rows < sms else ELEMS_PREFERRED
    warps = min(MAX_WARPS, -(-packs // (32 * max(1, pref // (vec * per)))))
    nv = _pow2(-(-packs // (32 * warps)))
    if nv * vec * per > ELEMS_MOST:
        return Geometry(vec, 0, MAX_WARPS, 1, max(1, min(n_rows, 2 * sms)))
    warps = -(-packs // (32 * nv))     # the fewest warps at nv packs a lane
    rows = max(1, min(BLOCK_WARPS // warps, -(-n_rows // sms)))
    groups = -(-n_rows // rows)
    grid = max(1, min(groups, sms * (2048 // (32 * warps * rows))))
    return Geometry(vec, nv, warps, rows, grid)


class RMSNorm(torch.autograd.Function):
    """rmsnorm with a gradient: the kernel forward (the plain version for
    CPU tensors), the analytic derivative backward, dx in x's dtype."""

    @staticmethod
    def forward(ctx, x, scale, eps: float):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd_ref(x, scale, dy, eps=ctx.eps)
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D); scale: (D,) in float32 or bfloat16 (bfloat16
    parameters), widened in the kernel. CPU tensors take the plain version,
    CUDA tensors the kernel; through ``RMSNorm`` when autograd needs a
    gradient of x or scale."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNorm.apply(x, scale, eps)
    return _forward(x, scale, eps)


def _forward(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    if not _build.on_cuda(x, scale):
        return rmsnorm_ref(x, scale, eps=eps)
    D = x.shape[-1]
    if scale.shape != (D,):
        raise ValueError(f"rmsnorm: scale must have shape ({D},), got "
                         f"{tuple(scale.shape)}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: the CUDA kernel takes contiguous x and "
                         "scale")
    code = _build.dtype_code(x, "rmsnorm")
    scale_code = _build.dtype_code(scale, "rmsnorm (scale)")
    y = torch.empty_like(x)
    vec = 16 // x.element_size()
    vector = (D % vec == 0 and x.data_ptr() % 16 == 0
              and y.data_ptr() % 16 == 0
              and scale.data_ptr() % min(16, vec * scale.element_size()) == 0)
    n_rows = x.numel() // D
    g = launch_geometry(n_rows, D, x.element_size(), vector,
                        _build.sm_count(x))
    err = _build.library().rt_rmsnorm(
        x.data_ptr(), scale.data_ptr(), y.data_ptr(), n_rows, D, float(eps),
        code, scale_code, g.vec, g.nv, g.warps, g.rows, g.grid,
        _build.stream(x))
    _build.check(err, "rmsnorm")
    _build.launches["rmsnorm"] += 1
    return y


def launch_info(dtype: torch.dtype, scale_dtype: torch.dtype, D: int,
                n_rows: int) -> dict:
    """The geometry of (dtype, scale dtype, D, rows) with aligned pointers
    and how many of its blocks fit on one SM (for the build log)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    g = launch_geometry(n_rows, D, itemsize, D % (16 // itemsize) == 0)
    blocks = ctypes.c_int(0)
    err = _build.library().rt_rmsnorm_info(
        _build.DTYPE_CODES[dtype], _build.DTYPE_CODES[scale_dtype], g.vec,
        g.nv, 32 * g.warps * g.rows, ctypes.byref(blocks))
    _build.check(err, "rmsnorm (info)")
    return {"geometry": g, "blocks_per_sm": blocks.value}
