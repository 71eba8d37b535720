"""The Mamba selective scan with its discretization fused: the port of
``src/repro/kernels/mamba_ssm.py`` (the Pallas ``_mamba_kernel``), written
by hand in ``csrc/mamba_scan.cu``.

Each (batch row, channel) walks the whole sequence with its ``ds`` states
in registers, split over adjacent lanes that meet in a shuffle tree, and
stores the final state: the serving prefill takes it for the decode cache
(the TPU kernel kept it in VMEM scratch and dropped it). The TPU wrapper's ``chunk`` and ``di_tile`` were its tiles
along the sequence and the channels (padded to whole tiles) and do not
change the result; the CUDA kernel masks the ragged channel block and
stages its own runs of tokens, so both arguments are dropped.
``mamba_geometry`` is the one place the launch is decided.

The kernel keeps the JAX oracles' dtype contract (``kernels/ref.py:114``,
``models/layers.py:880-893``), which is the one JAX serves with: ``dt·x``
is formed in the inputs' dtype and widened after. The Pallas kernel widens
x and dt before the product; in bfloat16 the two differ by that one
rounding.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mamba_scan_ref

#: the lane tiles (states a lane, lanes a channel) the source
#: instantiates, by code (``TILE_STATES`` / ``TILE_LANES`` in the source),
#: and the widest state
TILES = ((4, 4), (8, 4), (16, 4), (8, 16), (16, 16), (16, 32))
MAX_DS = 512
#: threads a block (``THREADS`` in the source)
THREADS = 128
#: bytes of one staged run of tokens (three are held), and its most
#: tokens
STAGE_BYTES, MAX_TC = 16 * 1024, 64


class Geometry(NamedTuple):
    tile: int      # index into TILES
    tc: int        # tokens a staged run

    @property
    def ns(self) -> int:
        return TILES[self.tile][0]

    @property
    def lanes(self) -> int:
        return TILES[self.tile][1]

    @property
    def channels(self) -> int:
        return THREADS // self.lanes


def tile_geometry(S: int, tile: int, itemsize: int = 4) -> Geometry:
    """The launch of lane tile ``tile`` for S tokens: runs of about
    STAGE_BYTES (at most S). The source's grid is the blocks of
    ``channels`` that cover a row's channels."""
    ns, lanes = TILES[tile]
    cb = THREADS // lanes
    run = (2 * cb + 2 * lanes * ns) * itemsize
    tc = 1 << (min(MAX_TC, max(1, STAGE_BYTES // run)).bit_length() - 1)
    return Geometry(tile, max(1, min(tc, S)))


def mamba_geometry(S: int, ds: int, itemsize: int = 4) -> Geometry:
    """The launch for channels of ds states and S tokens of
    ``itemsize``-byte inputs: the first tile (in TILES' order: 4 lanes of
    up to 16 states, then 16 and 32 lanes) that holds ds, laid out by
    ``tile_geometry``."""
    if not 1 <= ds <= MAX_DS:
        raise ValueError(f"mamba_scan: the kernel takes state sizes "
                         f"1..{MAX_DS} (32 lanes of 16 states), got ds {ds}")
    tile = next(i for i, (ns, lanes) in enumerate(TILES) if ns * lanes >= ds)
    return tile_geometry(S, tile, itemsize)


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bv: torch.Tensor, Cv: torch.Tensor):
    """x, dt: (B,S,di); A: (di,ds); Bv, Cv: (B,S,ds) -> (y (B,S,di) f32,
    the final state (B,di,ds) f32). CPU tensors take the plain version;
    CUDA tensors the kernel, which takes contiguous inputs, x, dt, Bv and
    Cv all float32 or all bfloat16, A float32 and 1 <= ds <= 512, and
    raises on anything else."""
    if not _build.on_cuda(x, dt, A, Bv, Cv):
        return mamba_scan_ref(x, dt, A, Bv, Cv)
    _build.forward_only("mamba_scan", x, dt, A, Bv, Cv)
    return _launch(x, dt, A, Bv, Cv)


def _launch(x, dt, A, Bv, Cv, geometry: Optional[Geometry] = None):
    """The kernel's launch, under ``mamba_geometry``'s choice or
    ``geometry`` (chip_smoke's ``scan-tiles`` measures the other lane
    tiles; the kernel refuses one it cannot take)."""
    if x.dim() != 3 or dt.shape != x.shape:
        raise ValueError(f"mamba_scan: x and dt must share one (B, S, di) "
                         f"shape; got {tuple(x.shape)}, {tuple(dt.shape)}")
    B, S, di = x.shape
    if A.dim() != 2 or A.shape[0] != di or di < 1:
        raise ValueError(f"mamba_scan: A must have shape ({di}, ds) with "
                         f"di >= 1, got {tuple(A.shape)}")
    ds = A.shape[1]
    if Bv.shape != (B, S, ds) or Cv.shape != (B, S, ds):
        raise ValueError(f"mamba_scan: Bv and Cv must have shape "
                         f"{(B, S, ds)}; got {tuple(Bv.shape)}, "
                         f"{tuple(Cv.shape)}")
    g = geometry or mamba_geometry(S, ds, x.element_size())
    if A.dtype != torch.float32 or any(t.dtype != x.dtype
                                       for t in (dt, Bv, Cv)):
        raise TypeError("mamba_scan: the CUDA kernel takes x, dt, Bv and Cv "
                        "in one dtype and A in float32")
    code = _build.dtype_code(x, "mamba_scan")
    if not all(t.is_contiguous() for t in (x, dt, A, Bv, Cv)):
        raise ValueError("mamba_scan: the CUDA kernel takes contiguous inputs")
    y = torch.empty((B, S, di), dtype=torch.float32, device=x.device)
    h_last = torch.empty((B, di, ds), dtype=torch.float32, device=x.device)
    err = _build.library().rt_mamba_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bv.data_ptr(),
        Cv.data_ptr(), y.data_ptr(), h_last.data_ptr(), B, S, di, ds, code,
        g.tile, g.tc, _build.copy_bytes(di * x.element_size(), x, dt),
        _build.copy_bytes(ds * x.element_size(), Bv, Cv), _build.stream(x))
    _build.check(err, "mamba_scan")
    _build.launches["mamba_scan"] += 1
    return y, h_last


def launch_info(dtype: torch.dtype, S: int, ds: int) -> dict:
    """The geometry of (dtype, S, ds), its dynamic shared memory and
    how many of its blocks fit on one SM (for the build log)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    g = mamba_geometry(S, ds, itemsize)
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = _build.library().rt_mamba_scan_info(
        _build.DTYPE_CODES[dtype], g.tile, g.tc, ctypes.byref(smem),
        ctypes.byref(blocks))
    _build.check(err, "mamba_scan (info)")
    return {"geometry": g, "smem_bytes": smem.value,
            "blocks_per_sm": blocks.value}
