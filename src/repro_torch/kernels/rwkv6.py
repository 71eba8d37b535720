"""The RWKV-6 time-mix recurrence: the port of ``src/repro/kernels/rwkv6.py``
(the Pallas ``_rwkv_kernel``), written by hand in ``csrc/rwkv_scan.cu``.

Each (batch, head) walks the whole sequence with its (hd, hd) state in
registers, split over lanes: a lane holds a tile of key rows x value
columns, 16 lanes split the key rows and meet in a shuffle tree, and a
head's columns are cut into ``slices`` blocks of 128 threads. The kernel
stores the final state: the serving prefill takes it for the decode cache
(the TPU kernel kept it in VMEM scratch and dropped it). The TPU wrapper's
``chunk`` was its tile along the sequence and does not change the result;
the CUDA kernel stages its own runs of tokens, so the argument is dropped.
``rwkv_geometry`` is the one place the launch is decided.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rwkv_scan_ref

#: the lane tiles (key rows, value columns) the source instantiates, by
#: code (``TILE_ROWS`` / ``TILE_COLS`` in the source): a lane's state is
#: at most 64 floats
TILES = ((4, 2), (4, 4), (4, 8), (8, 2), (8, 4), (8, 8), (16, 2), (16, 4),
         (32, 2))
#: lanes that split a head's key rows, column groups a block (``LANES``,
#: ``GROUPS`` in the source: 128 threads), and the widest head
LANES, GROUPS = 16, 8
MAX_HD = LANES * 32
#: the warps a launch should have per SM before a lane takes a wider tile
#: (more columns: fewer shared-memory loads per state element, fewer warps)
MIN_WARPS_PER_SM = 3
#: bytes of one staged run of tokens (three are held), and its most
#: tokens
STAGE_BYTES, MAX_TC = 16 * 1024, 64
#: H100 SXM; the wrapper passes the device's own count
SMS = 132


class Geometry(NamedTuple):
    tile: int     # index into TILES: the lane's key rows x value columns
    slices: int   # blocks a head, GROUPS * tj columns each
    tc: int       # tokens a staged run

    @property
    def ti(self) -> int:
        return TILES[self.tile][0]

    @property
    def tj(self) -> int:
        return TILES[self.tile][1]


def tile_geometry(S: int, hd: int, tile: int, itemsize: int = 4) -> Geometry:
    """The launch of lane tile ``tile`` (LANES * rows >= hd) for heads of
    width hd and S tokens: the blocks a head that cover hd, and runs of
    about STAGE_BYTES (at most S)."""
    ti, tj = TILES[tile]
    run = (3 * LANES * ti + GROUPS * tj) * itemsize
    tc = 1 << (min(MAX_TC, max(1, STAGE_BYTES // run)).bit_length() - 1)
    return Geometry(tile, -(-hd // (GROUPS * tj)), max(1, min(tc, S)))


def rwkv_geometry(B: int, S: int, nh: int, hd: int, itemsize: int = 4,
                  sms: int = SMS) -> Geometry:
    """The launch for B * nh heads of width hd and S tokens of
    ``itemsize``-byte inputs: the fewest key rows a lane (4, 8, 16, 32)
    that LANES lanes stretch over hd, then the widest tile (8, 4, then 2
    columns) that still gives MIN_WARPS_PER_SM warps an SM -- wide tiles
    load fewer floats from shared memory per state element, narrow ones put
    more warps on a short sequence; the rest as ``tile_geometry``."""
    if not 1 <= hd <= MAX_HD:
        raise ValueError(f"rwkv_scan: the kernel takes head dims 1..{MAX_HD} "
                         f"({LANES} lanes of at most 32 key rows), got {hd}")
    ti = next(t for t in (4, 8, 16, 32) if LANES * t >= hd)
    tiles = sorted((i for i, (r, _) in enumerate(TILES) if r == ti),
                   key=lambda i: -TILES[i][1])
    for tile in tiles:
        blocks = B * nh * -(-hd // (GROUPS * TILES[tile][1]))
        if blocks * LANES * GROUPS // 32 >= MIN_WARPS_PER_SM * sms:
            break
    return tile_geometry(S, hd, tile, itemsize)


def rwkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor):
    """r, k, v, w: (B,S,nh,hd); u: (nh,hd) -> (y (B,S,nh,hd) f32, the final
    state (B,nh,hd,hd) f32 [b, h, k, v]). CPU tensors take the plain
    version; CUDA tensors the kernel, which takes contiguous inputs, r, k,
    v and w all float32 or all bfloat16, u float32 or bfloat16 (all widened
    in the kernel) and 1 <= hd <= 512, and raises on anything else."""
    if not _build.on_cuda(r, k, v, w, u):
        return rwkv_scan_ref(r, k, v, w, u)
    _build.forward_only("rwkv_scan", r, k, v, w, u)
    return _launch(r, k, v, w, u)


def _launch(r, k, v, w, u, geometry: Optional[Geometry] = None):
    """The kernel's launch, under ``rwkv_geometry``'s choice or
    ``geometry`` (chip_smoke's ``scan-tiles`` measures the other lane
    tiles; the kernel refuses one it cannot take)."""
    if r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"rwkv_scan: r, k, v, w must share one (B, S, nh, "
                         f"hd) shape; got {[tuple(t.shape) for t in (r, k, v, w)]}")
    B, S, nh, hd = r.shape
    if u.shape != (nh, hd):
        raise ValueError(f"rwkv_scan: u must have shape ({nh}, {hd}), got "
                         f"{tuple(u.shape)}")
    g = geometry or rwkv_geometry(B, S, nh, hd, r.element_size(),
                                  _build.sm_count(r))
    if any(t.dtype != r.dtype for t in (k, v, w)):
        raise TypeError("rwkv_scan: the CUDA kernel takes r, k, v and w in "
                        "one dtype")
    code = _build.dtype_code(r, "rwkv_scan")
    u_code = _build.dtype_code(u, "rwkv_scan (u)")
    if not all(t.is_contiguous() for t in (r, k, v, w, u)):
        raise ValueError("rwkv_scan: the CUDA kernel takes contiguous inputs")
    y = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    state = torch.empty((B, nh, hd, hd), dtype=torch.float32,
                        device=r.device)
    vbytes = _build.copy_bytes(hd * r.element_size(), r, k, v, w)
    err = _build.library().rt_rwkv_scan(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        y.data_ptr(), state.data_ptr(), B, S, nh, hd, code, u_code, g.tile,
        g.slices, g.tc, vbytes, _build.stream(r))
    _build.check(err, "rwkv_scan")
    _build.launches["rwkv_scan"] += 1
    return y, state


def launch_info(dtype: torch.dtype, B: int, S: int, nh: int,
                hd: int) -> dict:
    """The geometry of (dtype, B, S, nh, hd), its dynamic shared memory and
    how many of its blocks fit on one SM (for the build log)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    g = rwkv_geometry(B, S, nh, hd, itemsize)
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = _build.library().rt_rwkv_scan_info(
        _build.DTYPE_CODES[dtype], g.tile, g.tc,
        ctypes.byref(smem), ctypes.byref(blocks))
    _build.check(err, "rwkv_scan (info)")
    return {"geometry": g, "smem_bytes": smem.value,
            "blocks_per_sm": blocks.value}
