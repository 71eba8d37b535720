"""The MoE router: the port of ``src/repro/kernels/moe_route.py`` (the
Pallas ``_route_kernel``), written by hand in ``csrc/moe_route.cu``.

``x @ router`` in fp32, the softmax and k rounds of max / argmax / mask in
one launch, without the (N, E) probabilities ever reaching device memory.
The TPU wrapper padded N to whole ``block_n`` tiles; the CUDA kernel masks
the ragged tile itself, so any N >= 1 works. The blocks split a token tile's
work over slices of the experts and of D (``route_geometry``, the one place
the launch is decided); their partial logits meet in a float32 workspace
this wrapper allocates, and arrival tickets (a small int32 buffer kept per
device and stream, zero between calls) let the last block of a tile finish
it.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import moe_route_ref

#: the most experts the kernel takes (``MAX_E`` in the source)
MAX_E = 2048
#: token counts up to this take the decode kernel
DECODE_MAX_N = 64
#: a decode block's threads, the most experts a slice holds, and the most
#: rows of D a decode block stages (``DEC_THREADS``, ``SLICE``,
#: ``DEC_MAX_ROWS`` in the source)
DEC_THREADS, SLICE, DEC_MAX_ROWS = 256, 64, 1024
#: router rows a decode thread streams at least (its loads are in flight
#: together, up to ``DEC_BATCH`` in the source)
DEC_MIN_ROWS_PER_THREAD = 4
#: tokens a prefill tile (``BM``), rows of D a prefill stage by mode
#: (``KC_TC``, ``KC``), and the fewest rows of D a prefill split takes
TILE_N, TILE_MIN_ROWS = 64, 128
CHUNK = {"tc": 64, "tile": 32}
#: blocks the D split aims for, per SM: two at decode (the router read
#: cold needs its loads in flight at once), one at prefill, where every
#: further split adds partials for the last block to sum
BLOCKS_PER_SM = {"decode": 2, "tc": 1, "tile": 1}
MODES = {"decode": 0, "tc": 1, "tile": 2}
#: H100 SXM; the wrapper passes the device's own count
SMS = 132


class RouteGeometry(NamedTuple):
    mode: str     # "decode", "tc" (bf16 tensor cores) or "tile" (FFMA)
    tn: int       # tokens a tile
    cg: int       # decode: 16-byte column groups a slice (0 at prefill)
    cw: int       # experts a slice
    tiles: int
    slices: int
    splits: int   # slices of D
    rows: int     # rows of D a split (the last may hold fewer)


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def route_geometry(N: int, D: int, E: int, itemsize: int, wide: bool,
                   sms: int = SMS) -> RouteGeometry:
    """The launch of ``moe_route`` for N tokens, D rows and E experts of
    ``itemsize`` bytes; ``wide``: 16-byte rows (the router's, and at
    prefill x's). Up to DECODE_MAX_N tokens: tiles of N rounded up to a
    power of two (at most 8), slices of up to SLICE experts that a warp's
    16-byte loads cover, D split so that about two blocks an SM stream the
    router, each thread at least DEC_MIN_ROWS_PER_THREAD rows. Above:
    64-token tiles, 64-expert slices, D split in whole CHUNKs of the mode
    when the tiles and slices alone fill fewer than BLOCKS_PER_SM blocks
    an SM. The tiles' slices run side by side in the grid."""
    vec = 16 // itemsize
    if N <= DECODE_MAX_N:
        mode, tn = "decode", min(8, _pow2(N))
        cg = min(SLICE // vec, _pow2(-(-E // vec)))
        cw = cg * vec
        residues = DEC_THREADS // cg
    else:
        mode = "tc" if itemsize == 2 and wide else "tile"
        tn, cg, cw = TILE_N, 0, SLICE
    tiles, slices = -(-N // tn), -(-E // cw)
    want = -(-BLOCKS_PER_SM[mode] * sms // (tiles * slices))
    if mode == "decode":
        per_thread = max(DEC_MIN_ROWS_PER_THREAD,
                         -(-(-(-D // want)) // residues))
        rows = min(D, DEC_MAX_ROWS, per_thread * residues)
    else:
        chunk = CHUNK[mode]
        rows = max(TILE_MIN_ROWS, -(-(-(-D // want)) // chunk) * chunk)
        rows = min(rows, -(-D // chunk) * chunk)
    return RouteGeometry(mode, tn, cg, cw, tiles, slices, -(-D // rows),
                         rows)


#: arrival tickets per (device, stream): zero between calls (every call's
#: last blocks reset theirs)
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


def _ticket_buffer(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _tickets[key] = buf
    return buf


def _wide(x: torch.Tensor, router: torch.Tensor, decode: bool) -> bool:
    """16-byte rows: the router's at decode, the router's and x's above
    (the source's own test)."""
    vec = 16 // x.element_size()
    D, E = router.shape
    if decode:
        return E % vec == 0 and router.data_ptr() % 16 == 0
    return (E % vec == 0 and D % vec == 0 and router.data_ptr() % 16 == 0
            and x.data_ptr() % 16 == 0)


def moe_route(x: torch.Tensor, router: torch.Tensor, k: int):
    """x: (N,D); router: (D,E) in x's dtype -> (gates (N,k) f32, idx (N,k)
    int32): the top-k softmax probabilities and their experts, ties to the
    lowest index. CPU tensors take the plain version, CUDA tensors the
    kernel."""
    if not _build.on_cuda(x, router):
        return moe_route_ref(x, router, k)
    _build.forward_only("moe_route", x, router)
    if x.dim() != 2 or router.dim() != 2 or router.shape[0] != x.shape[1]:
        raise ValueError(f"moe_route: x must be (N, D) and router (D, E); "
                         f"got {tuple(x.shape)} and {tuple(router.shape)}")
    N, D = x.shape
    E = router.shape[1]
    if not (N >= 1 and D >= 1 and 1 <= E <= MAX_E and 1 <= k <= E):
        raise ValueError(f"moe_route: the kernel takes N >= 1, D >= 1, "
                         f"E <= {MAX_E} and 1 <= k <= E; got N {N}, D {D}, "
                         f"E {E}, k {k}")
    if x.dtype != router.dtype:
        raise TypeError(f"moe_route: router must be in x's dtype "
                        f"({x.dtype}), got {router.dtype}")
    if not (x.is_contiguous() and router.is_contiguous()):
        raise ValueError("moe_route: the CUDA kernel takes contiguous x and "
                         "router")
    code = _build.dtype_code(x, "moe_route")
    g = route_geometry(N, D, E, x.element_size(),
                       _wide(x, router, N <= DECODE_MAX_N),
                       _build.sm_count(x))
    stream = _build.stream(x)
    gates = torch.empty((N, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((N, k), dtype=torch.int32, device=x.device)
    logits = torch.empty((N, E), dtype=torch.float32, device=x.device)
    partial = (torch.empty((g.splits, N, E), dtype=torch.float32,
                           device=x.device) if g.splits > 1 else logits)
    tickets = _ticket_buffer(x.device, stream, g.tiles * (g.slices + 1))
    err = _build.library().rt_moe_route(
        x.data_ptr(), router.data_ptr(), gates.data_ptr(), idx.data_ptr(),
        partial.data_ptr(), logits.data_ptr(), tickets.data_ptr(), N, D, E,
        int(k), MODES[g.mode], g.tn, g.cg, g.splits, g.rows, code, stream)
    _build.check(err, "moe_route")
    _build.launches["moe_route"] += 1
    return gates, idx


def launch_info(dtype: torch.dtype, N: int, D: int, E: int) -> dict:
    """The geometry of (dtype, N, D, E) with aligned pointers, its dynamic
    shared memory and how many of its blocks fit on one SM (for the build
    log)."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    decode = N <= DECODE_MAX_N
    wide = E % vec == 0 and (decode or D % vec == 0)
    g = route_geometry(N, D, E, 16 // vec, wide)
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = _build.library().rt_moe_route_info(
        MODES[g.mode], _build.DTYPE_CODES[dtype], g.tn, g.cg, g.rows, E,
        int(wide), ctypes.byref(smem), ctypes.byref(blocks))
    _build.check(err, "moe_route (info)")
    return {"geometry": g, "smem_bytes": smem.value,
            "blocks_per_sm": blocks.value}
