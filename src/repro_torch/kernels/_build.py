"""Build and load the port's hand-written Hopper kernels.

``csrc/*.cu`` have a plain C interface (no PyTorch headers), so ``nvcc``
compiles each source in seconds. At first use every source is compiled to
an object, all ``nvcc`` processes started together, then linked into one
shared library under ``build/repro_torch/<hash>/`` at the repository root
(listed in ``.gitignore``). The hash covers the sources, the headers and
the flags, so an edited kernel rebuilds and an unchanged one loads the
library already there. The library is loaded with ``ctypes``: every
pointer and the stream go as ``c_void_p``, and every entry point returns
``cudaGetLastError()``, which ``check`` turns into an exception.

Nothing here runs at import: the CPU-only tests import every module.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v"]
LIB_NAME = "librepro_torch_kernels.so"

#: kernel launches since the last ``reset_launches``: each wrapper adds one
#: where it launches its kernel, and nowhere else
launches = collections.Counter()

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: storage codes of quantized pools (``RT_I8`` / ``RT_E4M3`` in the sources)
KV_CODES = {torch.int8: 0, torch.float8_e4m3fn: 1}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    launches.clear()


def on_cuda(*tensors: torch.Tensor) -> bool:
    """The dispatch rule of every kernel wrapper: True when the tensors lie
    on a CUDA device (launch the kernel), False when they lie on the CPU
    (run the plain version). Anything else — another device, or a mix —
    raises: a CUDA tensor never reaches a plain version."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel inputs must all lie on the CPU or all on one "
                     f"CUDA device; got {sorted(kinds)}")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first "
                       "use on a machine with the CUDA toolkit")


def _fingerprint(sources, headers) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``csrc/*.cu`` (if the hashed library is not there yet) and
    return the library's path. Compiler output goes to ``build.log``."""
    sources = sorted(CSRC.glob("*.cu"))
    headers = sorted(CSRC.glob("*.cuh"))
    out_dir = BUILD_ROOT / _fingerprint(sources, headers)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(s), "-o",
                                   str(o)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(sources, objs)]
        logs = [(s.name, p.communicate()[0], p.returncode)
                for s, p in zip(sources, procs)]
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o",
                               str(tmp_lib), *map(str, objs)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) \
            if all(rc == 0 for _, _, rc in logs) else None
        text = "".join(f"== {name} (rc {rc})\n{log}" for name, log, rc in logs)
        if link is not None:
            text += f"== link (rc {link.returncode})\n{link.stdout}"
        (out_dir / "build.log").write_text(text)
        if link is None or link.returncode != 0:
            raise RuntimeError(f"building the CUDA kernels failed:\n{text}")
        os.replace(tmp_lib, lib)     # atomic: concurrent builds agree
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use), with the argument
    types of every entry point declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        L = ctypes.c_longlong
        lib.rt_rmsnorm.argtypes = [P, P, P, L, I, F, I, I, I, I, I, I, I, P]
        lib.rt_rmsnorm_info.argtypes = [I, I, I, I, I, P]
        lib.rt_flash_attention.argtypes = [P, P, P, P, P, I, I, I, I, I, I,
                                           P, I, I, F, I, P]
        lib.rt_flash_info.argtypes = [I, I, P, P]
        lib.rt_flash_attention_bwd.argtypes = [P, P, P, P, P, P, P, P, P, P,
                                               I, I, I, I, I, I, I, F, I, I,
                                               I, P]
        lib.rt_flash_bwd_info.argtypes = [I, I, P, P]
        lib.rt_slot_decode_attention.argtypes = [P, P, P, P, P, P, I, I, I,
                                                 I, I, I, P, F, I, P]
        lib.rt_paged_decode_attention.argtypes = [P, P, P, P, P, P, P, P, P,
                                                  I, I, I, I, I, I, I, P, F,
                                                  I, I, P]
        lib.rt_decode_info.argtypes = [I, I, I, I, I, P, P]
        lib.rt_paged_prefill_attention.argtypes = [P, P, P, P, P, P, I, I, I,
                                                   I, I, I, I, P, F, I, P]
        lib.rt_paged_prefill_attention_quant.argtypes = [
            P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, P, F, I, I, P]
        lib.rt_paged_prefill_info.argtypes = [I, I, I, P, P]
        lib.rt_moe_route.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I,
                                     I, I, I, I, P]
        lib.rt_moe_route_info.argtypes = [I, I, I, I, I, I, I, P, P]
        lib.rt_rwkv_scan.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I,
                                     I, I, I, I, P]
        lib.rt_rwkv_scan_info.argtypes = [I, I, I, P, P]
        lib.rt_mamba_scan.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I,
                                      I, I, I, P]
        lib.rt_mamba_scan_info.argtypes = [I, I, I, P, P]
        for fn in (lib.rt_rmsnorm, lib.rt_rmsnorm_info,
                   lib.rt_flash_attention,
                   lib.rt_flash_info, lib.rt_flash_attention_bwd,
                   lib.rt_flash_bwd_info, lib.rt_slot_decode_attention,
                   lib.rt_decode_info, lib.rt_paged_decode_attention,
                   lib.rt_paged_prefill_attention,
                   lib.rt_paged_prefill_attention_quant,
                   lib.rt_paged_prefill_info,
                   lib.rt_moe_route, lib.rt_moe_route_info,
                   lib.rt_rwkv_scan, lib.rt_rwkv_scan_info,
                   lib.rt_mamba_scan, lib.rt_mamba_scan_info):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def strides(*tensors_and_dims) -> ctypes.Array:
    """A C array of element strides: ``strides((q, (0, 1)), (k, (0, 2)))``
    lists q's strides along dims 0 and 1, then k's along dims 0 and 2."""
    vals = [t.stride(d) for t, dims in tensors_and_dims for d in dims]
    return (ctypes.c_longlong * len(vals))(*vals)


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(t: torch.Tensor) -> int:
    """The SMs of the CUDA device ``t`` lies on (for launch geometry)."""
    return _sm_count(t.device.index if t.device.index is not None
                     else torch.cuda.current_device())


def copy_bytes(row_bytes: int, *tensors: torch.Tensor) -> int:
    """The widest copy (16, 8 or 4 bytes) that divides ``row_bytes`` and
    every tensor's address, or 0 for element copies (``rt::vec_width``)."""
    bits = row_bytes
    for t in tensors:
        bits |= t.data_ptr()
    return next((v for v in (16, 8, 4) if bits % v == 0), 0)


def forward_only(what: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would need a gradient through a kernel that has
    none: grad mode on and an input requiring grad. The serving kernels
    are ctypes launches that autograd cannot see, so the gradient would be
    lost without a word; only flash attention and rmsnorm have a backward
    (their ``torch.autograd.Function``s)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(f"{what}: the CUDA kernel has no backward; run it "
                           f"under torch.no_grad() or on inputs that do not "
                           f"require grad")


def dtype_code(t: torch.Tensor, what: str) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: the CUDA kernel takes float32 or bfloat16, "
                        f"got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA kernel launch failed with "
                           f"cudaError {err}")
