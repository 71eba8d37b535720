"""The UKL linkage spectrum, mapped onto PyTorch (``src/repro/core/linkage.py``).

UKL (Unikernel Linux, EuroSys'23) exposes a configuration spectrum between
a general-purpose OS and a unikernel by progressively erasing the
application/kernel boundary for one linked application. The JAX package
applies it to the host-Python ⇄ XLA ⇄ device boundary; in PyTorch the
levels keep their meaning:

    L0_EAGER    op-at-a-time dispatch: plain eager PyTorch.
    L1_BASE     the step as one program; eager in this port (CUDA-graph
                capture is ROADMAP kernel queue item 10), and, like the
                jitted JAX program, functional: the caller's state survives.
    L2_BYP      bypass the boundary software: the engine's KV cache is
                preallocated and updated in place — the PyTorch counterpart
                of buffer donation.
    L3_NSS      ``decode_steps`` microsteps per engine program with no host
                synchronisation between them; their tokens gather into one
                device tensor. Training: ``nss_steps`` optimizer steps per
                call over K batches staged on the device at once.

  Orthogonal flags:
    ret_async   "ret vs iret": generated tokens stay on the device until a
                request finishes; the host synchronises only then. In
                training the step returns no metrics; they stay on the
                device, and the driver reads them every ``sync_every``
                calls.
    shortcut    the hand-written Hopper kernels (flash attention, slot
                and paged decode, paged prefill, fused RMSNorm, the MoE
                router, the Mamba and RWKV scans) in place of the plain
                PyTorch paths.
                Their wrappers dispatch on the tensors' device: the kernels
                on CUDA, their plain versions on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.models.layers import ModelOptions

L0_EAGER = "L0_EAGER"
L1_BASE = "L1_BASE"
L2_BYP = "L2_BYP"
L3_NSS = "L3_NSS"

LEVELS = (L0_EAGER, L1_BASE, L2_BYP, L3_NSS)


@dataclasses.dataclass(frozen=True)
class LinkageConfig:
    level: str = L2_BYP
    nss_steps: int = 4            # training L3: optimizer steps per call
    ret_async: bool = False       # UKL_RET analogue: async return
    sync_every: int = 16          # training host sync cadence when ret_async
    shortcut: bool = False        # hand-written kernels for hot paths
    decode_steps: int = 32        # serving L3: tokens decoded per program

    def validate(self) -> None:
        if self.level not in LEVELS:
            raise ValueError(f"unknown linkage level {self.level!r}")
        if self.level == L3_NSS and self.nss_steps < 1:
            raise ValueError("L3_NSS needs nss_steps >= 1")
        if self.level == L3_NSS and self.decode_steps < 1:
            raise ValueError("L3_NSS needs decode_steps >= 1")
        if self.level == L0_EAGER and self.shortcut:
            raise ValueError(
                "shortcuts require a linked program — like calling "
                "tcp_sendmsg from userspace, L0 cannot take them")

    @property
    def donate(self) -> bool:
        """L2+ updates the state buffers in place (BYP: no copy on entry)."""
        return self.level in (L2_BYP, L3_NSS)

    @property
    def steps_per_call(self) -> int:
        """Optimizer steps one training call takes: ``nss_steps`` at L3."""
        return self.nss_steps if self.level == L3_NSS else 1

    def model_options(self, base: Optional[ModelOptions] = None
                      ) -> ModelOptions:
        """Resolve ModelOptions for this linkage level: ``shortcut`` selects
        the kernel wrappers (attention, the fused norm, and the MoE router
        and the Mamba and RWKV scans, ``scan_impl``: JAX's "pallas"). Which
        code runs then follows the tensors: the Hopper kernels for CUDA
        tensors, their plain versions for CPU tensors."""
        base = base or ModelOptions()
        if not self.shortcut:
            return base
        return dataclasses.replace(base, attn_impl="kernel",
                                   scan_impl="kernel", fused_norm=True)


# Named presets mirroring the paper's evaluated configurations -------------
PRESETS = {
    "linux": LinkageConfig(level=L0_EAGER),
    "base": LinkageConfig(level=L1_BASE),
    "byp": LinkageConfig(level=L2_BYP),
    "ret_byp": LinkageConfig(level=L2_BYP, ret_async=True),
    "nss": LinkageConfig(level=L3_NSS),
    "ret_byp_shortcut": LinkageConfig(level=L2_BYP, ret_async=True,
                                      shortcut=True),
    "nss_shortcut": LinkageConfig(level=L3_NSS, ret_async=True, shortcut=True),
}


def preset(name: str) -> LinkageConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; known: {list(PRESETS)}")
    return PRESETS[name]
