"""Architecture registry of the port: ``--arch <id>`` resolves here.

It lists only the architectures the port serves: the dense GQA decoder of
the ATTN + DENSE subset, the ATTN + MOE decoder, the attention-free
RWKV + RWKVMIX model and the hybrid that interleaves Mamba and attention
layers over dense and MoE MLPs; the rest of ``src/repro/configs`` comes
with the model zoo (ROADMAP module item 12).
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import (ArchConfig, LayerSpec, ShapeConfig,
                                      SHAPES, shape_applicable)

_ARCH_MODULES = {
    "tinyllama-1.1b": "tinyllama_1_1b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "rwkv6-7b": "rwkv6_7b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
}


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


def get_config(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).smoke()
    modname = _ARCH_MODULES.get(name)
    if modname is None:
        raise KeyError(f"unknown arch {name!r}; the port serves "
                       f"{list_archs()}")
    return importlib.import_module(f"repro_torch.configs.{modname}").ARCH


__all__ = ["ArchConfig", "LayerSpec", "ShapeConfig", "SHAPES",
           "shape_applicable", "get_config", "list_archs"]
