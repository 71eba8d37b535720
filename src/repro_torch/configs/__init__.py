"""Architecture registry of the port: ``--arch <id>`` resolves here.

The same names as the JAX package's registry (``src/repro/configs``), each
config a copy of its file there. Every one runs through the port's model;
the serving engine takes all but the two whose inputs are not token ids
alone (``musicgen-medium``'s frame embeddings, ``llama-3.2-vision-11b``'s
cross-attention context), which run at model level only, as in JAX.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import (ArchConfig, LayerSpec, MambaConfig,
                                      MoEConfig, ShapeConfig, SHAPES,
                                      shape_applicable)

_ARCH_MODULES = {
    "tinyllama-1.1b": "tinyllama_1_1b",
    "qwen2-7b": "qwen2_7b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "mistral-large-123b": "mistral_large_123b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "musicgen-medium": "musicgen_medium",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "rwkv6-7b": "rwkv6_7b",
}

# beyond the assigned pool: selectable, but outside the dry-run cell matrix
# (all_cells), as in the JAX registry
_EXTRA_MODULES = {
    "mixtral-8x7b": "mixtral_8x7b",
}


def list_archs(include_extras: bool = False) -> List[str]:
    names = list(_ARCH_MODULES)
    if include_extras:
        names += list(_EXTRA_MODULES)
    return names


def get_config(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).smoke()
    modname = _ARCH_MODULES.get(name) or _EXTRA_MODULES.get(name)
    if modname is None:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs(True)}")
    return importlib.import_module(f"repro_torch.configs.{modname}").ARCH


def all_cells() -> List[tuple]:
    """All (arch, shape) dry-run cells, with skips applied (registry data:
    the port runs no dry-run tooling)."""
    return [(a, s.name) for a in list_archs() for s in SHAPES.values()
            if shape_applicable(get_config(a), s)]


__all__ = [
    "ArchConfig", "LayerSpec", "MoEConfig", "MambaConfig", "ShapeConfig",
    "SHAPES", "shape_applicable", "get_config", "list_archs", "all_cells",
]
