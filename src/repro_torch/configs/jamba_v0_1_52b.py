"""jamba-v0.1-52b — Mamba+attn 1:7 interleave, MoE [arXiv:2403.19887; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16 experts top-2.
Each 8-layer Jamba block has one attention layer (index 4) and seven Mamba
layers; every other layer uses the MoE MLP. Bounded decode state (Mamba O(1),
single attention layer per block) makes long_500k runnable.
"""
from repro_torch.configs.base import (ATTN, DENSE, MAMBA, MOE, ArchConfig,
                                      LayerSpec, MambaConfig, MoEConfig)

ARCH = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=65536,
    moe=MoEConfig(num_experts=16, top_k=2),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    block_pattern=(
        LayerSpec(MAMBA, DENSE),
        LayerSpec(MAMBA, MOE),
        LayerSpec(MAMBA, DENSE),
        LayerSpec(MAMBA, MOE),
        LayerSpec(ATTN, DENSE),
        LayerSpec(MAMBA, MOE),
        LayerSpec(MAMBA, DENSE),
        LayerSpec(MAMBA, MOE),
    ),
    num_blocks=4,
)
