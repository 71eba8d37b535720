"""EXTRA (beyond the assigned pool): mixtral-8x7b [arXiv:2401.04088; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8 experts top-2.
Included as a breadth check: the canonical open MoE, with an expert count (8)
that — unlike kimi-k2's 384 — tiles every mesh axis of the production meshes.
"""
from repro_torch.configs.base import ATTN, MOE, ArchConfig, LayerSpec, MoEConfig

ARCH = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1e6,
    moe=MoEConfig(num_experts=8, top_k=2),
    block_pattern=(LayerSpec(ATTN, MOE),),
    num_blocks=32,
)
