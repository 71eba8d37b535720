"""moonshot-v1-16b-a3b — kimi/moonlight, 64e top-6 [hf:moonshotai/Moonlight-16B-A3B; hf].

48L d_model=2048 16H (GQA kv=16 = MHA) d_ff=1408 vocab=163840, MoE 64 experts top-6.
"""
from repro_torch.configs.base import ATTN, MOE, ArchConfig, LayerSpec, MoEConfig

ARCH = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_head=128,
    d_ff=1408,
    vocab_size=163840,
    moe=MoEConfig(num_experts=64, top_k=6),
    block_pattern=(LayerSpec(ATTN, MOE),),
    num_blocks=48,
)
