"""kimi-k2-1t-a32b — trillion-param MoE [arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840, MoE 384 experts top-8.
Every layer routed; expert hidden d_ff=2048 as assigned. Active ~32B/token.
"""
from repro_torch.configs.base import ATTN, MOE, ArchConfig, LayerSpec, MoEConfig

ARCH = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_head=112,
    d_ff=2048,
    vocab_size=163840,
    rope_theta=5e7,
    moe=MoEConfig(num_experts=384, top_k=8),
    block_pattern=(LayerSpec(ATTN, MOE),),
    num_blocks=61,
)
