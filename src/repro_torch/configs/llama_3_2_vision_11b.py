"""llama-3.2-vision-11b — cross-attn image layers [hf:meta-llama/Llama-3.2-11B-Vision; unverified].

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256. Every 5th layer carries
an extra gated cross-attention to vision patch embeddings. The vision tower is a
STUB per the assignment: input_specs() provides precomputed patch embeddings
(ctx_len=1024 patches, ctx_dim=4096 after projection).
"""
from repro_torch.configs.base import ATTN, DENSE, XATTN, ArchConfig, LayerSpec

ARCH = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_head=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=5e5,
    xattn_ctx_len=1024,
    xattn_ctx_dim=4096,
    block_pattern=(
        LayerSpec(XATTN, DENSE),
        LayerSpec(ATTN, DENSE),
        LayerSpec(ATTN, DENSE),
        LayerSpec(ATTN, DENSE),
        LayerSpec(ATTN, DENSE),
    ),
    num_blocks=8,
)
