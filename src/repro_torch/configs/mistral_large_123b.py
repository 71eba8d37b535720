"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407; unverified].

88L d_model=12288 96H (GQA kv=8) d_ff=28672 vocab=32768.
"""
from repro_torch.configs.base import ATTN, DENSE, ArchConfig, LayerSpec

ARCH = ArchConfig(
    name="mistral-large-123b",
    family="dense",
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_head=128,
    d_ff=28672,
    vocab_size=32768,
    rope_theta=1e6,
    block_pattern=(LayerSpec(ATTN, DENSE),),
    num_blocks=88,
)
