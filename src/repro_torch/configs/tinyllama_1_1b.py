"""tinyllama-1.1b — llama2-arch small [arXiv:2401.02385; hf].

22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000.
"""
from repro_torch.configs.base import ATTN, DENSE, ArchConfig, LayerSpec

ARCH = ArchConfig(
    name="tinyllama-1.1b",
    family="dense",
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=64,
    d_ff=5632,
    vocab_size=32000,
    block_pattern=(LayerSpec(ATTN, DENSE),),
    num_blocks=22,
)
