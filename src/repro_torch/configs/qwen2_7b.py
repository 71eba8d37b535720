"""qwen2-7b — GQA, QKV bias [arXiv:2407.10671; hf].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
"""
from repro_torch.configs.base import ATTN, DENSE, ArchConfig, LayerSpec

ARCH = ArchConfig(
    name="qwen2-7b",
    family="dense",
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_head=128,
    d_ff=18944,
    vocab_size=152064,
    attn_bias=True,
    rope_theta=1e6,
    block_pattern=(LayerSpec(ATTN, DENSE),),
    num_blocks=28,
)
