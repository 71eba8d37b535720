"""rwkv6-7b — Finch, data-dependent decay [arXiv:2404.05892; hf].

32L d_model=4096 (attention-free) d_ff=14336 vocab=65536. Time-mix is the RWKV-6
linear-attention recurrence (head dim 64, data-dependent per-channel decay);
channel-mix is the squared-relu receptance-gated MLP. Decode state is O(1),
so long_500k is runnable.
"""
from repro_torch.configs.base import RWKV, RWKVMIX, ArchConfig, LayerSpec

ARCH = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=14336,
    vocab_size=65536,
    rwkv_head_dim=64,
    block_pattern=(LayerSpec(RWKV, RWKVMIX),),
    num_blocks=32,
)
