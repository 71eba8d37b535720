"""musicgen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

48L d_model=1536 24H (GQA kv=24 = MHA) d_ff=6144 vocab=2048. The EnCodec audio
frontend is a STUB per the assignment: input_specs() provides precomputed frame
embeddings, the backbone consumes them directly (embeds_in=True).
"""
from repro_torch.configs.base import ATTN, DENSE, ArchConfig, LayerSpec

ARCH = ArchConfig(
    name="musicgen-medium",
    family="audio",
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_head=64,
    d_ff=6144,
    vocab_size=2048,
    embeds_in=True,
    block_pattern=(LayerSpec(ATTN, DENSE),),
    num_blocks=48,
)
