"""h2o-danube-1.8b — llama+mistral mix, sliding-window attention [arXiv:2401.16818; hf].

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000. SWA window 4096 means the
decode KV cache is bounded, so long_500k is runnable for this arch.
"""
from repro_torch.configs.base import DENSE, SWA, ArchConfig, LayerSpec

ARCH = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_head=80,
    d_ff=6912,
    vocab_size=32000,
    sliding_window=4096,
    block_pattern=(LayerSpec(SWA, DENSE),),
    num_blocks=24,
)
