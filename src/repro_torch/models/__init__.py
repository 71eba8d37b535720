from repro_torch.models.layers import ModelOptions
from repro_torch.models.transformer import (backbone, decode_step,
                                            decode_step_paged,
                                            decode_step_slots, embed,
                                            init_cache, init_params, loss_fn,
                                            layer_specs, prefill,
                                            prefill_suffix,
                                            serve_chunk_step,
                                            serve_chunk_step_paged,
                                            serve_verify_step,
                                            serve_verify_step_paged,
                                            train_backbone, unembed_logits)

__all__ = [
    "ModelOptions", "backbone", "decode_step", "decode_step_paged",
    "decode_step_slots", "embed", "init_cache", "init_params", "layer_specs",
    "loss_fn", "prefill", "prefill_suffix", "serve_chunk_step",
    "serve_chunk_step_paged", "serve_verify_step", "serve_verify_step_paged",
    "train_backbone", "unembed_logits",
]
