from repro_torch.models.layers import ModelOptions
from repro_torch.models.transformer import (backbone, decode_step,
                                            decode_step_slots, embed,
                                            init_cache, init_params,
                                            layer_specs, prefill,
                                            unembed_logits)

__all__ = [
    "ModelOptions", "backbone", "decode_step", "decode_step_slots", "embed",
    "init_cache", "init_params", "layer_specs", "prefill", "unembed_logits",
]
