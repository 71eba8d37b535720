"""The UKL linkage spectrum for PyTorch: levels, presets, serving step
constructors and the co-processes that run beside them."""
from repro_torch.core.coprocess import AdmissionWorker, MetricWriter
from repro_torch.core.linkage import (L0_EAGER, L1_BASE, L2_BYP, L3_NSS,
                                      LEVELS, PRESETS, LinkageConfig, preset)
from repro_torch.core.step import (SamplingConfig, build_decode_step,
                                   build_paged_decode_step, build_prefill_fn,
                                   build_serve_step, build_slot_decode_step,
                                   build_verify_step, make_decode_fn,
                                   make_paged_decode_fn, make_sampler,
                                   make_slot_decode_fn, program_label)

__all__ = [
    "AdmissionWorker", "MetricWriter",
    "L0_EAGER", "L1_BASE", "L2_BYP", "L3_NSS", "LEVELS", "PRESETS",
    "LinkageConfig", "preset",
    "SamplingConfig", "build_decode_step", "build_paged_decode_step",
    "build_prefill_fn", "build_serve_step", "build_slot_decode_step",
    "build_verify_step", "make_decode_fn", "make_paged_decode_fn",
    "make_sampler", "make_slot_decode_fn", "program_label",
]
