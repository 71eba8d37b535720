"""The UKL linkage spectrum for PyTorch: levels, presets, the training and
serving step constructors and the co-processes that run beside them."""
from repro_torch.core.coprocess import (AdmissionWorker, AsyncCheckpointer,
                                        MetricWriter, PrefetchWorker)
from repro_torch.core.linkage import (L0_EAGER, L1_BASE, L2_BYP, L3_NSS,
                                      LEVELS, PRESETS, LinkageConfig, preset)
from repro_torch.core.step import (LinkedStep, SamplingConfig, TrainState,
                                   build_decode_step,
                                   build_paged_decode_step, build_prefill_fn,
                                   build_serve_step, build_sharded_train_step,
                                   build_slot_decode_step, build_train_step,
                                   build_verify_step, init_train_state,
                                   make_decode_fn, make_paged_decode_fn,
                                   make_sampler, make_slot_decode_fn,
                                   make_train_step, program_label)

__all__ = [
    "AdmissionWorker", "AsyncCheckpointer", "MetricWriter", "PrefetchWorker",
    "L0_EAGER", "L1_BASE", "L2_BYP", "L3_NSS", "LEVELS", "PRESETS",
    "LinkageConfig", "preset",
    "LinkedStep", "SamplingConfig", "TrainState", "build_decode_step",
    "build_paged_decode_step",
    "build_prefill_fn", "build_serve_step", "build_sharded_train_step",
    "build_slot_decode_step", "build_train_step", "build_verify_step",
    "init_train_state", "make_decode_fn", "make_paged_decode_fn",
    "make_sampler", "make_slot_decode_fn", "make_train_step",
    "program_label",
]
