"""Hand-written Hopper kernels of the port, one module per TPU kernel.

Each module holds the wrapper (device, dtype, shape and stride checks; the
output allocation; the launch and its count) beside its plain PyTorch
version in ``ref.py``. ``ops.py`` is the entry point the model calls. The
CUDA sources live in ``repro_torch/csrc`` and are built at first use
(``_build.py``); importing these modules builds nothing.
"""
