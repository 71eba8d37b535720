"""The JAX package's distributed examples as modules of the port
(``examples/compressed_dp.py``, ``examples/elastic_restart.py``), each run
as ``python -m repro_torch.examples.<name>`` on the card, or on the CPU
with ``--device cpu``."""
