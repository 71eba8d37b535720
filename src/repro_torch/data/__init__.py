"""The training data pipeline of the port (``src/repro/data``)."""
from repro_torch.data.pipeline import DataConfig, Pipeline, stage

__all__ = ["DataConfig", "Pipeline", "stage"]
