"""Deterministic, restart-safe training data (port of ``repro.data``)."""
from repro_torch.data.pipeline import (DataConfig, MemmapDataset,
                                       SyntheticDataset, make_dataset)
