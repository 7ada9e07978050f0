"""Atomic, optionally asynchronous checkpoints (port of ``repro.checkpoint``)."""
from repro_torch.checkpoint.manager import CheckpointManager
