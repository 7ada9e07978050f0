"""Fault tolerance and gradient compression of the trainer (port of
``repro.runtime``; ``elastic.py`` comes with the mesh)."""
from repro_torch.runtime.compression import compress_grads, decompress_grads
from repro_torch.runtime.fault_tolerance import PreemptionHandler, StepWatchdog
