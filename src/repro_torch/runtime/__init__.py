"""Fault tolerance, gradient compression and elastic rescale of the
trainer (port of ``repro.runtime``)."""
from repro_torch.runtime.compression import compress_grads, decompress_grads
from repro_torch.runtime.fault_tolerance import PreemptionHandler, StepWatchdog
