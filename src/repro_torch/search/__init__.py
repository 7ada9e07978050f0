"""``repro_torch.search`` — resource envelopes (constraints and the optimizer
wait for a later slice of the port)."""
from repro_torch.search.envelope import ResourceEnvelope

__all__ = ["ResourceEnvelope"]
