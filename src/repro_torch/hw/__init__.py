"""``repro_torch.hw`` — the pluggable hardware-spec layer (port of ``repro.hw``).

One serializable description of a memory system (:class:`Hardware`,
composing :class:`MemorySystem` + :class:`DramOrganization` +
:class:`ClockDomain`) behind a named registry:

    >>> from repro_torch import hw
    >>> board = hw.get("stratix10_ddr4_1866")
    >>> spec = hw.Hardware.from_json(saved)   # JSON written by either package

Presets: ``tpu_v5e``, ``tpu_v4``, ``stratix10_ddr4_1866``,
``stratix10_ddr4_2666`` (see :mod:`repro_torch.hw.presets`).
"""
from repro_torch.hw.registry import get, names, register, unregister
from repro_torch.hw.spec import (
    SCHEMA_VERSION,
    ClockDomain,
    DramOrganization,
    Hardware,
    MemorySystem,
)
from repro_torch.hw import presets  # populates the registry
from repro_torch.hw.presets import DEFAULT_BOARD, DEFAULT_CHIP

__all__ = [
    "Hardware", "MemorySystem", "DramOrganization", "ClockDomain",
    "get", "register", "unregister", "names",
    "DEFAULT_BOARD", "DEFAULT_CHIP", "SCHEMA_VERSION", "presets",
]
