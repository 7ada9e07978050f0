"""Named registry of :class:`~repro_torch.hw.spec.Hardware` specs.

``get("tpu_v5e")`` resolves a preset (or anything registered at runtime) by
name; ``register`` adds project- or session-specific specs — e.g. the
output of ``Hardware.from_calibration`` — so sweeps and benchmarks can fan
out over memory systems by name (``--hw`` flags resolve here).
"""
from __future__ import annotations

from repro_torch.hw.spec import Hardware

_REGISTRY: dict[str, Hardware] = {}


def register(hardware: Hardware, *, overwrite: bool = False) -> Hardware:
    """Register ``hardware`` under its own name; returns it for chaining."""
    if not isinstance(hardware, Hardware):
        raise TypeError(f"expected a Hardware spec, got {type(hardware)!r}")
    if hardware.name in _REGISTRY and not overwrite:
        raise ValueError(
            f"hardware {hardware.name!r} is already registered; pass "
            f"overwrite=True to replace it")
    _REGISTRY[hardware.name] = hardware
    return hardware


def get(name: str) -> Hardware:
    """Look a spec up by name; ``KeyError`` lists the known names."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown hardware {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def names() -> tuple[str, ...]:
    """Registered spec names, sorted."""
    return tuple(sorted(_REGISTRY))


def unregister(name: str) -> Hardware:
    """Remove and return a registered spec (mostly for tests)."""
    return _REGISTRY.pop(name)
