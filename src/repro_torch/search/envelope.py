"""Resource envelopes as data: the port's copy of ``ResourceEnvelope``.

Every :class:`repro_torch.hw.Hardware` spec carries one (presets
included), and it survives ``to_json``/``from_json`` byte for byte so a
spec written by the reference package reads back here unchanged.  The
feasibility masks and the usage model that consume envelopes wait for the
slice that ports constrained search.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping

#: The usage columns an envelope caps, in canonical order.
USAGE_COLUMNS = ("lsu_ports", "interconnect_bytes", "dram_channels",
                 "buffer_bytes")

#: Bump when a field is added/renamed so persisted envelopes are identifiable.
ENVELOPE_SCHEMA = 1


@dataclasses.dataclass(frozen=True)
class ResourceEnvelope:
    """A hard resource budget; ``None`` caps nothing."""

    lsu_ports: float | None = None
    interconnect_bytes: float | None = None
    dram_channels: float | None = None
    buffer_bytes: float | None = None

    def __post_init__(self):
        for name in USAGE_COLUMNS:
            cap = getattr(self, name)
            if cap is not None and not float(cap) >= 0:
                raise ValueError(f"envelope cap {name}={cap!r} must be >= 0")

    def to_dict(self) -> dict:
        return {"schema": ENVELOPE_SCHEMA,
                **{name: getattr(self, name) for name in USAGE_COLUMNS}}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, obj: Mapping[str, Any]) -> "ResourceEnvelope":
        schema = obj.get("schema", ENVELOPE_SCHEMA)
        if schema > ENVELOPE_SCHEMA:
            raise ValueError(
                f"ResourceEnvelope schema {schema} is newer than this "
                f"library's {ENVELOPE_SCHEMA}")

        def _num(v):
            # keep int caps int so to_json(from_json(x)) == x byte-for-byte
            if v is None or (isinstance(v, (int, float))
                             and not isinstance(v, bool)):
                return v
            return float(v)

        return cls(**{name: _num(obj.get(name)) for name in USAGE_COLUMNS})

    @classmethod
    def from_json(cls, text: str) -> "ResourceEnvelope":
        return cls.from_dict(json.loads(text))
