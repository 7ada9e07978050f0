"""Resource envelopes as data: the budget side and the usage side.

Port of ``repro.search.envelope``:

* :class:`ResourceEnvelope` — a frozen, hashable budget over the four
  resources the microbenchmark family consumes (LSU ports, interconnect
  bytes, DRAM channels, transaction-buffer bytes; ``None`` caps nothing).
  Every :class:`repro_torch.hw.Hardware` spec carries one, and it survives
  ``to_json``/``from_json`` byte for byte, so a spec or a constraint
  written by the reference package reads back here unchanged.
* The **usage model** — :func:`usage_from_axes` (vectorized over sweep
  columns, NumPy or torch; what the feasibility mask and the optimizer's
  penalties evaluate) and :func:`usage_of_design` (one design).  One port
  and ``ls_width`` interconnect bytes per global LSU, one max-size
  transaction buffer per burst-coalesced LSU (``2**burst_cnt * dq * bl``
  bytes), ``ls_width`` buffer bytes for atomic units, and one DRAM channel
  whenever the design issues global traffic.

Import-light (numpy + stdlib): :mod:`repro_torch.hw.spec` imports it while
:mod:`repro_torch.hw` is still loading, so the type codes and torch are
imported inside the functions that need them.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping

import numpy as np

#: The usage columns a feasibility mask can read, in canonical order.
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

    def caps(self) -> dict[str, float]:
        """The bounded columns only: column name -> cap."""
        return {name: float(getattr(self, name)) for name in USAGE_COLUMNS
                if getattr(self, name) is not None}

    def admits(self, usage: Mapping[str, Any]) -> np.ndarray:
        """Vectorized ``usage <= cap`` over every bounded column."""
        caps = self.caps()
        if not caps:
            probe = next(iter(usage.values()), np.ones(0))
            return np.ones(np.shape(np.asarray(probe)), dtype=bool)
        mask: np.ndarray | None = None
        for name, cap in caps.items():
            ok = np.asarray(usage[name], dtype=np.float64) <= cap
            mask = ok if mask is None else (mask & ok)
        return mask

    def constraint(self):
        """This envelope as a
        :class:`repro_torch.search.constraints.Constraint`."""
        from repro_torch.search.constraints import EnvelopeConstraint

        return EnvelopeConstraint(self)

    # -- serialization ------------------------------------------------------

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


def max_transaction_bytes(dq, bl, burst_cnt):
    """Per-burst-LSU transaction buffer [B]: ``2**burst_cnt * dq * bl``
    (vectorized, float64; paper Table II's BURSTCOUNT_WIDTH)."""
    return (2.0 ** np.asarray(burst_cnt, dtype=np.float64)
            * np.asarray(dq, dtype=np.float64)
            * np.asarray(bl, dtype=np.float64))


def usage_from_axes(*, type_codes, n_ga, simd, elem_bytes, include_write,
                    max_txn) -> dict[str, Any]:
    """Per-point resource usage from sweep-axis columns (vectorized).

    Inputs are per-point NumPy arrays, or torch tensors (float64 where
    they are relaxed), in which case every column is a tensor on the
    inputs' device and differentiable for the optimizer's penalties.
    ``type_codes`` are :data:`repro_torch.core.model_batch.TYPE_CODE`
    integers and ``max_txn`` the burst-buffer size of each point's
    effective DRAM/BSP.  ``interconnect_bytes`` equals the sweep's
    ``resource`` column, so a mask computed here is bit-equal to
    post-filtering scored results.
    """
    from repro_torch.core import model_batch as _mb

    if any(type(x).__module__.startswith("torch")
           for x in (type_codes, n_ga, simd, elem_bytes, max_txn)):
        import torch

        dev = next(x.device for x in (type_codes, n_ga, simd, elem_bytes,
                                      max_txn) if isinstance(x, torch.Tensor))
        asarray = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
        as_bool = lambda x: asarray(x).to(torch.bool)       # noqa: E731
        where, zeros_like, ones_like = (torch.where, torch.zeros_like,
                                        torch.ones_like)
    else:
        asarray = np.asarray
        as_bool = lambda x: np.asarray(x, dtype=bool)        # noqa: E731
        where, zeros_like, ones_like = np.where, np.zeros_like, np.ones_like
    type_codes = asarray(type_codes)
    n_ga = asarray(n_ga)
    simd = asarray(simd)
    elem_bytes = asarray(elem_bytes)
    max_txn = asarray(max_txn)
    is_atomic = type_codes == _mb.ATOMIC
    is_ack = type_codes == _mb.WRITE_ACK
    # include_write is inert for atomics (the atomic IS the write)
    iw = as_bool(include_write) & ~is_atomic

    g1_count = where(is_atomic | is_ack, n_ga, n_ga + iw)
    g1_width = where(is_atomic, elem_bytes, simd * elem_bytes)
    g2_count = where(is_ack & iw, simd, zeros_like(simd))

    ports = g1_count + g2_count
    interconnect = g1_count * g1_width + g2_count * elem_bytes
    # Burst-coalesced LSUs buffer one max transaction each; atomic units
    # buffer one element-wide beat.  The ACK store group is burst-typed.
    g1_buf = where(is_atomic, g1_width, max_txn)
    buffer_bytes = g1_count * g1_buf + g2_count * max_txn
    channels = where(ports > 0, ones_like(max_txn), zeros_like(max_txn))
    return {"lsu_ports": ports, "interconnect_bytes": interconnect,
            "dram_channels": channels, "buffer_bytes": buffer_bytes}


def usage_of_design(design, dram=None, bsp=None) -> dict[str, float]:
    """Resource usage of one :class:`repro_torch.Design` (scalar totals).

    ``dram``/``bsp`` size the burst buffers (the design's own overrides
    win; both default to the library's default board).
    """
    dram = design.dram or dram
    bsp = design.bsp or bsp
    if dram is None or bsp is None:
        from repro_torch.hw import DEFAULT_BOARD, get as _hw_get

        board = _hw_get(DEFAULT_BOARD)
        dram = dram or board.dram_params()
        bsp = bsp or board.bsp_params()
    txn = float(max_transaction_bytes(dram.dq, dram.bl, bsp.burst_cnt))
    ports = interconnect = buffer_bytes = 0.0
    for lsu in design.lsus:
        if not lsu.lsu_type.is_global:
            continue
        ports += 1
        interconnect += lsu.ls_width
        buffer_bytes += txn if lsu.lsu_type.is_burst else lsu.ls_width
    return {"lsu_ports": ports, "interconnect_bytes": interconnect,
            "dram_channels": 1.0 if ports else 0.0,
            "buffer_bytes": buffer_bytes}
