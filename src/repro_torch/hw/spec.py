"""The unified, serializable memory-system description: the ``Hardware`` spec.

The port's copy of ``repro.hw.spec``.  ``Hardware`` composes three parts:

* :class:`MemorySystem`   — per-access-class bandwidth efficiencies (the
  ``K_lsu`` analogue) + per-transaction overheads and capacities;
* :class:`DramOrganization` — channel/bank/burst geometry and the datasheet
  timings (paper Tables II-III);
* :class:`ClockDomain`    — BSP/IP parameters and the clock-side numbers.

It renders itself as the legacy parameter views the model consumes
(:meth:`Hardware.dram_params`, :meth:`Hardware.bsp_params`,
:meth:`Hardware.tpu_params`), reads and writes the same JSON as the
reference package (``to_json``/``from_json``), and folds a validation
report back into a persistable spec (:meth:`Hardware.from_calibration`).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Mapping

from repro_torch.core.fpga import BspParams, DramParams
from repro_torch.core.hbm import TpuParams
from repro_torch.search.envelope import ResourceEnvelope

#: Bump when a field is added/renamed so persisted specs are identifiable.
SCHEMA_VERSION = 1

#: Validation-kernel name -> the access class its error calibrates.
_KERNEL_CLASS = {
    "membench_aligned": "stream",
    "membench_strided": "strided",
    "membench_gather": "gather",
}


@dataclasses.dataclass(frozen=True)
class MemorySystem:
    """Bandwidth side of the spec: efficiencies + transaction overheads."""

    peak_bw: float                  # interface bandwidth ceiling [B/s]
    txn_bytes: int = 512            # transaction granularity [B]
    t_row: float = 28e-9            # row-miss latency class [s]
    mlp: int = 64                   # outstanding-transaction parallelism
    k_stream: float = 0.92          # per-class efficiencies (K_lsu analogue)
    k_strided: float = 0.92
    k_gather: float = 0.92
    capacity_bytes: float = 16e9    # device memory capacity [B]
    local_bytes: float = 128e6      # on-chip memory (VMEM / BRAM) [B]


@dataclasses.dataclass(frozen=True)
class DramOrganization:
    """Geometry + datasheet timings of the DRAM behind the interface."""

    name: str = "dram"
    f_mem: float = 933.3e6          # I/O bus clock [Hz]
    dq: int = 8                     # data width [B]
    bl: int = 8                     # burst length [beats]
    t_rcd: float = 13.5e-9          # row activation [s]
    t_rp: float = 13.5e-9           # precharge [s]
    t_wr: float = 15e-9             # write recovery [s]
    channels: int = 1
    banks: int = 4
    row_bytes: int = 8192           # page size per bank [B]
    interleave_bytes: int = 1024    # controller interleave granularity [B]

    @property
    def bw_mem(self) -> float:
        """Peak DRAM bandwidth [B/s] across all channels (Eq. 2)."""
        return self.dq * 2.0 * self.f_mem * self.channels

    @property
    def t_row(self) -> float:
        """Row-miss inter-command delay (Eq. 6): T_RCD + T_RP."""
        return self.t_rcd + self.t_rp

    @property
    def min_burst_bytes(self) -> int:
        return self.dq * self.bl


@dataclasses.dataclass(frozen=True)
class ClockDomain:
    """BSP/IP parameters and the clock-side constants."""

    burst_cnt: int = 4              # log2(max #min-bursts per transaction)
    max_th: int = 128               # max coalesced threads per request
    f_kernel: float = 300e6         # kernel/fabric clock [Hz]
    peak_flops: float = 197e12      # chip compute peak [FLOP/s]
    ici_bw: float = 50e9            # interconnect [B/s per link]
    ici_links: int = 4
    ici_hop_latency: float = 1e-6   # per-hop collective launch latency [s]


def _clamp_k(k: float) -> float:
    return min(1.0, max(1e-3, float(k)))


@dataclasses.dataclass(frozen=True)
class Hardware:
    """One complete, serializable memory-system description.

    ``host_factor`` is the persisted calibration scalar (measured/modeled
    on the stream anchor, 1.0 = uncalibrated); ``envelope`` the spec's
    hard resource budget (``None`` = unconstrained).
    """

    name: str
    mem: MemorySystem
    dram: DramOrganization = DramOrganization()
    clock: ClockDomain = ClockDomain()
    host_factor: float = 1.0
    envelope: ResourceEnvelope | None = None

    def __post_init__(self):
        if not self.name:
            raise ValueError("a Hardware spec needs a non-empty name")
        if not self.host_factor > 0:
            raise ValueError("host_factor must be > 0")

    # -- builder-style derivation ------------------------------------------

    def with_name(self, name: str) -> "Hardware":
        return dataclasses.replace(self, name=name)

    def with_host_factor(self, host_factor: float) -> "Hardware":
        return dataclasses.replace(self, host_factor=float(host_factor))

    def with_efficiencies(self, **k: float) -> "Hardware":
        """Replace per-class efficiency factors: ``with_efficiencies(
        k_stream=0.9, k_gather=0.5)`` (values clamped to (0, 1])."""
        unknown = set(k) - {"k_stream", "k_strided", "k_gather"}
        if unknown:
            raise TypeError(f"unknown efficiency factors: {sorted(unknown)}")
        return dataclasses.replace(
            self, mem=dataclasses.replace(
                self.mem, **{n: _clamp_k(v) for n, v in k.items()}))

    # -- legacy parameter views --------------------------------------------

    def dram_params(self) -> DramParams:
        """The faithful-FPGA-model view; multi-channel organizations fold
        ``channels`` into the clock so ``bw_mem`` stays the aggregate."""
        d = self.dram
        return DramParams(
            name=d.name, f_mem=d.f_mem * d.channels, dq=d.dq, bl=d.bl,
            t_rcd=d.t_rcd, t_rp=d.t_rp, t_wr=d.t_wr,
            banks=d.banks, row_bytes=d.row_bytes)

    def bsp_params(self) -> BspParams:
        """The BSP/IP view."""
        return BspParams(burst_cnt=self.clock.burst_cnt,
                         max_th=self.clock.max_th)

    def tpu_params(self) -> TpuParams:
        """The TPU-transplant view."""
        m, c = self.mem, self.clock
        return TpuParams(
            name=self.name, peak_flops=c.peak_flops, hbm_bw=m.peak_bw,
            ici_bw=c.ici_bw, ici_links=c.ici_links,
            hbm_bytes=m.capacity_bytes, vmem_bytes=m.local_bytes,
            txn_bytes=m.txn_bytes, t_row=m.t_row, mlp=m.mlp,
            ici_hop_latency=c.ici_hop_latency,
            k_stream=m.k_stream, k_strided=m.k_strided, k_gather=m.k_gather)

    # -- construction -------------------------------------------------------

    @classmethod
    def from_calibration(cls, report: Any, *,
                         base: "Hardware | None" = None,
                         name: str | None = None) -> "Hardware":
        """Fold a validation report back into a persistable spec.

        The report's fitted DRAM parameter set becomes the organization,
        its stream-anchor bandwidth the memory system's ``peak_bw``, its
        host factor the persisted ``host_factor``, and each class-pure
        membench kernel's predicted/measured ratio scales that class's
        efficiency factor.
        """
        from repro_torch.hw.registry import get as _get

        base = base if base is not None else _get("stratix10_ddr4_1866")
        d: DramParams = report.dram
        org = DramOrganization(
            name=d.name, f_mem=d.f_mem, dq=d.dq, bl=d.bl,
            t_rcd=d.t_rcd, t_rp=d.t_rp, t_wr=d.t_wr,
            banks=d.banks, row_bytes=d.row_bytes,
            interleave_bytes=base.dram.interleave_bytes)
        k = {"k_stream": base.mem.k_stream, "k_strided": base.mem.k_strided,
             "k_gather": base.mem.k_gather}
        for r in report.results:
            cls_name = _KERNEL_CLASS.get(r.name)
            if cls_name and r.measured_s > 0 and r.predicted_s > 0:
                k[f"k_{cls_name}"] = _clamp_k(
                    k[f"k_{cls_name}"] * r.predicted_s / r.measured_s)
        measured_bw = float(getattr(report, "measured_bw", 0.0) or 0.0)
        mem = dataclasses.replace(
            base.mem, peak_bw=measured_bw or org.bw_mem, **k)
        return cls(
            name=name or f"{base.name}-calibrated",
            mem=mem, dram=org, clock=base.clock,
            host_factor=float(getattr(report, "calibration_factor", 1.0)))

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> dict:
        """JSON-able dict (stable keys; includes the schema version)."""
        out = {
            "schema": SCHEMA_VERSION,
            "name": self.name,
            "host_factor": self.host_factor,
            "mem": dataclasses.asdict(self.mem),
            "dram": dataclasses.asdict(self.dram),
            "clock": dataclasses.asdict(self.clock),
        }
        if self.envelope is not None:
            out["envelope"] = self.envelope.to_dict()
        return out

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, obj: Mapping[str, Any]) -> "Hardware":
        schema = obj.get("schema", SCHEMA_VERSION)
        if schema > SCHEMA_VERSION:
            raise ValueError(
                f"Hardware spec schema {schema} is newer than this "
                f"library's {SCHEMA_VERSION}")

        def _load(klass, data):
            known = {f.name for f in dataclasses.fields(klass)}
            return klass(**{k: v for k, v in dict(data).items() if k in known})

        env = obj.get("envelope")
        return cls(
            name=str(obj["name"]),
            mem=_load(MemorySystem, obj["mem"]),
            dram=_load(DramOrganization, obj["dram"]),
            clock=_load(ClockDomain, obj["clock"]),
            host_factor=float(obj.get("host_factor", 1.0)),
            envelope=(ResourceEnvelope.from_dict(env)
                      if env is not None else None))

    @classmethod
    def from_json(cls, text: str) -> "Hardware":
        return cls.from_dict(json.loads(text))
