"""Whole-model result family: per-op estimates composed into phase and
model reports.  Port of ``repro.workload.report``.

The contract that makes composition auditable: a phase's ``t_memory`` is
*defined* as the plain sum of its per-op ``Estimate.t_exe`` values, in op
order — so ``ModelReport`` totals always equal the sum of the per-op
``Session.estimate`` calls that produced them (the acceptance invariant,
tested on all three backends).  Compute and collective terms are reported
alongside as roofline context, never silently folded into the total.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

from repro_torch.api import Design, Estimate, Report
from repro_torch.workload.walker import OP_CLASSES, OpRecord

__all__ = ["OpEstimate", "PhaseReport", "ModelReport"]


@dataclasses.dataclass(frozen=True)
class OpEstimate:
    """One op's record, the Design built from it, and its scored Estimate."""

    record: OpRecord
    design: Design
    estimate: Estimate

    @property
    def t_exe(self) -> float:
        return self.estimate.t_exe


@dataclasses.dataclass(frozen=True)
class PhaseReport(Report):
    """One phase (train / prefill / decode / ...) of a walked model.

    ``ops`` holds only ops with DRAM traffic (each scored through Eqs.
    1-10); ``n_flops_only`` counts the fusion-internal ops whose FLOPs
    entered ``t_compute`` without a memory estimate.  Times are seconds.
    """

    name: str
    ops: tuple[OpEstimate, ...]
    n_flops_only: int
    flops: float
    transcendentals: float
    bytes_by_class: Mapping[str, float]
    t_memory: float               # sum of per-op t_exe — the phase total
    t_compute: float              # flops / peak_flops roofline floor
    t_collective: float
    collective_wire_bytes: float
    n_collectives: float
    backend: str
    peak_bandwidth: float         # session DRAM bandwidth [B/s]
    kind = "phase"

    @property
    def n_ops(self) -> int:
        return len(self.ops) + self.n_flops_only

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_class.values()))

    @property
    def t_total(self) -> float:
        """Phase latency under the memory model — exactly
        ``sum(op.t_exe for op in ops)``."""
        return self.t_memory

    @property
    def t_roofline(self) -> float:
        """Latency if memory, compute and interconnect overlap perfectly."""
        return max(self.t_memory, self.t_compute, self.t_collective)

    @property
    def bottleneck(self) -> str:
        t = {"memory": self.t_memory, "compute": self.t_compute,
             "collective": self.t_collective}
        return max(t, key=t.get)

    @property
    def arithmetic_intensity(self) -> float:
        if not self.total_bytes:
            return math.inf if self.flops else 0.0
        return self.flops / self.total_bytes

    def by_class(self) -> list[dict]:
        """Per-op-class breakdown (time share, bytes, op count)."""
        acc: dict[str, dict] = {}
        for op in self.ops:
            d = acc.setdefault(op.record.op_class,
                               {"op_class": op.record.op_class, "n_ops": 0,
                                "bytes": 0.0, "t_exe": 0.0})
            d["n_ops"] += 1
            d["bytes"] += op.record.total_bytes
            d["t_exe"] += op.t_exe
        order = {c: i for i, c in enumerate(OP_CLASSES)}
        out = sorted(acc.values(), key=lambda d: order.get(d["op_class"], 99))
        for d in out:
            d["share"] = d["t_exe"] / self.t_memory if self.t_memory else 0.0
        return out

    def by_layer(self) -> list[dict]:
        """Per-scope breakdown: the layer scan shows up as one scope whose
        ``trips`` is the layer count, with per-trip time alongside.  A
        captured phase (the port's layers are unrolled) has one row per
        module, each with ``trips`` 1."""
        acc: dict[str, dict] = {}
        for op in self.ops:
            d = acc.setdefault(op.record.scope,
                               {"scope": op.record.scope,
                                "trips": op.record.trips,
                                "n_ops": 0, "bytes": 0.0, "t_exe": 0.0})
            d["n_ops"] += 1
            d["bytes"] += op.record.total_bytes
            d["t_exe"] += op.t_exe
        out = sorted(acc.values(), key=lambda d: -d["t_exe"])
        for d in out:
            d["t_per_trip"] = d["t_exe"] / d["trips"] if d["trips"] else 0.0
        return out

    def rows(self) -> list[dict]:
        t_total = self.t_memory
        return [{
            "phase": self.name,
            "op": op.record.name,
            "op_class": op.record.op_class,
            "scope": op.record.scope,
            "trips": op.record.trips,
            "total_bytes": op.record.total_bytes,
            "flops": op.record.flops,
            "t_exe_us": op.t_exe * 1e6,
            "share": op.t_exe / t_total if t_total else 0.0,
            "memory_bound": bool(op.estimate.memory_bound),
            "backend": self.backend,
        } for op in sorted(self.ops, key=lambda o: -o.t_exe)]

    def summary(self) -> dict:
        return {
            "kind": self.kind, "phase": self.name, "backend": self.backend,
            "n_ops": self.n_ops, "n_scored": len(self.ops),
            "t_total_ms": self.t_total * 1e3,
            "t_compute_ms": self.t_compute * 1e3,
            "t_collective_ms": self.t_collective * 1e3,
            "bottleneck": self.bottleneck,
            "total_bytes": self.total_bytes, "flops": self.flops,
            "arithmetic_intensity": self.arithmetic_intensity,
            "by_class": self.by_class(),
        }


@dataclasses.dataclass(frozen=True)
class ModelReport(Report):
    """End-to-end estimate of a walked model: one PhaseReport per compiled
    step, plus the aggregate roofline position.

    ``total_latency()`` (and each phase's ``t_total``) is the sum of the
    per-op Eqs. 1-10 estimates — the number the acceptance test compares
    against per-op ``Session.estimate`` calls.
    """

    name: str
    phases: tuple[PhaseReport, ...]
    backend: str
    hardware: str
    access_bytes: int
    ridge_intensity: float        # peak_flops / peak_bandwidth [flop/B]
    kind = "model"

    def phase(self, name: str) -> PhaseReport:
        for p in self.phases:
            if p.name == name:
                return p
        raise KeyError(f"no phase {name!r}; have "
                       f"{[p.name for p in self.phases]}")

    @property
    def phase_names(self) -> tuple[str, ...]:
        return tuple(p.name for p in self.phases)

    def total_latency(self, phase: str | None = None) -> float:
        """Summed memory-model latency [s] of one phase (or all phases)."""
        if phase is not None:
            return self.phase(phase).t_total
        return float(sum(p.t_total for p in self.phases))

    @property
    def flops(self) -> float:
        return float(sum(p.flops for p in self.phases))

    @property
    def total_bytes(self) -> float:
        return float(sum(p.total_bytes for p in self.phases))

    @property
    def arithmetic_intensity(self) -> float:
        if not self.total_bytes:
            return math.inf if self.flops else 0.0
        return self.flops / self.total_bytes

    @property
    def memory_bound(self) -> bool:
        """Aggregate roofline position: left of the ridge point."""
        return self.arithmetic_intensity < self.ridge_intensity

    def split(self) -> dict[str, float]:
        """Each phase's share of the summed latency (prefill-vs-decode
        split when those phases were walked)."""
        total = self.total_latency()
        return {p.name: (p.t_total / total if total else 0.0)
                for p in self.phases}

    def rows(self) -> list[dict]:
        return [r for p in self.phases for r in p.rows()]

    def summary(self) -> dict:
        return {
            "kind": self.kind, "model": self.name, "backend": self.backend,
            "hardware": self.hardware,
            "t_total_ms": self.total_latency() * 1e3,
            "split": self.split(),
            "arithmetic_intensity": self.arithmetic_intensity,
            "ridge_intensity": self.ridge_intensity,
            "memory_bound": self.memory_bound,
            "phases": {p.name: p.summary() for p in self.phases},
        }


def op_table(phase: PhaseReport, top: int = 12) -> str:
    """Readable per-class table for examples/README (not part of the API
    surface promise; formatting only)."""
    lines = [f"phase={phase.name}  t_total={phase.t_total * 1e3:.3f} ms  "
             f"bottleneck={phase.bottleneck}",
             f"{'op class':<12} {'ops':>4} {'MiB':>10} "
             f"{'t [us]':>10} {'share':>7}"]
    for d in phase.by_class()[:top]:
        lines.append(f"{d['op_class']:<12} {d['n_ops']:>4} "
                     f"{d['bytes'] / 2**20:>10.2f} "
                     f"{d['t_exe'] * 1e6:>10.1f} {d['share']:>6.1%}")
    return "\n".join(lines)
