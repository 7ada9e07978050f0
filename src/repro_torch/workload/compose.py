"""Compose walked op records into scored phase reports.

Port of ``repro.workload.compose``.  Each op with DRAM traffic becomes one
:class:`repro_torch.api.Design` via the same class -> LSU-group mapping the
validation harness uses (``Design.from_classes``), all ops of a phase are
scored in **one** ``Session.estimate_many`` batched pass (one segment sum
on the session's device, not one launch sequence per op), and the phase
total is the plain sum of the per-op times — by construction equal to
summing individual ``Session.estimate`` calls.

FLOPs-only ops (fusion-internal compute with no materialized traffic)
carry no memory estimate; their FLOPs still enter the phase's
``t_compute`` roofline floor, and they are counted in ``n_flops_only``.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.api import Design, Session
from repro_torch.workload.report import ModelReport, OpEstimate, PhaseReport
from repro_torch.workload.walker import OpRecord

__all__ = ["designs_from_records", "compose_phase", "compose_model"]


def designs_from_records(
        records: Sequence[OpRecord], *,
        access_bytes: int | None = None,
) -> tuple[list[tuple[OpRecord, Design]], list[OpRecord]]:
    """(record, Design) pairs for every op with traffic, plus the
    flops-only leftovers.  Collective-only ops never become designs —
    their cost is interconnect, not DRAM."""
    pairs: list[tuple[OpRecord, Design]] = []
    rest: list[OpRecord] = []
    for r in records:
        if r.total_bytes > 0:
            d = Design.from_classes(r.bytes_by_class,
                                    access_bytes=access_bytes,
                                    flops=r.flops, name=r.path)
            pairs.append((r, d))
        else:
            rest.append(r)
    return pairs, rest


def compose_phase(session: Session, name: str,
                  records: Sequence[OpRecord], *,
                  access_bytes: int | None = None) -> PhaseReport:
    """Score one phase's records on the session's backend and hardware."""
    pairs, rest = designs_from_records(records, access_bytes=access_bytes)
    estimates = session.estimate_many([d for _, d in pairs])
    ops = tuple(OpEstimate(record=r, design=d, estimate=e)
                for (r, d), e in zip(pairs, estimates))

    bytes_by_class: dict[str, float] = {}
    for r, _ in pairs:
        for cls, b in r.bytes_by_class.items():
            bytes_by_class[cls] = bytes_by_class.get(cls, 0.0) + b
    flops = sum(r.flops for r in records)
    trans = sum(r.transcendentals for r in records)
    wire = sum(r.collective_wire_bytes for r in records)
    n_coll = sum(r.n_collectives for r in records)

    hw = session.hw
    t_collective = (wire / (hw.ici_bw * hw.ici_links)
                    + n_coll * hw.ici_hop_latency) if n_coll else 0.0
    return PhaseReport(
        name=name, ops=ops, n_flops_only=len(rest),
        flops=float(flops), transcendentals=float(trans),
        bytes_by_class=bytes_by_class,
        t_memory=float(sum(op.t_exe for op in ops)),
        t_compute=float(flops) / hw.peak_flops,
        t_collective=float(t_collective),
        collective_wire_bytes=float(wire), n_collectives=float(n_coll),
        backend=session.backend,
        peak_bandwidth=float(session.dram.bw_mem))


def compose_model(session: Session, name: str,
                  phase_records: dict[str, Sequence[OpRecord]], *,
                  access_bytes: int | None = None) -> ModelReport:
    """All phases of one model, each composed on the same session."""
    from repro_torch.core import validate as _validate

    phases = tuple(compose_phase(session, pname, recs,
                                 access_bytes=access_bytes)
                   for pname, recs in phase_records.items())
    hw_name = (session.hardware.name if session.hardware is not None
               else session.dram.name)
    return ModelReport(
        name=name, phases=phases, backend=session.backend,
        hardware=hw_name,
        access_bytes=access_bytes or _validate.ACCESS_BYTES,
        ridge_intensity=session.hw.peak_flops / session.hw.hbm_bw)
