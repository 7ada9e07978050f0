"""Step-time prediction from compiled (never executed) artifacts.

Port of ``repro.core.predictor``.  `predict_step()` is the paper's Eq. 1
pipeline transplanted to an XLA-compiled step; the public surface is
``repro_torch.Session.predict``:

  1. statically analyze the compiled module with the trip-count-aware HLO
     counter (`hlo_counter.analyze` -- the LSU-type report reader; XLA's own
     ``cost_analysis`` under-counts scan bodies by the trip count);
  2. apply the two-term access-class model (`hbm.traffic_time` -- the
     Eq. 2 / Eq. 4-10 transplant) to the per-class byte totals;
  3. add the collective family (`wire bytes / ICI bw + hop latency`) -- the
     beyond-paper extension for the pod interconnect;
  4. the memory-bound criterion (Eq. 3 analogue) compares the resulting
     resource times (arithmetic intensity vs. the chip's ridge point).

All times are per-device seconds for one step.  ``cost`` (the
``compiled.cost_analysis()`` numbers, as plain data) is optional and only
recorded for cross-checks.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import hbm as _hbm
from repro_torch.core import hlo_counter as _hc
from repro_torch.core.hbm import AccessClass, TpuParams, Traffic, _as_tpu_params

_CLASS_BY_NAME = {
    "stream": AccessClass.STREAM,
    "strided": AccessClass.STRIDED,
    "gather": AccessClass.GATHER,
    "serialized": AccessClass.SERIALIZED,
}


@dataclasses.dataclass(frozen=True)
class StepPrediction:
    t_compute: float
    t_memory: float
    t_collective: float
    memory_components: tuple[Traffic, ...]
    flops: float
    hbm_bytes: float
    collective_wire_bytes: float
    collective_operand_bytes: float
    n_collectives: float
    collective_by_kind: dict
    xla_cost: dict

    @property
    def t_step_serial(self) -> float:
        return self.t_compute + self.t_memory + self.t_collective

    @property
    def t_step_overlapped(self) -> float:
        """Perfect overlap: the slowest resource wins (roofline assumption)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def memory_bound(self) -> bool:
        """Eq. 3 analogue."""
        return self.bottleneck != "compute"

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / self.hbm_bytes if self.hbm_bytes else float("inf")


def components_from_cost(hc: _hc.HloCost, *,
                         gather_row_bytes: float = 512.0) -> list[Traffic]:
    out = []
    for name, b in sorted(hc.bytes_by_class.items()):
        cls = _CLASS_BY_NAME.get(name, AccessClass.STREAM)
        row = gather_row_bytes if cls is not AccessClass.STREAM else 512.0
        out.append(Traffic(cls, b, row_bytes=row, name=name))
    return out


def predict_step(
    hlo_text: str,
    cost: dict | None = None,
    hw: TpuParams | None = None,
    *,
    gather_row_bytes: float = 512.0,
) -> StepPrediction:
    """Predict per-device step time from ``compiled.as_text()``.

    ``hw`` may be a :class:`TpuParams`, a ``repro_torch.hw.Hardware`` spec, or
    ``None`` (the registry's ``tpu_v5e`` preset).
    """
    hw = _as_tpu_params(hw)
    hc = _hc.analyze(hlo_text)
    comps = components_from_cost(hc, gather_row_bytes=gather_row_bytes)
    t_mem = _hbm.memory_time(comps, hw)
    t_coll = (hc.collective_wire_bytes / (hw.ici_bw * hw.ici_links)
              + hc.n_collectives * hw.ici_hop_latency)
    return StepPrediction(
        t_compute=hc.flops / hw.peak_flops,
        t_memory=t_mem,
        t_collective=t_coll,
        memory_components=tuple(comps),
        flops=hc.flops,
        hbm_bytes=hc.total_bytes,
        collective_wire_bytes=hc.collective_wire_bytes,
        collective_operand_bytes=hc.collective_operand_bytes,
        n_collectives=hc.n_collectives,
        collective_by_kind=dict(hc.collective_by_kind),
        xla_cost=dict(cost or {}),
    )


def record(pred) -> dict:
    """A :class:`StepPrediction` as plain JSON data: every field and derived
    property (attribute access only, so it reads any object with these
    fields)."""
    return {
        "t_compute": pred.t_compute,
        "t_memory": pred.t_memory,
        "t_collective": pred.t_collective,
        "t_step_serial": pred.t_step_serial,
        "t_step_overlapped": pred.t_step_overlapped,
        "bottleneck": pred.bottleneck,
        "memory_bound": pred.memory_bound,
        "arithmetic_intensity": pred.arithmetic_intensity,
        "memory_components": [
            [t.access_class.value, t.nbytes, t.row_bytes, t.name]
            for t in pred.memory_components],
        "flops": pred.flops,
        "hbm_bytes": pred.hbm_bytes,
        "collective_wire_bytes": pred.collective_wire_bytes,
        "collective_operand_bytes": pred.collective_operand_bytes,
        "n_collectives": pred.n_collectives,
        "collective_by_kind": dict(sorted(pred.collective_by_kind.items())),
        "xla_cost": dict(sorted(pred.xla_cost.items())),
    }
