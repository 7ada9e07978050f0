"""Three-term roofline report per (architecture x shape x mesh) cell.

Port of ``repro.core.roofline``.  Terms follow the mandated formulas
(per-device / per-chip semantics — the compiled SPMD module *is* the
per-chip program):

    compute term    = HLO_FLOPs            / peak_FLOP/s          [s]
    memory term     = HLO_bytes            / HBM_bw               [s]
    collective term = collective_bytes     / link_bw              [s]

plus the refined memory term from the paper's access-class model
(``predictor.predict_step``) and bookkeeping:

    MODEL_FLOPS     = 6 * N(_active) * D   (train)  /  2 * N * D  (serve)
    MODEL_BYTES     = algorithmic-minimum HBM traffic (config.model_bytes)
    useful-FLOPs    = MODEL_FLOPS / (HLO_FLOPs * chips)
    useful-bytes    = MODEL_BYTES / (HLO_bytes * chips)
    roofline fraction = ideal-time-on-dominant-resource / t_step
                        (classical MFU when compute-dominant)
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

from repro_torch.core.hbm import TpuParams, _as_tpu_params
from repro_torch.core import predictor as _pred


def _chip() -> TpuParams:
    """The registry default chip's view (was the TPU_V5E constant)."""
    return _as_tpu_params(None)


@dataclasses.dataclass
class RooflineCell:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    collective_operand_bytes: float   # formula-mandated "operand sizes" sum
    collective_wire_bytes: float
    n_collectives: int
    model_flops_global: float
    model_bytes_global: float = 0.0
    t_compute: float = 0.0
    t_memory_naive: float = 0.0
    t_memory_refined: float = 0.0
    t_collective: float = 0.0
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)
    hw: TpuParams | None = None   # the chip the terms were computed against

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory_refined or self.t_memory_naive,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def t_step(self) -> float:
        return max(self.t_compute, self.t_memory_refined or self.t_memory_naive,
                   self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        hlo_global = self.flops_per_chip * self.chips
        return self.model_flops_global / hlo_global if hlo_global else 0.0

    @property
    def useful_bytes_ratio(self) -> float:
        """MODEL_BYTES / (HLO bytes x chips) — how much of the compiled
        traffic is algorithmically necessary (catches scan-carry spills,
        resharding copies, f32 legalization)."""
        hlo_global = self.bytes_per_chip * self.chips
        return (self.model_bytes_global / hlo_global) if hlo_global else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the dominant roofline used by *useful* work:
        compute-dominant -> classical MFU (MODEL_FLOPS time / t_step);
        memory-dominant  -> MODEL_BYTES time / t_step;
        collective-dominant -> wire-ideal / t_step."""
        if self.t_step <= 0:
            return 0.0
        chip = self.hw if self.hw is not None else _chip()
        if self.dominant == "compute":
            ideal = self.model_flops_global / (self.chips * chip.peak_flops)
        elif self.dominant == "memory":
            if self.model_bytes_global:
                ideal = self.model_bytes_global / (self.chips * chip.hbm_bw)
            else:
                ideal = self.t_memory_naive
        else:
            ideal = self.collective_wire_bytes / (chip.ici_bw * chip.ici_links)
        return min(1.0, ideal / self.t_step)

    def as_row(self) -> dict[str, Any]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory_naive,
            "t_memory_refined_s": self.t_memory_refined,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "t_step_s": self.t_step,
            "hlo_flops_per_chip": self.flops_per_chip,
            "hlo_bytes_per_chip": self.bytes_per_chip,
            "collective_operand_bytes": self.collective_operand_bytes,
            "collective_wire_bytes": self.collective_wire_bytes,
            "model_flops_global": self.model_flops_global,
            "model_bytes_global": self.model_bytes_global,
            "useful_flops_ratio": self.useful_flops_ratio,
            "useful_bytes_ratio": self.useful_bytes_ratio,
            "roofline_fraction": self.roofline_fraction,
            **self.extra,
        }


def build_cell(
    *,
    arch: str,
    shape: str,
    mesh: str,
    chips: int,
    hlo_text: str,
    cost: dict[str, float] | None = None,
    model_flops_global: float,
    hw: TpuParams | None = None,
    extra: dict[str, Any] | None = None,
) -> RooflineCell:
    """Cell from compiled HLO text (trip-aware static analysis; the raw
    ``cost_analysis`` dict is kept in ``extra`` for cross-checking)."""
    hw = _as_tpu_params(hw)
    pred = _pred.predict_step(hlo_text, cost, hw)
    flops = pred.flops
    nbytes = pred.hbm_bytes
    extra = dict(extra or {})
    if cost:
        extra.setdefault("xla_cost_flops", cost.get("flops"))
        extra.setdefault("xla_cost_bytes", cost.get("bytes_accessed"))
    return RooflineCell(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        flops_per_chip=flops,
        bytes_per_chip=nbytes,
        collective_operand_bytes=pred.collective_operand_bytes,
        collective_wire_bytes=pred.collective_wire_bytes,
        n_collectives=pred.n_collectives,
        model_flops_global=model_flops_global,
        t_compute=flops / hw.peak_flops,
        t_memory_naive=nbytes / hw.hbm_bw,
        t_memory_refined=pred.t_memory,
        t_collective=pred.t_collective,
        extra=extra or {},
        hw=hw,
    )


def write_report(cells: list[RooflineCell], path: str) -> None:
    with open(path, "w") as f:
        json.dump([c.as_row() for c in cells], f, indent=1, default=float)


def markdown_table(cells: list[RooflineCell]) -> str:
    hdr = ("| arch | shape | mesh | compute [ms] | memory [ms] | refined-mem [ms] "
           "| collective [ms] | dominant | useful-FLOPs | roofline-frac |")
    sep = "|" + "---|" * 10
    rows = [hdr, sep]
    for c in cells:
        rows.append(
            f"| {c.arch} | {c.shape} | {c.mesh} | {c.t_compute*1e3:.2f} "
            f"| {c.t_memory_naive*1e3:.2f} | {c.t_memory_refined*1e3:.2f} "
            f"| {c.t_collective*1e3:.2f} | {c.dominant} "
            f"| {c.useful_flops_ratio:.2f} | {c.roofline_fraction:.2f} |"
        )
    return "\n".join(rows)
