"""Walk a compiled model step into per-op traffic records.

Port of ``repro.workload.walker``: the same records, field for field, for
the same HLO text, over the port's own ``core/hlo_counter.py``.  The
port's own model steps are captured op by op instead
(:mod:`repro_torch.workload.capture`), into the same :class:`OpRecord`.

``hlo_counter.analyze`` answers "how many bytes does this module move, by
access class" with one aggregate :class:`HloCost`.  Whole-model estimation
needs the *per-op* decomposition of the same numbers: each materialized
instruction becomes one :class:`OpRecord` carrying its whole-step byte
totals (per-execution cost x loop trips), its FLOPs, and enough identity
(scope path, opcode, op class) to attribute time back to layers and op
families in the report.

The walk recurses through control flow exactly the way the aggregate
analyzer does — ``while`` bodies multiply by the recovered trip count,
``call``/``conditional`` recurse into callees — and charges every leaf via
the same ``Analyzer._instr_cost``, so the sum of all records equals
``analyze(text)`` (tested; equality is up to float summation order).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

from repro_torch.core import hlo_counter as _hc
from repro_torch.core.hlo import COLLECTIVE_KINDS

__all__ = ["OpRecord", "walk_module", "OP_CLASSES"]

#: The op taxonomy the per-class breakdown reports over.
OP_CLASSES = ("matmul", "collective", "gather", "dynamic", "layout",
              "reduce", "fused", "elementwise", "other")


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One materialized instruction's whole-step cost.

    ``trips`` is the product of enclosing loop trip counts; every numeric
    field below is already multiplied by it (whole-step totals, not
    per-execution).  ``scope`` is the enclosing computation path — ops
    inside the layer scan share a scope, which is what the per-layer
    breakdown groups by.  A captured record's ``scope`` is its module path
    (``layers.3.attn``) and its ``trips`` 1.
    """

    path: str                 # scope + instruction name (unique per record)
    opcode: str
    op_class: str             # one of OP_CLASSES
    scope: str
    trips: float
    flops: float
    bytes_by_class: Mapping[str, float]
    transcendentals: float = 0.0
    collective_operand_bytes: float = 0.0
    collective_wire_bytes: float = 0.0
    n_collectives: float = 0.0

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_class.values()))

    @property
    def name(self) -> str:
        return self.path.rsplit("/", 1)[-1]


def _op_class(an: _hc.Analyzer, ins: _hc.Instr) -> str:
    op = ins.opcode
    base = op[:-6] if op.endswith("-start") else op
    if base in COLLECTIVE_KINDS:
        return "collective"
    if op in ("dot", "convolution"):
        return "matmul"
    if op == "fusion":
        callee = _hc._called(ins.rest, "calls") or ""
        comp = an.comps.get(callee)
        if comp is not None and any(
                i.opcode in ("dot", "convolution") for i in comp.instrs):
            return "matmul"
        return {"gather": "gather", "strided": "layout",
                "stream": "fused"}[an._fusion_class(callee)]
    if op in _hc._CLASS_GATHER:
        return "gather"
    if op in ("dynamic-slice", "dynamic-update-slice"):
        return "dynamic"
    if op in ("reduce", "reduce-window"):
        return "reduce"
    if op in _hc._CLASS_STRIDED:
        return "layout"
    if op in _hc._ELEMENTWISE_FLOPS:
        return "elementwise"
    return "other"


def _walk_comp(an: _hc.Analyzer, comp: _hc.Computation, mult: float,
               path: str, out: list[OpRecord]) -> None:
    for ins in comp.instrs:
        op = ins.opcode
        if op == "while":
            body = an.comps.get(_hc._called(ins.rest, "body") or "")
            cond = an.comps.get(_hc._called(ins.rest, "condition") or "")
            trips = _hc._while_trips(cond) if cond else 1
            sub = f"{path}/{ins.name}"
            if body is not None:
                _walk_comp(an, body, mult * trips, sub, out)
            if cond is not None:
                _walk_comp(an, cond, mult * trips, sub + ".cond", out)
            continue
        if op in ("call", "conditional"):
            for key in ("to_apply", "true_computation",
                        "false_computation", "branch_computations"):
                callee = _hc._called(ins.rest, key)
                if callee and callee in an.comps:
                    _walk_comp(an, an.comps[callee], mult,
                               f"{path}/{ins.name}", out)
            continue
        cost = an._instr_cost(ins, comp)
        if not (cost.flops or cost.bytes_by_class or cost.n_collectives
                or cost.transcendentals):
            continue
        scaled = cost.scaled(mult)
        out.append(OpRecord(
            path=f"{path}/{ins.name}", opcode=op,
            op_class=_op_class(an, ins), scope=path, trips=mult,
            flops=scaled.flops, bytes_by_class=dict(scaled.bytes_by_class),
            transcendentals=scaled.transcendentals,
            collective_operand_bytes=scaled.collective_operand_bytes,
            collective_wire_bytes=scaled.collective_wire_bytes,
            n_collectives=scaled.n_collectives))


def walk_module(hlo_text: str, *, fused: bool = True) -> list[OpRecord]:
    """Per-op records for one compiled module (entry computation walk).

    A degenerate module (no parseable ENTRY — e.g. a fully constant-folded
    decode step) yields an empty list, mirroring the hardened
    ``Analyzer.entry_cost``.
    """
    an = _hc.Analyzer(hlo_text, fused=fused)
    entry = an.entry_comp()
    records: list[OpRecord] = []
    if entry is not None:
        _walk_comp(an, entry, 1.0, entry.name, records)
    return records
