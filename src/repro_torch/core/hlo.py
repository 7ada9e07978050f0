"""Compiled-HLO traffic extraction — the `aocl -rtl` report reader analogue.

Port of ``repro.core.hlo``.  The paper reads the early compilation report
(LSU types) and the generated Verilog (IP parameters) instead of waiting
for the bitstream.  Here the reader is the text of a compiled XLA module
(``compiled.as_text()``), taken as plain data — this package lowers nothing
itself:

* ``parse_collectives``  -- every all-gather / all-reduce / reduce-scatter /
  all-to-all / collective-permute in the module, with operand/result/wire
  byte counts and group sizes;
* ``classify_module``    -- per-access-class byte shares from opcode-level
  scanning (the LSU-type classification analogue);

Byte accounting notes:

* ``operand_bytes`` follows the grading formula ("sum operand sizes of every
  collective"); result-shape-derived when operand shapes are not printed.
* ``wire_bytes`` models ring algorithms: AG/A2A move (g-1)/g of the result,
  RS moves (g-1)x the shard, AR moves 2(g-1)/g of the tensor, CP moves the
  full tensor.  The refined roofline uses wire bytes; the baseline table
  reports the formula-mandated operand bytes as well.
"""
from __future__ import annotations

import dataclasses
import re
from collections import defaultdict
from typing import Iterable

_DTYPE_BYTES = {
    "pred": 1, "s2": 0.25, "u2": 0.25, "s4": 0.5, "u4": 0.5,
    "s8": 1, "u8": 1, "s16": 2, "u16": 2, "s32": 4, "u32": 4,
    "s64": 8, "u64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3b11fnuz": 1, "f8e4m3": 1, "f8e5m2fnuz": 1,
    "f8e4m3fnuz": 1, "f8e3m4": 1, "f8e8m0fnu": 1,
    "bf16": 2, "f16": 2, "f32": 4, "f64": 8,
    "c64": 8, "c128": 16,
    "token": 0, "opaque": 0,
}

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
# `%name = <shape-or-tuple> opcode(`  — post-optimization HLO instruction
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\(.*?\)|[a-z0-9]+\[[0-9,]*\](?:\{[^}]*\})?)\s*"
    r"([a-z][a-z0-9\-]*)\(",
    re.MULTILINE,
)
_REPLICA_GROUPS_RE = re.compile(r"replica_groups=\{(\{[^}]*\}(?:,\{[^}]*\})*)\}")
_IOTA_GROUPS_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]<=\[")

COLLECTIVE_KINDS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute", "collective-broadcast", "ragged-all-to-all",
)


def shape_bytes(shape_str: str) -> float:
    """Bytes of one HLO shape string, e.g. ``bf16[2,16,4096]{2,1,0}``.

    Tuple shapes sum their components."""
    total = 0.0
    for dtype, dims in _SHAPE_RE.findall(shape_str):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    kind: str            # base kind without -start/-done suffix
    result_bytes: float
    operand_bytes: float
    wire_bytes: float    # ring-algorithm bytes per participating device
    group_size: int
    raw: str = ""


def _group_size(line: str, default: int = 1) -> int:
    m = _IOTA_GROUPS_RE.search(line)
    if m:
        num_groups, group_size = map(int, m.groups())
        del num_groups
        if group_size:
            return group_size
    m = _REPLICA_GROUPS_RE.search(line)
    if m:
        first = m.group(1).split("},")[0].strip("{}")
        ids = [x for x in first.split(",") if x.strip() != ""]
        return max(1, len(ids))
    return default


def _collective_from(kind: str, result_bytes: float, g: int) -> tuple[float, float]:
    """(operand_bytes, wire_bytes) for a collective with result R, group g."""
    g = max(1, g)
    r = result_bytes
    if kind == "all-gather":
        operand = r / g
        wire = r * (g - 1) / g
    elif kind == "reduce-scatter":
        operand = r * g
        wire = r * (g - 1)
    elif kind == "all-reduce":
        operand = r
        wire = 2.0 * r * (g - 1) / g
    elif kind in ("all-to-all", "ragged-all-to-all"):
        operand = r
        wire = r * (g - 1) / g
    elif kind == "collective-broadcast":
        operand = r
        wire = r
    else:  # collective-permute
        operand = r
        wire = r
    return operand, wire


def parse_collectives(hlo_text: str) -> list[CollectiveOp]:
    ops: list[CollectiveOp] = []
    for line in hlo_text.splitlines():
        m = re.match(
            r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\(.*?\)|[a-z0-9]+\[[0-9,]*\](?:\{[^}]*\})?)\s*"
            r"([a-z\-]+)(?:-start)?\(",
            line,
        )
        if not m:
            continue
        shape_str, opcode = m.group(1), m.group(2)
        base = opcode[:-6] if opcode.endswith("-start") else opcode
        if base not in COLLECTIVE_KINDS:
            continue
        if opcode.endswith("-done"):
            continue
        result = shape_bytes(shape_str)
        g = _group_size(line)
        operand, wire = _collective_from(base, result, g)
        ops.append(CollectiveOp(kind=base, result_bytes=result,
                                operand_bytes=operand, wire_bytes=wire,
                                group_size=g, raw=line.strip()[:200]))
    return ops


# opcode -> access class name (the hbm.AccessClass taxonomy)
_OPCODE_CLASS = {
    "gather": "gather", "scatter": "gather",
    "dynamic-slice": "gather", "dynamic-update-slice": "gather",
    "transpose": "strided", "reverse": "strided", "pad": "strided",
    "slice": "strided", "concatenate": "strided", "copy": "strided",
    "sort": "strided",
}


@dataclasses.dataclass
class ModuleStats:
    """Summary of one compiled module's memory/collective structure."""

    class_bytes: dict[str, float]
    collectives: list[CollectiveOp]
    opcode_bytes: dict[str, float]
    n_instructions: int

    @property
    def total_class_bytes(self) -> float:
        return sum(self.class_bytes.values())

    @property
    def collective_operand_bytes(self) -> float:
        return sum(c.operand_bytes for c in self.collectives)

    @property
    def collective_wire_bytes(self) -> float:
        return sum(c.wire_bytes for c in self.collectives)

    def collective_bytes_by_kind(self) -> dict[str, float]:
        out: dict[str, float] = defaultdict(float)
        for c in self.collectives:
            out[c.kind] += c.operand_bytes
        return dict(out)


def classify_module(hlo_text: str) -> ModuleStats:
    """Scan every instruction (fusion bodies included) and attribute its
    result bytes to an access class.

    This yields byte *shares* per class; the predictor rescales shares to the
    exact total from ``compiled.cost_analysis()['bytes accessed']`` so that
    totals are authoritative while the split reflects the module's access
    patterns."""
    class_bytes: dict[str, float] = defaultdict(float)
    opcode_bytes: dict[str, float] = defaultdict(float)
    n = 0
    for m in _INSTR_RE.finditer(hlo_text):
        shape_str, opcode = m.group(1), m.group(2)
        if opcode in ("parameter", "constant", "tuple", "get-tuple-element"):
            continue
        b = shape_bytes(shape_str)
        n += 1
        opcode_bytes[opcode] += b
        base = opcode[:-6] if opcode.endswith("-start") else opcode
        if base in COLLECTIVE_KINDS:
            continue  # counted separately
        cls = _OPCODE_CLASS.get(base, "stream")
        class_bytes[cls] += b
    return ModuleStats(
        class_bytes=dict(class_bytes),
        collectives=parse_collectives(hlo_text),
        opcode_bytes=dict(opcode_bytes),
        n_instructions=n,
    )
