"""Trip-count-aware static cost analysis of compiled HLO text.

Port of ``repro.core.hlo_counter`` (plain Python over the module text).
``compiled.cost_analysis()`` counts every ``while`` body **once**, so any
scan-over-layers program under-reports FLOPs/bytes by the trip count (we
measured 10x for a 10-step scan).  This module re-derives the counts from the
HLO text itself — the exact analogue of the paper reading the early RTL
report instead of waiting for the bitstream:

* parses every computation and instruction (name, shape, opcode, operands);
* recovers ``while`` trip counts from the loop-condition comparison constant;
* multiplies body costs by trips through the call graph (while bodies,
  fusion computations, called computations);
* counts FLOPs precisely for ``dot`` (operand shapes x contracting dims) and
  approximately (1 FLOP/element) for elementwise/reduce ops;
* counts HBM bytes per executed instruction (operands + result), with
  slice-aware special cases: ``dynamic-slice``/``gather`` read only what they
  produce, ``dynamic-update-slice``/``scatter`` touch only the update region,
  and fusion operands feeding an internal gather/slice are charged the
  consumer's result bytes rather than the whole operand (otherwise a scan
  that slices its layer's weights out of the stacked array would be charged
  the full stack every iteration);
* classifies bytes into the access classes of :mod:`repro_torch.core.hbm`
  (stream / strided / gather) and collects collectives with trip multipliers.

Validated against ``cost_analysis()`` on scan-free modules (tests).
"""
from __future__ import annotations

import dataclasses
import math
import re
from collections import defaultdict

from repro_torch.core.hlo import shape_bytes, COLLECTIVE_KINDS, _collective_from, _group_size

#: Bump whenever the analysis semantics change (opcode coverage, class
#: mapping, trip-count recovery, ...) so on-disk caches of analyze() output
#: (core.cache / core.autotune) are invalidated automatically.
ANALYZER_VERSION = 2

_COMP_HEADER_RE = re.compile(
    r"^(ENTRY\s+)?%?([\w.\-]+)\s*\((.*?)\)\s*->\s*.+\{\s*$")
# NOTE: tuple types may contain /*index=N*/ comments, so the tuple branch
# must tolerate '=' inside the parens (non-greedy up to ') opcode(').
_INSTR_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(\(.*?\)|[a-z0-9]+\[[0-9,]*\](?:\{[^}]*\})?)"
    r"\s*([a-z][a-z0-9\-]*)\((.*)$")
_SHAPE_ELEMS_RE = re.compile(r"[a-z0-9]+\[([0-9,]*)\]")
_OPERAND_RE = re.compile(r"%([\w.\-]+)")
_ATTR_SPLIT_RE = re.compile(r"\),?\s*")

_ELEMENTWISE_FLOPS = {
    "add", "subtract", "multiply", "divide", "maximum", "minimum", "power",
    "exponential", "log", "tanh", "negate", "abs", "rsqrt", "sqrt", "sine",
    "cosine", "logistic", "expm1", "log1p", "select", "compare", "and", "or",
    "xor", "not", "clamp", "floor", "ceil", "round-nearest-afz", "sign",
    "atan2", "remainder", "erf", "cbrt",
}
_NO_TRAFFIC = {"parameter", "constant", "tuple", "get-tuple-element",
               "bitcast", "after-all", "iota", "partition-id", "replica-id",
               "rng-bit-generator", "rng-get-and-update-state", "domain",
               "opt-barrier", "custom-call"}
# NOTE: dynamic-slice / dynamic-update-slice are *contiguous block* accesses
# (scan-counter offsets) — the paper's burst-coalesced-aligned class — so they
# stay in "stream".  Only data-dependent gather/scatter carry the per-row
# transaction overhead (the Write-ACK analogue).
_CLASS_GATHER = {"gather", "scatter", "scatter-add"}
_CLASS_STRIDED = {"transpose", "reverse", "pad", "slice", "concatenate",
                  "copy", "sort", "reshape"}


@dataclasses.dataclass
class Instr:
    name: str
    shape: str
    opcode: str
    rest: str                     # operand list + attributes (raw)
    operands: tuple[str, ...]


@dataclasses.dataclass
class Computation:
    name: str
    is_entry: bool
    instrs: list[Instr]
    shapes: dict[str, str]        # instr name -> result shape string
    consumers: dict[str, int] = dataclasses.field(default_factory=dict)
    root: str = ""
    by_name: dict[str, "Instr"] = dataclasses.field(default_factory=dict)


def parse_module(text: str) -> dict[str, Computation]:
    comps: dict[str, Computation] = {}
    cur: Computation | None = None
    for line in text.splitlines():
        h = _COMP_HEADER_RE.match(line.strip()) if "{" in line and "->" in line else None
        if h:
            cur = Computation(name=h.group(2), is_entry=bool(h.group(1)),
                              instrs=[], shapes={})
            comps[cur.name] = cur
            continue
        if cur is None:
            continue
        if line.strip() == "}":
            cur = None
            continue
        m = _INSTR_RE.match(line)
        if not m:
            continue
        name, shape, opcode, rest = m.groups()
        # operand names: %refs before the first attribute keyword
        args = rest.split("), ")[0]
        operands = tuple(_OPERAND_RE.findall(args))
        ins = Instr(name=name, shape=shape, opcode=opcode, rest=rest,
                    operands=operands)
        cur.instrs.append(ins)
        cur.shapes[name] = shape
        cur.by_name[name] = ins
        for op_name in operands:
            cur.consumers[op_name] = cur.consumers.get(op_name, 0) + 1
        if line.lstrip().startswith("ROOT"):
            cur.root = name
    return comps


def _shape_elems(shape: str) -> float:
    total = 0.0
    for dims in _SHAPE_ELEMS_RE.findall(shape):
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n
    return total


def _attr(rest: str, key: str) -> str | None:
    m = re.search(re.escape(key) + r"=\{([^}]*)\}", rest)
    return m.group(1) if m else None


def _dims_of(shape: str) -> list[int]:
    m = _SHAPE_ELEMS_RE.search(shape)
    if not m or not m.group(1):
        return []
    return [int(d) for d in m.group(1).split(",")]


def _dot_flops(ins: Instr, comp: Computation) -> float:
    out_elems = _shape_elems(ins.shape)
    k = 1.0
    lhs_shape = comp.shapes.get(ins.operands[0]) if ins.operands else None
    contract = _attr(ins.rest, "lhs_contracting_dims")
    if lhs_shape and contract is not None:
        dims = _dims_of(lhs_shape)
        for idx in contract.split(","):
            idx = idx.strip()
            if idx and int(idx) < len(dims):
                k *= dims[int(idx)]
    return 2.0 * out_elems * k


def _while_trips(cond: Computation) -> int:
    """Trip count from the loop condition's comparison constant."""
    consts: dict[str, int] = {}
    for ins in cond.instrs:
        if ins.opcode == "constant":
            m = re.search(r"constant\((-?\d+)\)", "constant(" + ins.rest)
            if m:
                consts[ins.name] = int(m.group(1))
    best = 0
    for ins in cond.instrs:
        if ins.opcode == "compare":
            for op in ins.operands:
                if op in consts:
                    best = max(best, abs(consts[op]))
    if best == 0 and consts:
        best = max(abs(v) for v in consts.values())
    return max(1, best)


def _called(rest: str, key: str) -> str | None:
    m = re.search(re.escape(key) + r"=%?([\w.\-]+)", rest)
    return m.group(1) if m else None


@dataclasses.dataclass
class HloCost:
    flops: float = 0.0
    bytes_by_class: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    collective_operand_bytes: float = 0.0
    collective_wire_bytes: float = 0.0
    collective_by_kind: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    n_collectives: float = 0.0
    transcendentals: float = 0.0
    warnings: list = dataclasses.field(default_factory=list)

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_class.values())

    def scaled(self, mult: float) -> "HloCost":
        out = HloCost()
        out.flops = self.flops * mult
        # mult == 0 must not leave stale zero-valued classes behind: a
        # downstream consumer keys LSU groups off the class *names*, so a
        # {"gather": 0.0} entry would still instantiate a gather group.
        if mult:
            out.bytes_by_class = defaultdict(
                float, {k: v * mult for k, v in self.bytes_by_class.items()})
            out.collective_by_kind = defaultdict(
                float,
                {k: v * mult for k, v in self.collective_by_kind.items()})
        out.collective_operand_bytes = self.collective_operand_bytes * mult
        out.collective_wire_bytes = self.collective_wire_bytes * mult
        out.n_collectives = self.n_collectives * mult
        out.transcendentals = self.transcendentals * mult
        out.warnings = list(self.warnings)
        return out

    def add(self, other: "HloCost") -> None:
        self.flops += other.flops
        for k, v in other.bytes_by_class.items():
            self.bytes_by_class[k] += v
        self.collective_operand_bytes += other.collective_operand_bytes
        self.collective_wire_bytes += other.collective_wire_bytes
        for k, v in other.collective_by_kind.items():
            self.collective_by_kind[k] += v
        self.n_collectives += other.n_collectives
        self.transcendentals += other.transcendentals
        self.warnings.extend(other.warnings)


_HEAVY_OPS = {"dot", "convolution", "reduce", "reduce-window", "gather",
              "scatter", "dynamic-slice", "dynamic-update-slice", "sort",
              "transpose", "copy", "concatenate", "pad", "slice", "reverse",
              "fft", "cholesky", "triangular-solve"}


class Analyzer:
    """``fused=True`` (default) applies a TPU-fusion-aware traffic model:
    only *materialization boundaries* touch HBM — heavy ops (dot / reduce /
    gather / layout changes), values with more than one consumer, and
    computation roots (loop carries).  Pure single-consumer elementwise
    chains are fusion-internal (VMEM/registers), as the TPU backend would
    emit them.  ``fused=False`` charges every instruction operands+result —
    the XLA HloCostAnalysis convention, used for validation against
    ``cost_analysis()`` on scan-free modules."""

    def __init__(self, text: str, fused: bool = True):
        self.comps = parse_module(text)
        self.fused = fused
        self._fusion_flops_cache: dict[str, tuple[float, float]] = {}
        self._comp_cost_cache: dict[str, HloCost] = {}
        self._fusion_heavy_cache: dict[str, bool] = {}

    def _materialized(self, ins: Instr, comp: Computation) -> bool:
        if not self.fused:
            return True
        if ins.opcode in _HEAVY_OPS:
            return True
        if ins.opcode == "fusion" and self._fusion_heavy(
                _called(ins.rest, "calls") or ""):
            return True
        if comp.consumers.get(ins.name, 0) > 1:
            return True
        return ins.name == comp.root

    def _fusion_heavy(self, comp_name: str) -> bool:
        if comp_name in self._fusion_heavy_cache:
            return self._fusion_heavy_cache[comp_name]
        comp = self.comps.get(comp_name)
        heavy = False
        if comp:
            for i in comp.instrs:
                if i.opcode in _HEAVY_OPS:
                    heavy = True
                    break
                if i.opcode == "fusion" and self._fusion_heavy(
                        _called(i.rest, "calls") or ""):
                    heavy = True
                    break
        self._fusion_heavy_cache[comp_name] = heavy
        return heavy

    # ---- fusion internals: flops only (their bytes stay in VMEM) ----
    def _fusion_internal_flops(self, comp_name: str) -> tuple[float, float]:
        if comp_name in self._fusion_flops_cache:
            return self._fusion_flops_cache[comp_name]
        comp = self.comps.get(comp_name)
        flops = trans = 0.0
        if comp:
            for ins in comp.instrs:
                if ins.opcode == "dot":
                    flops += _dot_flops(ins, comp)
                elif ins.opcode == "fusion":
                    callee = _called(ins.rest, "calls")
                    if callee:
                        f, t = self._fusion_internal_flops(callee)
                        flops += f
                        trans += t
                elif ins.opcode in ("exponential", "log", "tanh", "power",
                                    "logistic", "expm1", "log1p", "erf"):
                    n = _shape_elems(ins.shape)
                    flops += n
                    trans += n
                elif ins.opcode in _ELEMENTWISE_FLOPS:
                    flops += _shape_elems(ins.shape)
                elif ins.opcode in ("reduce", "reduce-window"):
                    flops += _shape_elems(ins.shape) * 2  # approx
        self._fusion_flops_cache[comp_name] = (flops, trans)
        return flops, trans

    def _fusion_class(self, comp_name: str) -> str:
        comp = self.comps.get(comp_name)
        if not comp:
            return "stream"
        ops = {i.opcode for i in comp.instrs}
        if ops & _CLASS_GATHER:
            return "gather"
        if ops & (_CLASS_STRIDED - {"reshape"}):
            return "strided"
        return "stream"

    def _fusion_param_consumers(self, comp_name: str) -> dict[int, float]:
        """param index -> bytes actually touched, for params feeding a
        slicing/updating op: ds/gather/slice read only their result;
        dynamic-update-slice touches only its update region (the rest of the
        buffer is aliased in place)."""
        comp = self.comps.get(comp_name)
        if not comp:
            return {}
        param_idx: dict[str, int] = {}
        for ins in comp.instrs:
            if ins.opcode == "parameter":
                m = re.search(r"parameter\((\d+)", "parameter(" + ins.rest)
                if m:
                    param_idx[ins.name] = int(m.group(1))

        def trace_param(name: str) -> int | None:
            for _ in range(8):  # walk light wrappers back to the param
                if name in param_idx:
                    return param_idx[name]
                prod = comp.by_name.get(name)
                if prod is None or prod.opcode not in (
                        "bitcast", "copy", "convert", "reshape")                         or not prod.operands:
                    return None
                name = prod.operands[0]
            return None

        out: dict[int, float] = {}
        for ins in comp.instrs:
            if ins.opcode in ("dynamic-slice", "gather", "slice"):
                if ins.operands:
                    idx = trace_param(ins.operands[0])
                    if idx is not None:
                        out[idx] = out.get(idx, 0.0) + shape_bytes(ins.shape)
            elif ins.opcode == "dynamic-update-slice":
                if ins.operands:
                    idx = trace_param(ins.operands[0])
                    if idx is not None:
                        upd = (shape_bytes(comp.shapes.get(ins.operands[1], ""))
                               if len(ins.operands) > 1 else 0.0)
                        out[idx] = out.get(idx, 0.0) + upd
        return out

    def _fusion_result_bytes(self, comp_name: str, default: float) -> float:
        """Result write size: a dus-rooted fusion writes only the update."""
        comp = self.comps.get(comp_name)
        if not comp:
            return default
        name = comp.root
        for _ in range(8):  # walk light wrappers
            ins = comp.by_name.get(name)
            if ins is None:
                return default
            if ins.opcode == "dynamic-update-slice":
                if len(ins.operands) > 1:
                    return shape_bytes(comp.shapes.get(ins.operands[1], ""))
                return default
            if ins.opcode in ("bitcast", "copy", "convert", "reshape",
                              "tuple") and ins.operands:
                name = ins.operands[0]
                continue
            return default
        return default

    def _region_input_bytes(self, ins: Instr, comp: Computation,
                            caps: dict[str, float] | None = None) -> float:
        """HBM bytes read by the fused region rooted at ``ins``: walk back
        through light (fusion-internal) producers to materialized values /
        parameters; get-tuple-element reads charge their own element size
        (loop carries), not the whole tuple.  ``caps`` bounds specific
        operand reads (the fusion-internal-slice case)."""
        seen: set[str] = set()
        total = 0.0
        stack = list(ins.operands)
        for name in list(stack):
            if caps and name in caps:
                total += caps[name]
                seen.add(name)
        stack = [n for n in stack if n not in seen]
        while stack:
            name = stack.pop()
            if name in seen:
                continue
            seen.add(name)
            prod = comp.by_name.get(name)
            if prod is None:
                continue
            if prod.opcode == "constant":
                continue
            if prod.opcode == "get-tuple-element":
                total += shape_bytes(prod.shape)
                continue
            if prod.opcode == "parameter" or self._materialized(prod, comp):
                total += shape_bytes(prod.shape)
                continue
            stack.extend(prod.operands)
        return total

    # ---- per-instruction traffic/flops ----
    def _instr_cost(self, ins: Instr, comp: Computation) -> HloCost:
        c = HloCost()
        op = ins.opcode
        base = op[:-6] if op.endswith("-start") else op
        if op in _NO_TRAFFIC or op.endswith("-done"):
            if op == "custom-call":
                c.warnings.append(f"custom-call {ins.name} uncounted")
            return c

        result_b = shape_bytes(ins.shape)
        operand_b = sum(shape_bytes(comp.shapes.get(o, "")) for o in ins.operands)
        reads = (self._region_input_bytes(ins, comp) if self.fused
                 else operand_b)

        if base in COLLECTIVE_KINDS:
            g = _group_size(ins.rest)
            operand, wire = _collective_from(base, result_b, g)
            c.collective_operand_bytes = operand
            c.collective_wire_bytes = wire
            c.collective_by_kind[base] = operand
            c.n_collectives = 1
            return c

        if op == "while":
            body = self.comps.get(_called(ins.rest, "body") or "")
            cond = self.comps.get(_called(ins.rest, "condition") or "")
            trips = _while_trips(cond) if cond else 1
            inner = HloCost()
            if body:
                inner.add(self.comp_cost(body.name))
            if cond:
                inner.add(self.comp_cost(cond.name))
            c.add(inner.scaled(trips))
            return c

        if op in ("call", "conditional"):
            for key in ("to_apply", "true_computation", "false_computation",
                        "branch_computations"):
                callee = _called(ins.rest, key)
                if callee and callee in self.comps:
                    c.add(self.comp_cost(callee))
            return c

        if op == "fusion":
            callee = _called(ins.rest, "calls") or ""
            flops, trans = self._fusion_internal_flops(callee)
            c.flops = flops
            c.transcendentals = trans
            if not self._materialized(ins, comp):
                return c  # light elementwise wrapper — fuses away on TPU
            sliced = self._fusion_param_consumers(callee)
            caps = {}
            for i, o in enumerate(ins.operands):
                if i in sliced:
                    caps[o] = min(shape_bytes(comp.shapes.get(o, "")),
                                  sliced[i])
            if self.fused:
                b = (self._fusion_result_bytes(callee, result_b)
                     + self._region_input_bytes(ins, comp, caps))
            else:
                b = result_b
                for i, o in enumerate(ins.operands):
                    ob = shape_bytes(comp.shapes.get(o, ""))
                    b += min(ob, sliced[i]) if i in sliced else ob
            c.bytes_by_class[self._fusion_class(callee)] = b
            return c

        # plain instructions
        if op == "dot":
            c.flops = _dot_flops(ins, comp)
            c.bytes_by_class["stream"] = reads + result_b
            return c
        if op == "gather":
            c.bytes_by_class["gather"] = 2.0 * result_b
            return c
        if op == "dynamic-slice":
            c.bytes_by_class["stream"] = 2.0 * result_b
            return c
        if op == "dynamic-update-slice":
            upd = (shape_bytes(comp.shapes.get(ins.operands[1], ""))
                   if len(ins.operands) > 1 else result_b)
            c.bytes_by_class["stream"] = 2.0 * upd
            return c
        if op == "scatter":
            upd = (shape_bytes(comp.shapes.get(ins.operands[2], ""))
                   if len(ins.operands) > 2 else result_b)
            c.bytes_by_class["gather"] = 3.0 * upd
            return c
        if op in ("reduce", "reduce-window"):
            c.flops = operand_b and _shape_elems(
                comp.shapes.get(ins.operands[0], ins.shape))
            c.bytes_by_class["stream"] = reads + result_b
            return c
        if op == "sort":
            n = _shape_elems(ins.shape)
            c.flops = n * max(1.0, math.log2(max(n, 2)))
            c.bytes_by_class["strided"] = reads + result_b
            return c
        cls = ("gather" if op in _CLASS_GATHER
               else "strided" if op in _CLASS_STRIDED and op != "reshape"
               else "stream")
        if op in _ELEMENTWISE_FLOPS:
            c.flops = _shape_elems(ins.shape)
            if op in ("exponential", "log", "tanh", "power", "logistic",
                      "expm1", "log1p", "erf"):
                c.transcendentals = c.flops
        if op == "reshape":
            return c  # layout-preserving reshapes are free at HLO level
        if not self._materialized(ins, comp):
            return c  # fusion-internal (VMEM) — no HBM traffic
        c.bytes_by_class[cls] += reads + result_b
        return c

    def comp_cost(self, comp_name: str) -> HloCost:
        if comp_name in self._comp_cost_cache:
            return self._comp_cost_cache[comp_name]
        comp = self.comps[comp_name]
        total = HloCost()
        # guard against recursion
        self._comp_cost_cache[comp_name] = total
        for ins in comp.instrs:
            total.add(self._instr_cost(ins, comp))
        self._comp_cost_cache[comp_name] = total
        return total

    def entry_comp(self) -> Computation | None:
        """The module's ENTRY computation, or None for degenerate modules
        (constant-folded steps can compile to a body the line parser sees
        no computations in at all)."""
        for comp in self.comps.values():
            if comp.is_entry:
                return comp
        return None

    def entry_cost(self) -> HloCost:
        entry = self.entry_comp()
        if entry is None:
            # A fully constant-folded module is a valid, zero-traffic
            # workload — report it as such rather than failing the whole
            # model walk.
            c = HloCost()
            c.warnings.append("no ENTRY computation found; empty cost")
            return c
        return self.comp_cost(entry.name)


def analyze(hlo_text: str, fused: bool = True) -> HloCost:
    """Full-module trip-aware cost (FLOPs, per-class bytes, collectives)."""
    return Analyzer(hlo_text, fused=fused).entry_cost()


def record(hc) -> dict:
    """An :class:`HloCost` as plain JSON data: every field and the total
    (attribute access only, so it reads any object with these fields)."""
    return {
        "flops": hc.flops,
        "bytes_by_class": dict(sorted(hc.bytes_by_class.items())),
        "total_bytes": hc.total_bytes,
        "collective_operand_bytes": hc.collective_operand_bytes,
        "collective_wire_bytes": hc.collective_wire_bytes,
        "collective_by_kind": dict(sorted(hc.collective_by_kind.items())),
        "n_collectives": hc.n_collectives,
        "transcendentals": hc.transcendentals,
        "warnings": list(hc.warnings),
    }
