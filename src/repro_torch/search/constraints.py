"""The constraint algebra and the vectorized feasibility mask.

Port of ``repro.search.constraints``.  A :class:`Constraint` maps
per-point *columns* to a boolean keep-mask.  Columns are served lazily by
:class:`GridColumns`, so a mask that only reads ``interconnect_bytes``
materializes nothing else; available keys are the numeric sweep axes
(values), ``lsu_type`` / ``lsu_type_code``, the categorical axis objects
(``dram``/``bsp``/``hardware``), and the resource-usage columns of
:mod:`repro_torch.search.envelope` (against each point's *effective*
DRAM/BSP, hardware-axis overrides resolved exactly like the scorer).

Constraints compose by conjunction (a sequence passed to
``Session.sweep(constraints=[...])``, or ``a & b``), serialize to the
reference's tagged JSON dicts (so a constraint written by ``repro`` reads
back here, and a :class:`repro_torch.core.stream.SweepPlan` carrying them
round-trips through text), and are consumed in three places:

* the streaming evaluator masks each chunk *before* scoring it;
* ``Space.random`` rejection-samples against them;
* ``Session.optimize`` filters its screen/refine candidates and turns
  envelope caps into differentiable penalties.

Masks are computed on host NumPy columns.  Masking before scoring is
bit-equal to post-filtering the unconstrained sweep, because the mask is a
pure function of each point's own configuration.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Mapping, Sequence

import numpy as np

from repro_torch.core import model_batch as _mb
from repro_torch.search.envelope import (
    USAGE_COLUMNS,
    ResourceEnvelope,
    max_transaction_bytes,
    usage_from_axes,
)

_BOUND_OPS = ("<=", ">=")


class GridColumns(Mapping):
    """Lazy per-point column view over coded sweep points.

    Built from the same ``(numeric columns, categorical (table, codes))``
    currency the scorer consumes, so the streaming mask, the materialized
    pre-filter and ``Space.random`` all read identical values.  Usage
    columns resolve the hardware axis first (a point running on a
    ``hardware`` spec is budgeted against that spec's DRAM/BSP).
    """

    def __init__(self, numeric: Mapping[str, np.ndarray],
                 cats: Mapping[str, tuple[list, np.ndarray]], n: int):
        self._numeric = {k: np.asarray(v) for k, v in numeric.items()}
        self._cats = {k: (list(t), np.asarray(c, dtype=np.int64))
                      for k, (t, c) in cats.items()}
        self._n = int(n)
        self._cache: dict[str, np.ndarray] = {}

    @property
    def n(self) -> int:
        return self._n

    def _resolved(self):
        from repro_torch.core import sweep as _sweep

        res = self._cache.get("$resolved")
        if res is None:
            res = _sweep._resolve_hardware_codes(dict(self._cats), self._n)[0]
            self._cache["$resolved"] = res
        return res

    def _usage(self) -> dict[str, np.ndarray]:
        usage = self._cache.get("$usage")
        if usage is None:
            res = self._resolved()
            d_table, d_codes = res["dram"]
            b_table, b_codes = res["bsp"]
            gather = lambda table, codes, attr: np.asarray(  # noqa: E731
                [getattr(o, attr) if o is not None else 0 for o in table],
                dtype=np.float64)[codes]
            txn = max_transaction_bytes(
                gather(d_table, d_codes, "dq"),
                gather(d_table, d_codes, "bl"),
                gather(b_table, b_codes, "burst_cnt"))
            usage = usage_from_axes(
                type_codes=self["lsu_type_code"],
                n_ga=self._numeric["n_ga"], simd=self._numeric["simd"],
                elem_bytes=self._numeric["elem_bytes"],
                include_write=self._numeric["include_write"],
                max_txn=txn)
            usage = {k: np.asarray(v) for k, v in usage.items()}
            self._cache["$usage"] = usage
        return usage

    def __getitem__(self, key: str) -> np.ndarray:
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        if key in self._numeric:
            val = self._numeric[key]
        elif key == "lsu_type_code":
            table, codes = self._cats["lsu_type"]
            val = np.asarray([_mb.TYPE_CODE[t] for t in table],
                             dtype=np.int64)[codes]
        elif key in USAGE_COLUMNS:
            val = self._usage()[key]
        elif key in self._cats:
            from repro_torch.core.sweep import _object_array

            table, codes = self._cats[key]
            val = _object_array(table)[codes]
        else:
            raise KeyError(key)
        self._cache[key] = val
        return val

    def __iter__(self):
        return iter(sorted({*self._numeric, *self._cats,
                            "lsu_type_code", *USAGE_COLUMNS}))

    def __len__(self) -> int:
        return len(set(self._numeric) | set(self._cats)) \
            + 1 + len(USAGE_COLUMNS)


class Constraint:
    """One feasibility predicate over per-point columns.

    ``mask(cols)`` returns a boolean keep-array of the view's length.
    ``a & b`` builds the conjunction; sequences passed to the public
    entry points are normalized through :func:`normalize_constraints`.
    """

    def mask(self, cols: GridColumns) -> np.ndarray:
        raise NotImplementedError

    def __and__(self, other: "Constraint") -> "AllOf":
        return AllOf(parts=(self,) + (other.parts if isinstance(other, AllOf)
                                      else (as_constraint(other),)))

    def to_json_dict(self) -> dict:
        raise TypeError(
            f"{type(self).__name__} has no JSON encoding; only envelope, "
            f"bound and all-of constraints can ride a SweepPlan through "
            f"text (callables still pickle for process executors)")


@dataclasses.dataclass(frozen=True)
class EnvelopeConstraint(Constraint):
    """``usage <= envelope`` over every cap the envelope sets."""

    envelope: ResourceEnvelope

    def mask(self, cols: GridColumns) -> np.ndarray:
        caps = self.envelope.caps()
        out = np.ones(cols.n, dtype=bool)
        for name, cap in caps.items():
            out &= np.asarray(cols[name], dtype=np.float64) <= cap
        return out

    def to_json_dict(self) -> dict:
        return {"$kind": "envelope", "envelope": self.envelope.to_dict()}


@dataclasses.dataclass(frozen=True)
class BoundConstraint(Constraint):
    """``column <= bound`` (or ``>=``) on any servable column."""

    column: str
    bound: float
    op: str = "<="

    def __post_init__(self):
        if self.op not in _BOUND_OPS:
            raise ValueError(f"bound op must be one of {_BOUND_OPS}")

    def mask(self, cols: GridColumns) -> np.ndarray:
        v = np.asarray(cols[self.column], dtype=np.float64)
        return v <= self.bound if self.op == "<=" else v >= self.bound

    def to_json_dict(self) -> dict:
        return {"$kind": "bound", "column": self.column,
                "bound": float(self.bound), "op": self.op}


@dataclasses.dataclass(frozen=True)
class LambdaConstraint(Constraint):
    """A custom callable ``fn(cols) -> bool mask``.

    Picklable iff ``fn`` is (use a module-level function for process
    executors); never JSON-serializable.
    """

    fn: Callable[[GridColumns], np.ndarray]

    def mask(self, cols: GridColumns) -> np.ndarray:
        out = np.asarray(self.fn(cols))
        if out.dtype != bool or out.shape != (cols.n,):
            raise ValueError(
                f"constraint callable must return a bool mask of shape "
                f"({cols.n},); got dtype={out.dtype} shape={out.shape}")
        return out


@dataclasses.dataclass(frozen=True)
class AllOf(Constraint):
    """Conjunction of constraints (what ``a & b`` builds)."""

    parts: tuple[Constraint, ...]

    def mask(self, cols: GridColumns) -> np.ndarray:
        out = np.ones(cols.n, dtype=bool)
        for p in self.parts:
            out &= p.mask(cols)
        return out

    def to_json_dict(self) -> dict:
        return {"$kind": "all_of",
                "parts": [p.to_json_dict() for p in self.parts]}


def within(envelope: ResourceEnvelope) -> EnvelopeConstraint:
    """Readable alias: ``constraints=[within(board.envelope)]``."""
    return EnvelopeConstraint(envelope)


def as_constraint(obj: Any) -> Constraint:
    """Coerce user input: envelopes and callables lift automatically."""
    if isinstance(obj, Constraint):
        return obj
    if isinstance(obj, ResourceEnvelope):
        return EnvelopeConstraint(obj)
    if callable(obj):
        return LambdaConstraint(obj)
    raise TypeError(
        f"cannot interpret {obj!r} as a constraint; pass a Constraint, a "
        f"ResourceEnvelope, or a callable(cols) -> bool mask")


def normalize_constraints(constraints: Any) -> tuple[Constraint, ...]:
    """One constraint or a sequence -> a tuple of Constraint instances."""
    if constraints is None:
        return ()
    if isinstance(constraints, (Constraint, ResourceEnvelope)) \
            or callable(constraints):
        return (as_constraint(constraints),)
    return tuple(as_constraint(c) for c in constraints)


def feasibility_mask(constraints: Iterable[Constraint],
                     cols: GridColumns) -> np.ndarray:
    """AND of every constraint's mask (all-True when unconstrained)."""
    out = np.ones(cols.n, dtype=bool)
    for c in constraints:
        out &= np.asarray(c.mask(cols), dtype=bool)
    return out


def columns_from_lists(lists: Mapping[str, Sequence],
                       codes: Mapping[str, np.ndarray]) -> GridColumns:
    """The column view of coded grid points (the streaming-mask entry)."""
    from repro_torch.core import sweep as _sweep

    some = next(iter(codes.values()))
    numeric = {k: np.asarray(list(lists[k]))[codes[k]]
               for k in lists if k not in _sweep._CATEGORICAL}
    cats = {k: (list(lists[k]), codes[k])
            for k in lists if k in _sweep._CATEGORICAL}
    return GridColumns(numeric, cats, len(np.asarray(some)))


def columns_from_parts(numeric: Mapping[str, np.ndarray],
                       cats: Mapping[str, tuple[list, np.ndarray]],
                       n: int) -> GridColumns:
    """The column view of materialized/random points (value columns)."""
    return GridColumns(numeric, cats, n)


# ---------------------------------------------------------------------------
# JSON codecs (SweepPlan round-trip)
# ---------------------------------------------------------------------------

def constraint_to_json(c: Constraint) -> dict:
    return c.to_json_dict()


def constraint_from_json(obj: Mapping[str, Any]) -> Constraint:
    kind = obj.get("$kind")
    if kind == "envelope":
        return EnvelopeConstraint(ResourceEnvelope.from_dict(obj["envelope"]))
    if kind == "bound":
        return BoundConstraint(column=str(obj["column"]),
                               bound=float(obj["bound"]),
                               op=str(obj["op"]))
    if kind == "all_of":
        return AllOf(parts=tuple(constraint_from_json(p)
                                 for p in obj["parts"]))
    raise TypeError(f"unknown encoded constraint {obj!r}")


def envelope_caps(constraints: Iterable[Constraint]) -> dict[str, float]:
    """Merged usage caps (min across envelopes) — the optimizer's
    differentiable-penalty terms.  Non-envelope constraints contribute
    nothing here; they still filter every discrete candidate."""
    caps: dict[str, float] = {}

    def visit(c: Constraint) -> None:
        if isinstance(c, AllOf):
            for p in c.parts:
                visit(p)
        elif isinstance(c, EnvelopeConstraint):
            for name, cap in c.envelope.caps().items():
                caps[name] = min(cap, caps.get(name, np.inf))
        elif isinstance(c, BoundConstraint) and c.op == "<=" \
                and c.column in USAGE_COLUMNS:
            caps[c.column] = min(float(c.bound), caps.get(c.column, np.inf))

    for c in constraints:
        visit(c)
    return caps
