"""The port's ``Design``/``Session`` API: one design description, one pipeline.

Port of ``repro.api`` for the paper's main loop:

* :class:`Design` — a frozen description of one design point: LSU groups
  (paper Table II), optional per-design DRAM/BSP overrides and the
  vectorization factor (``microbench``/``from_app``/``from_classes`` and
  the ``with_*`` builders);
* :class:`Space` — a grid or random design space over the microbenchmark
  axes (``.stream()`` marks a grid for chunked streaming);
* :class:`Session` — the evaluation context: hardware (DRAM + BSP, or one
  :class:`repro_torch.hw.Hardware` spec), the TPU-model parameters ``hw``
  of the HLO predictor, a calibration factor, a backend (``scalar``
  reference loop or the ``torch`` array core) and the ``device`` the torch
  core and the kernels run on — the CUDA card unless the caller passes
  ``device="cpu"``.  ``sweep`` materializes or streams (with the device
  fold, constraints and a process executor), ``plan`` describes a
  streaming sweep as picklable data, ``optimize`` searches a grid without
  enumerating it, ``predict``/``roofline`` read compiled HLO text,
  ``estimate_model``/``plan_model``/``sweep_model`` score whole model steps
  (:mod:`repro_torch.workload`), and ``serve`` turns the session into a
  concurrent query service (:class:`repro_torch.core.serving.Server`).

    >>> from repro_torch import Design, Session, Space, LsuType
    >>> sess = Session()                     # DDR4-1866 on the CUDA card
    >>> est = sess.estimate(Design.microbench(LsuType.BC_ALIGNED, n_ga=4))
    >>> res = sess.sweep(Space.grid(n_ga=[1, 2, 4], simd=[1, 4, 16]))
    >>> big = sess.sweep(Space.grid(n_ga=list(range(1, 101))),
    ...                  chunk_size=1 << 17, profile=True)
    >>> rep = sess.validate()                # the CUDA kernels, measured
    >>> with sess.serve() as srv:            # micro-batched, LRU-cached
    ...     srv.estimate(Design.microbench(LsuType.BC_ALIGNED, n_ga=4))
"""
from __future__ import annotations

import dataclasses
import functools
import math
import time
from typing import Any, Iterable, Mapping, Sequence

import numpy as np

from repro_torch import compat
from repro_torch.core import apps as _apps
from repro_torch.core import model as _model
from repro_torch.core import model_batch as _mb
from repro_torch.core import sweep as _sweep
from repro_torch.core.fpga import BspParams, DramParams
from repro_torch.core.hbm import TpuParams
from repro_torch.core.lsu import Lsu, LsuType, make_global_access
from repro_torch.core.stream import SweepPlan
from repro_torch.hw import DEFAULT_BOARD, DEFAULT_CHIP, Hardware
from repro_torch.hw import get as _hw_get

#: Session compute backends: the readable scalar loop and the torch core.
BACKENDS = ("scalar", "torch")

#: How ``Session.sweep`` drives streaming chunks: the in-process pipeline
#: or the coordinator/worker process pool.
EXECUTORS = ("threads", "processes")

__all__ = ["BACKENDS", "EXECUTORS", "DEFAULT_CHUNK", "Design", "Space",
           "Session", "Estimate", "Report", "SweepReport", "ValidateReport",
           "RooflineReport", "SweepPlan", "Server", "ServerClosed",
           "ServerOverloaded", "RequestTimeout"]

_perf_counter = time.perf_counter

#: LSU types whose stride axis is live (mirrors apps.microbench semantics).
_STRIDE_TYPES = (LsuType.BC_ALIGNED, LsuType.BC_NON_ALIGNED, LsuType.BC_CACHE)


# ---------------------------------------------------------------------------
# Design: one design point, described once
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Design:
    """A frozen description of one design point.

    ``lsus`` are the load/store units the design instantiates; ``dram`` and
    ``bsp`` optional per-design overrides of the session hardware; ``f`` the
    vectorization factor entering Eq. 10; ``flops`` the compute of a design
    read off measured traffic (``from_classes``).
    """

    lsus: tuple[Lsu, ...]
    dram: DramParams | None = None
    bsp: BspParams | None = None
    f: int = 1
    name: str = ""
    flops: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "lsus", tuple(self.lsus))

    @classmethod
    def microbench(cls, lsu_type: LsuType, *, n_ga: int, simd: int = 16,
                   n_elems: int = 1 << 22, delta: int = 1,
                   elem_bytes: int = 4, include_write: bool = True,
                   val_constant: bool = False, name: str = "",
                   dram: DramParams | None = None,
                   bsp: BspParams | None = None) -> "Design":
        """The paper's SIV sum-reduction microbenchmark; the vectorization
        factor is the SIMD width."""
        lsus = _apps.microbench(
            lsu_type, n_ga=n_ga, simd=simd, n_elems=n_elems,
            delta=delta if lsu_type in _STRIDE_TYPES else 1,
            elem_bytes=elem_bytes, include_write=include_write,
            val_constant=val_constant)
        return cls(lsus=tuple(lsus), dram=dram, bsp=bsp, f=simd,
                   name=name or f"microbench-{lsu_type.value}-ga{n_ga}")

    @classmethod
    def from_app(cls, app: str, n_elems: int, *,
                 dram: DramParams | None = None,
                 bsp: BspParams | None = None) -> "Design":
        """One of the paper's Table IV applications (``core.apps.APPS``)."""
        desc = _apps.APPS[app]
        return cls(lsus=tuple(desc.lsus(n_elems)), dram=dram, bsp=bsp,
                   f=desc.simd, name=app)

    @classmethod
    def from_classes(cls, bytes_by_class: Mapping[str, float], *,
                     access_bytes: int | None = None, flops: float = 0.0,
                     name: str = "") -> "Design":
        """Design from access-class byte totals, with the validation
        harness's class -> LSU-type mapping."""
        from repro_torch.core import validate as _validate

        lsus = _validate.lsus_from_classes(
            dict(bytes_by_class),
            access_bytes=access_bytes or _validate.ACCESS_BYTES)
        return cls(lsus=tuple(lsus), flops=flops, name=name)

    @classmethod
    def from_hlo(cls, hlo_text: str, *, access_bytes: int | None = None,
                 name: str = "") -> "Design":
        """Design read off compiled HLO text (``compiled.as_text()``).

        The transplant of reading the HLS early report: the trip-count-aware
        HLO counter classifies the executable's memory traffic, and each
        access class becomes one LSU group.
        """
        from repro_torch.core import hlo_counter as _hc

        hc = _hc.analyze(hlo_text)
        return cls.from_classes(dict(hc.bytes_by_class),
                                access_bytes=access_bytes,
                                flops=float(hc.flops), name=name)

    @classmethod
    def from_kernel(cls, fn, *args, name: str = "",
                    access_bytes: int | None = None) -> "Design":
        """Design from a torch callable and example arguments: the call is
        captured op by op under ``FakeTensorMode`` (nothing runs or is
        allocated; :func:`repro_torch.workload.walk_callable`) and its
        access-class bytes and FLOPs summed.  ``args`` are example tensors
        (real or fake; only their shapes, dtypes and devices are read)."""
        from repro_torch.workload.capture import walk_callable

        bytes_by_class: dict[str, float] = {}
        flops = 0.0
        for r in walk_callable(fn, *args):
            flops += r.flops
            for k, v in r.bytes_by_class.items():
                bytes_by_class[k] = bytes_by_class.get(k, 0.0) + v
        return cls.from_classes(bytes_by_class, access_bytes=access_bytes,
                                flops=flops,
                                name=name or getattr(fn, "__name__", "kernel"))

    def with_dram(self, dram: DramParams) -> "Design":
        return dataclasses.replace(self, dram=dram)

    def with_bsp(self, bsp: BspParams) -> "Design":
        return dataclasses.replace(self, bsp=bsp)

    def with_f(self, f: int) -> "Design":
        return dataclasses.replace(self, f=f)

    def with_name(self, name: str) -> "Design":
        return dataclasses.replace(self, name=name)

    def with_lsus(self, lsus: Iterable[Lsu]) -> "Design":
        return dataclasses.replace(self, lsus=tuple(lsus))

    def with_access(self, lsu_type: LsuType, *, n_elems: int,
                    elem_bytes: int = 4, f: int | None = None,
                    delta: int = 1, is_write: bool = False,
                    val_constant: bool = False, name: str = "") -> "Design":
        """Append one source-level global access (expanded to its LSUs)."""
        extra = make_global_access(
            lsu_type, n_elems=n_elems, elem_bytes=elem_bytes,
            f=self.f if f is None else f, delta=delta, is_write=is_write,
            val_constant=val_constant, name=name)
        return dataclasses.replace(self, lsus=self.lsus + tuple(extra))

    @property
    def n_lsu(self) -> int:
        """Number of LSUs that issue DRAM traffic."""
        return sum(1 for l in self.lsus if l.lsu_type.is_global)

    @property
    def total_bytes(self) -> int:
        """Useful bytes the design moves (sum over global LSUs)."""
        return sum(l.total_bytes for l in self.lsus if l.lsu_type.is_global)

    @property
    def resource_bytes(self) -> int:
        """Total LSU interconnect width [B] — the sweep resource objective."""
        return sum(l.ls_width for l in self.lsus if l.lsu_type.is_global)


# ---------------------------------------------------------------------------
# Space: a declarative design space
# ---------------------------------------------------------------------------

#: Default streaming chunk: 64k points keeps the working set to tens of MB
#: while amortizing the per-chunk cost.
DEFAULT_CHUNK = 1 << 16


@dataclasses.dataclass(frozen=True)
class Space:
    """A design space over the microbenchmark axes (``sweep.AXES``):
    ``Space.grid(**axes)`` is the Cartesian product, ``Space.random(n,
    seed=..., **axes)`` samples ``n`` points (2-tuples of numbers =
    inclusive integer ranges).  Unset axes default to the session's
    hardware and the sweep defaults.

    ``Space.grid(...).stream()`` marks a grid for bounded-memory streaming:
    points are enumerated lazily from integer ids and folded chunk by chunk
    into online reducers (see ``Session.sweep``)."""

    axes: Mapping[str, Any]
    n: int | None = None       # None -> full grid
    seed: int = 0
    chunk_size: int | None = None   # set by stream(); None -> materialize

    @classmethod
    def grid(cls, **axes) -> "Space":
        return cls(axes=dict(axes))

    @classmethod
    def random(cls, n: int, *, seed: int = 0, **axes) -> "Space":
        if n < 1:
            raise ValueError("a random space needs n >= 1 samples")
        return cls(axes=dict(axes), n=int(n), seed=int(seed))

    @property
    def is_grid(self) -> bool:
        return self.n is None

    def stream(self, chunk_size: int = DEFAULT_CHUNK) -> "Space":
        """This grid, marked for chunked streaming evaluation (only grids
        stream: their points are index arithmetic on the point id)."""
        if not self.is_grid:
            raise TypeError("streaming sweeps need a grid space; "
                            "Space.random materializes its draws")
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        return dataclasses.replace(self, chunk_size=int(chunk_size))

    def lists(self, *, dram: DramParams, bsp: BspParams) -> dict[str, list]:
        """Normalized per-axis value lists, defaulting the hardware axes."""
        axes = dict(self.axes)
        axes.setdefault("dram", dram)
        axes.setdefault("bsp", bsp)
        return _sweep._normalize_axes(axes)

    def points(self, *, dram: DramParams, bsp: BspParams, constraints=(),
               ) -> tuple[dict[str, np.ndarray], int, dict]:
        """Materialize per-point axis arrays, defaulting hardware axes.

        For a random space, ``constraints`` switches to seeded rejection
        sampling (every returned point is feasible; an empty feasible
        region raises).  Grid spaces ignore them here — the sweep masks
        the enumerated grid itself.
        """
        axes = dict(self.axes)
        axes.setdefault("dram", dram)
        axes.setdefault("bsp", bsp)
        if self.is_grid:
            return _sweep._grid_points(axes)
        return _sweep._random_points(self.n, self.seed, axes,
                                     constraints=tuple(constraints))


# ---------------------------------------------------------------------------
# The shared result family
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Estimate:
    """One design point's model output; ``per_lsu`` carries the per-LSU
    breakdown when the scalar backend produced it."""

    t_exe: float                  # Eq. 1 [s]
    t_ideal: float                # bandwidth floor [s]
    t_ovh: float                  # row-miss/ACK/atomic overhead [s]
    bound_ratio: float            # LHS of Eq. 3
    memory_bound: bool
    total_bytes: float
    n_lsu: int
    backend: str = "scalar"
    design: "Design | None" = None
    per_lsu: tuple = ()
    cached: bool = False          # True when served from a Server's LRU

    @property
    def effective_bandwidth(self) -> float:
        """Useful bytes / predicted time [B/s]."""
        return self.total_bytes / self.t_exe if self.t_exe > 0 else math.inf

    def row(self) -> dict:
        return {
            "design": self.design.name if self.design else "",
            "t_exe_ms": self.t_exe * 1e3,
            "t_ideal_ms": self.t_ideal * 1e3,
            "t_ovh_ms": self.t_ovh * 1e3,
            "bound_ratio": self.bound_ratio,
            "memory_bound": bool(self.memory_bound),
            "eff_bw_gbs": self.effective_bandwidth / 1e9,
            "total_bytes": self.total_bytes,
            "backend": self.backend,
        }


def _estimate_row(est: _mb.BatchEstimate, i: int, *, backend: str,
                  scale: float = 1.0,
                  design: "Design | None" = None) -> Estimate:
    """Row ``i`` of a BatchEstimate as an :class:`Estimate`."""
    return Estimate(
        t_exe=float(est.t_exe[i]) * scale,
        t_ideal=float(est.t_ideal[i]) * scale,
        t_ovh=float(est.t_ovh[i]) * scale,
        bound_ratio=float(est.bound_ratio[i]),
        memory_bound=bool(est.memory_bound[i]),
        total_bytes=float(est.total_bytes[i]),
        n_lsu=int(est.n_lsu[i]),
        backend=backend, design=design)


class Report:
    """Mixin of the shared report protocol: ``rows`` / ``to_csv`` / ``summary``."""

    kind: str = "report"

    def rows(self) -> list[dict]:  # pragma: no cover — abstract
        raise NotImplementedError

    def to_csv(self) -> str:
        rows = self.rows()
        if not rows:
            return ""
        import csv
        import io

        fields = list(rows[0].keys())
        seen = set(fields)
        for r in rows[1:]:
            fields += [k for k in r if k not in seen]
            seen.update(r)
        buf = io.StringIO()
        w = csv.DictWriter(buf, fieldnames=fields, restval="")
        w.writeheader()
        for r in rows:
            w.writerow(r)
        return buf.getvalue()

    def summary(self) -> dict:
        return {"kind": self.kind, "rows": len(self.rows())}


@dataclasses.dataclass(frozen=True)
class SweepReport(_sweep.SweepResult, Report):
    """Scored design space (a :class:`~repro_torch.core.sweep.SweepResult`
    that is also a :class:`Report`), tagged with the backend that scored it.

    A *streaming* sweep returns the same class backed by reducer state: the
    held arrays (``points``/``estimate``/``resource``) cover only the
    surviving points (Pareto front + top-k), ``point_ids`` maps them back
    to global point ids, ``stats`` carries the exact whole-space summary,
    and ``pareto()`` / ``top_k()`` / ``rows()`` answer from that state.
    """

    backend: str = "torch"
    # -- streaming state (None on a materialized sweep) --------------------
    n_total: int | None = None        # points swept (held arrays are fewer)
    stats: Mapping[str, Any] | None = None   # StatsReducer.summary()
    point_ids: np.ndarray | None = None      # global id of each held row
    front_idx: np.ndarray | None = None      # held-row indices of the front
    front_objectives: tuple | None = None    # the reducer's objective names
    topk_idx: np.ndarray | None = None       # held-row indices, best first
    topk_key: str | None = None
    reducers: tuple | None = None     # the folded reducer instances
    # -- constraint telemetry (None on an unconstrained sweep) -------------
    n_candidates: int | None = None   # points enumerated before feasibility
    # -- per-stage timing (None unless swept with profile=True) ------------
    profile: Mapping[str, Any] | None = None
    kind = "sweep"

    @property
    def is_streaming(self) -> bool:
        return self.n_total is not None

    @property
    def n_points(self) -> int:
        """Points swept (for a streaming report: the whole space, not the
        survivors — ``len(report.resource)`` counts the held rows)."""
        return self.n_total if self.n_total is not None \
            else int(len(self.resource))

    def pareto(self, objectives: Sequence[Any] | None = None) -> np.ndarray:
        if self.is_streaming:
            if self.front_idx is None:
                raise ValueError(
                    "a streaming report holds only the reducer's front; "
                    "re-sweep with reducers=[ParetoReducer(objectives=...)]")
            wanted = tuple(objectives) if objectives is not None \
                else ("t_exe", "resource")
            if wanted != self.front_objectives:
                raise ValueError(
                    f"streaming report holds the front over "
                    f"{self.front_objectives}; re-sweep with "
                    f"reducers=[ParetoReducer(objectives={wanted!r})] or "
                    f"call pareto({list(self.front_objectives)!r})")
            return np.asarray(self.front_idx, dtype=np.int64)
        return super().pareto(objectives)

    def top_k(self, k: int = 10, key: str = "t_exe") -> list[dict]:
        if self.is_streaming:
            if self.topk_idx is None or key != self.topk_key:
                raise ValueError(
                    f"streaming report kept top-k by {self.topk_key!r}; "
                    f"re-sweep with reducers=[TopKReducer(k, {key!r})]")
            # A reducer that kept the whole space answers any k; only a
            # truncated selection caps k.
            if k > len(self.topk_idx) and len(self.topk_idx) < self.n_points:
                raise ValueError(
                    f"streaming report kept only the top {len(self.topk_idx)}"
                    f"; re-sweep with reducers=[TopKReducer(k={k})]")
            return self.rows(self.topk_idx[:k])
        return super().top_k(k, key)

    def estimates(self, indices: Sequence[int] | None = None,
                  ) -> list[Estimate]:
        """Per-point :class:`Estimate` objects (default: all held points)."""
        if indices is None:
            indices = range(len(self.resource))
        return [_estimate_row(self.estimate, int(i), backend=self.backend)
                for i in indices]

    def best(self) -> Estimate:
        """The fastest design point of the space.

        For a streaming report this is cross-checked against the exact
        whole-space minimum the stats reducer tracked: if the survivors the
        reducers kept do not include that point, this raises rather than
        returning a wrong row.  The default reducers always keep it.
        """
        if self.n_points == 0:
            if self.n_candidates:
                raise ValueError(
                    f"constraints eliminated every point: 0 of "
                    f"{self.n_candidates} candidates feasible; relax the "
                    f"constraints or widen the space")
            raise ValueError("the swept space is empty (n_points == 0); "
                             "there is no best design point")
        if self.is_streaming and len(self.resource) == 0:
            raise ValueError(
                "streaming report holds no survivor rows (stats-only "
                f"reducers; t_exe_min={self.stats['t_exe_min']!r} at point "
                f"id {self.stats['t_exe_min_id']}); re-sweep with "
                "reducers=[TopKReducer(1), ...] to keep the best row")
        i = int(np.argmin(self.t_exe))
        if self.is_streaming and self.stats is not None \
                and float(np.asarray(self.t_exe)[i]) != self.stats["t_exe_min"]:
            raise ValueError(
                "streaming report's survivors do not include the fastest "
                f"point (held min {float(np.asarray(self.t_exe)[i])!r} vs "
                f"whole-space min {self.stats['t_exe_min']!r} at point id "
                f"{self.stats['t_exe_min_id']}); re-sweep with "
                "reducers=[TopKReducer(1), ...] to keep it")
        return self.estimates([i])[0]

    def summary(self) -> dict:
        if self.is_streaming:
            out = {
                "kind": self.kind, "backend": self.backend,
                "n_points": int(self.stats["n_points"]),
                "memory_bound_points": int(self.stats["memory_bound_points"]),
                "pareto_points": int(len(self.front_idx)
                                     if self.front_idx is not None else 0),
                "t_exe_min_ms": float(self.stats["t_exe_min"]) * 1e3,
            }
        else:
            out = {
                "kind": self.kind, "backend": self.backend,
                "n_points": self.n_points,
                "memory_bound_points": int(
                    np.asarray(self.memory_bound).sum()),
                "pareto_points": int(len(self.pareto())
                                     if self.n_points else 0),
                "t_exe_min_ms": (float(np.min(self.t_exe)) * 1e3
                                 if self.n_points else math.inf),
            }
        if self.n_candidates is not None:
            # the feasible/total split of a constrained sweep
            out["n_candidates"] = int(self.n_candidates)
            out["n_feasible"] = out["n_points"]
        if self.profile is not None:
            out["profile"] = dict(self.profile)
        return out


def _stream_report(outcome, tables: Mapping[str, list], *,
                   backend: str,
                   n_candidates: int | None = None,
                   profile: Mapping[str, Any] | None = None) -> SweepReport:
    """Fold a :class:`repro_torch.core.stream.StreamOutcome` into a
    SweepReport.

    Survivors = union of the Pareto reducer's front and the top-k rows,
    deduplicated by point id and held in ascending id order; the front and
    top-k index into those held rows.  For a constrained sweep the
    reducers only saw feasible rows, so ``n_total`` is the stats reducer's
    exact feasible count, not the enumerated grid size.
    """
    from repro_torch.core import stream as _stream

    front = next((r for r in outcome.reducers
                  if isinstance(r, _stream.ParetoReducer)), None)
    topk = next((r for r in outcome.reducers
                 if isinstance(r, _stream.TopKReducer)), None)
    stats = next(r for r in outcome.reducers
                 if isinstance(r, _stream.StatsReducer))

    pieces = [r.cols for r in (front, topk)
              if r is not None and r.cols is not None]
    if pieces:
        merged = {k: np.concatenate([p[k] for p in pieces])
                  for k in pieces[0]}
        ids, first = np.unique(np.asarray(merged["id"], dtype=np.int64),
                               return_index=True)
        merged = {k: np.asarray(v)[first] for k, v in merged.items()}
    else:   # stats-only reducers: nothing held beyond the summary
        ids = np.empty(0, dtype=np.int64)
        merged = {k: np.empty(0) for k in _stream.COLUMNS}

    points: dict[str, np.ndarray] = {}
    for name in _sweep.AXES:
        col = merged[name]
        if name in _sweep._CATEGORICAL:
            points[name] = _sweep._object_array(tables[name])[
                np.asarray(col, dtype=np.int64)] if len(col) \
                else _sweep._object_array([])
        else:
            points[name] = np.asarray(col)
    est = _mb.BatchEstimate(
        t_exe=np.asarray(merged["t_exe"], dtype=np.float64),
        t_ideal=np.asarray(merged["t_ideal"], dtype=np.float64),
        t_ovh=np.asarray(merged["t_ovh"], dtype=np.float64),
        bound_ratio=np.asarray(merged["bound_ratio"], dtype=np.float64),
        memory_bound=np.asarray(merged["memory_bound"], dtype=bool),
        total_bytes=np.asarray(merged["total_bytes"], dtype=np.float64),
        n_lsu=np.asarray(merged["n_lsu"], dtype=np.int64),
        groups={})
    return SweepReport(
        points=points, estimate=est,
        resource=np.asarray(merged["resource"], dtype=np.float64),
        backend=backend,
        n_total=(outcome.n_points if n_candidates is None
                 else int(stats.n_points)),
        n_candidates=n_candidates, stats=stats.summary(),
        point_ids=ids,
        front_idx=(np.searchsorted(ids, front.ids)
                   if front is not None else None),
        front_objectives=front.objectives if front is not None else None,
        topk_idx=(np.searchsorted(ids, topk.ids)
                  if topk is not None else None),
        topk_key=topk.key if topk is not None else None,
        reducers=outcome.reducers, profile=profile)


class AutotuneReport(Report):
    """Ranked autotune results as a Report (wraps ``AutotuneResults``)."""

    kind = "autotune"

    def __init__(self, results):
        self.results = list(results)
        self.failures = list(getattr(results, "failures", []))

    def __iter__(self):
        return iter(self.results)

    def __len__(self) -> int:
        return len(self.results)

    def __getitem__(self, i):
        return self.results[i]

    @property
    def best(self):
        return self.results[0] if self.results else None

    def rows(self) -> list[dict]:
        return ([t.summary() for t in self.results]
                + [f.summary() for f in self.failures])

    def summary(self) -> dict:
        return {"kind": self.kind, "candidates": len(self.results),
                "failures": len(self.failures),
                "best": self.best.candidate.name if self.best else None}


class ValidateReport(Report):
    """Measured-vs-predicted validation as a Report (wraps
    :class:`repro_torch.core.validate.ValidationReport`)."""

    kind = "validate"

    def __init__(self, report):
        self.raw = report
        self.results = report.results
        self.failures = report.failures
        self.dram = report.dram
        self.measured_bw = report.measured_bw
        self.calibration_factor = report.calibration_factor

    @property
    def max_err_pct(self) -> float:
        return self.raw.max_err_pct

    def rows(self) -> list[dict]:
        return self.raw.rows()

    def summary(self) -> dict:
        return {"kind": self.kind, "kernels": len(self.results),
                "failures": len(self.failures),
                "measured_bw_gbs": self.measured_bw / 1e9,
                "calibration_factor": self.calibration_factor,
                "max_err_pct": self.max_err_pct}


@dataclasses.dataclass(frozen=True)
class RooflineReport(Report):
    """Roofline placement of one design: memory vs compute terms."""

    design: Design
    estimate: Estimate
    t_memory: float               # the Eqs. 1-10 memory time [s]
    t_compute: float              # flops / peak_flops (0 when flops unknown)
    ridge_flops_per_byte: float   # the hw ridge point
    arithmetic_intensity: float   # flops / useful bytes
    peak_bw: float                # hw peak memory bandwidth [B/s]
    kind = "roofline"

    @property
    def t_exe(self) -> float:
        """Roofline time: the slower of the two resources."""
        return max(self.t_memory, self.t_compute)

    @property
    def bottleneck(self) -> str:
        return "memory" if self.t_memory >= self.t_compute else "compute"

    @property
    def memory_bound(self) -> bool:
        return self.bottleneck == "memory"

    def rows(self) -> list[dict]:
        return [{
            "design": self.design.name,
            "t_memory_ms": self.t_memory * 1e3,
            "t_compute_ms": self.t_compute * 1e3,
            "bottleneck": self.bottleneck,
            "arithmetic_intensity": self.arithmetic_intensity,
            "ridge_flops_per_byte": self.ridge_flops_per_byte,
            "eff_bw_gbs": self.estimate.effective_bandwidth / 1e9,
            "peak_bw_gbs": self.peak_bw / 1e9,
            "bound_ratio": self.estimate.bound_ratio,
        }]


# ---------------------------------------------------------------------------
# Session: hardware + calibration + backend + device
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Session:
    """Evaluation context every pipeline stage runs in.

    * ``hardware`` — an optional :class:`repro_torch.hw.Hardware` spec;
      when set, ``dram``/``bsp`` and the calibration factor derive from it;
    * ``dram``/``bsp`` — the FPGA-model hardware (default: the registry's
      ``stratix10_ddr4_1866`` board), unless a :class:`Design` overrides it;
    * ``hw`` — the TPU-model parameters that ``predict`` and ``roofline``
      read (default: the registry's ``tpu_v5e`` chip; datasheet inputs of
      the model, not measurements of the card the session runs on);
    * ``backend`` — ``scalar`` (readable reference loop) or ``torch`` (the
      float64 array core on ``device``);
    * ``calibration_factor`` — measured/modeled scale fitted by
      ``validate`` (1.0 = uncalibrated), applied to every estimated time;
    * ``device`` — where the torch core and the kernels run: ``None`` means
      the CUDA card (and raises without one); pass ``"cpu"`` for the CPU.
    """

    dram: DramParams | None = None
    bsp: BspParams | None = None
    hw: TpuParams | None = None
    backend: str = "torch"
    calibration_factor: float | None = None
    hardware: Hardware | None = None
    device: Any = None

    def __post_init__(self):
        spec = self.hardware
        board = _hw_get(DEFAULT_BOARD)
        if self.dram is None:
            object.__setattr__(self, "dram", (spec or board).dram_params())
        if self.bsp is None:
            object.__setattr__(self, "bsp", (spec or board).bsp_params())
        if self.hw is None:
            object.__setattr__(self, "hw", spec.tpu_params() if spec
                               else _hw_get(DEFAULT_CHIP).tpu_params())
        if self.calibration_factor is None:
            object.__setattr__(self, "calibration_factor",
                               float(spec.host_factor) if spec else 1.0)
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; pick one of {BACKENDS}")
        if not (self.calibration_factor > 0
                and math.isfinite(self.calibration_factor)):
            raise ValueError("calibration_factor must be finite and > 0")
        object.__setattr__(self, "device", compat.resolve_device(self.device))

    # -- derivation ---------------------------------------------------------

    def with_backend(self, backend: str) -> "Session":
        return dataclasses.replace(self, backend=backend)

    def with_dram(self, dram: DramParams) -> "Session":
        # the hardware field no longer describes this session: drop it
        return dataclasses.replace(self, dram=dram, hardware=None)

    def with_hardware(self, hardware: Hardware) -> "Session":
        """Session re-anchored on one :class:`repro_torch.hw.Hardware` spec."""
        return dataclasses.replace(
            self, hardware=hardware,
            dram=hardware.dram_params(), bsp=hardware.bsp_params(),
            hw=hardware.tpu_params(),
            calibration_factor=float(hardware.host_factor))

    def with_calibration(self, report: ValidateReport) -> "Session":
        """Session re-anchored on a validation report's fitted bandwidth and
        host factor; ``with_hardware(Hardware.from_calibration(report))``
        makes the same re-anchoring persistent."""
        return dataclasses.replace(
            self, dram=report.dram, hardware=None,
            calibration_factor=float(report.calibration_factor))

    def _hw_for(self, design: Design) -> tuple[DramParams, BspParams]:
        return design.dram or self.dram, design.bsp or self.bsp

    # -- estimate -----------------------------------------------------------

    def estimate(self, design: Design) -> Estimate:
        """Eqs. 1-10 for one design, on this session's backend."""
        dram, bsp = self._hw_for(design)
        if self.backend == "scalar":
            ke = _model._estimate(list(design.lsus), dram, bsp, f=design.f)
            c = self.calibration_factor
            return Estimate(
                t_exe=ke.t_exe * c, t_ideal=ke.t_ideal * c,
                t_ovh=ke.t_ovh * c, bound_ratio=ke.bound_ratio,
                memory_bound=ke.memory_bound,
                total_bytes=float(ke.total_bytes), n_lsu=len(ke.per_lsu),
                backend=self.backend, design=design, per_lsu=ke.per_lsu)
        return self.estimate_many([design])[0]

    def estimate_many(self, designs: Sequence[Design]) -> list[Estimate]:
        """Score many heterogeneous designs in one batched pass (a segment
        sum over their LSU groups)."""
        if not designs:
            return []
        if self.backend == "scalar":
            return [self.estimate(d) for d in designs]
        hw = [self._hw_for(d) for d in designs]
        batch = _mb.GroupBatch.from_kernels(
            [list(d.lsus) for d in designs],
            [h[0] for h in hw], [h[1] for h in hw],
            f=[d.f for d in designs])
        est = _mb.estimate_batch(batch, device=self.device)
        return [_estimate_row(est, i, backend=self.backend,
                              scale=self.calibration_factor, design=d)
                for i, d in enumerate(designs)]

    # -- sweep --------------------------------------------------------------

    @staticmethod
    def _as_space(space: "Space | Mapping[str, Any] | None",
                  axes: Mapping[str, Any]) -> Space:
        """Normalize the (space | mapping | keyword axes) calling forms."""
        if space is None:
            return Space.grid(**axes)
        if axes:
            raise TypeError("pass either a Space/mapping or keyword axes, "
                            "not both")
        if isinstance(space, Mapping):
            return Space.grid(**space)
        return space

    def plan(self, space: "Space | Mapping[str, Any] | None" = None, *,
             chunk_size: int | None = None, constraints=(),
             **axes) -> SweepPlan:
        """A frozen, picklable :class:`SweepPlan` for streaming this space.

        The data-only description of what ``sweep`` would stream —
        normalized axis lists (session hardware defaulted in), backend,
        calibration factor, chunk size, feasibility ``constraints`` and this
        session's device as a string — from which ``plan.evaluator()``
        rebuilds the chunk evaluator in any process (how
        ``executor="processes"`` ships work to spawned workers).  Only grid
        spaces plan: a random space materializes its draws.
        """
        space = self._as_space(space, axes)
        if not space.is_grid:
            raise TypeError("streaming sweeps need a grid space; "
                            "Space.random materializes its draws")
        chunk = chunk_size if chunk_size is not None else space.chunk_size
        return SweepPlan(
            lists=space.lists(dram=self.dram, bsp=self.bsp),
            backend=self.backend,
            calibration_factor=self.calibration_factor,
            chunk_size=int(chunk) if chunk is not None else DEFAULT_CHUNK,
            constraints=constraints or (),
            device=str(self.device))

    def sweep(self, space: "Space | Mapping[str, Any] | None" = None, *,
              chunk_size: int | None = None, reducers=None,
              workers: int | None = None, executor: str = "threads",
              constraints=(), profile: bool = False,
              **axes) -> SweepReport:
        """Score a whole design space through this session's backend.

        Accepts a :class:`Space`, a plain axes mapping (a grid), or keyword
        axes.  The torch backend scores on this session's device with the
        split-add segment sum, so ids and values agree bit for bit across
        devices.

        Passing ``chunk_size`` (or a ``Space.grid(...).stream()`` space, or
        explicit ``reducers``) switches to **bounded-memory streaming**:
        points are enumerated lazily, scored in fixed-shape chunks and
        folded into online reducers — by default a running Pareto front, a
        ``top_k(10)`` selection and exact summary stats — so a 10M-point
        grid sweeps in O(chunk + front + k) memory.  On the torch backend an
        unconstrained sweep with those standard reducers runs the **device
        fold** (:mod:`repro_torch.core.device_stream`): enumeration,
        scoring and folds on the session's device, bit-equal to the host
        fold, which takes over only for constraints, other reducers, an
        explicit thread pool, or a device carry's capacity overflow.

        ``executor`` picks how streaming chunks are driven:

        * ``"threads"`` (default) — the in-process pipeline; ``workers``
          sizes the host pipeline's thread pool on a CPU torch session
          (and then the host fold runs).  A CUDA session already runs the
          whole chunk on the card, and the scalar reference loop is
          GIL-bound: both reject ``workers > 1`` here;
        * ``"processes"`` — the coordinator/worker process pool
          (:mod:`repro_torch.core.distributed`): chunk-aligned id ranges,
          ``workers`` spawned processes that each rebuild the evaluator from
          the picklable :class:`SweepPlan` on the plan's device, stragglers
          re-issued, the merged report bit-equal to the in-process run.

        ``constraints`` (a :class:`repro_torch.search.Constraint`, a
        :class:`repro_torch.search.ResourceEnvelope`, a ``callable(cols) ->
        bool mask``, or a sequence of those) restricts the sweep to the
        feasible region: grid points are masked *before* scoring, random
        spaces rejection-sample, and ``summary()`` carries the
        feasible/candidate split.  Results are bit-equal to post-filtering
        the unconstrained sweep.

        ``profile=True`` records a per-stage wall-time breakdown
        (``enumerate``/``transfer``/``score``/``reduce`` seconds, plus the
        ``path`` taken: ``materialized``, ``host-stream``, ``device`` or
        ``distributed``) on ``report.profile``.  Profiling synchronizes each
        stage, so profiled throughput is a lower bound.
        """
        space = self._as_space(space, axes)
        if constraints:
            from repro_torch.search.constraints import normalize_constraints

            constraints = normalize_constraints(constraints)
        else:
            constraints = ()
        if executor not in EXECUTORS:
            raise ValueError(
                f"unknown executor {executor!r}: pick 'threads' (in-process "
                f"chunk pipeline) or 'processes' (coordinator/worker "
                f"process pool)")
        if workers is not None and workers < 1:
            raise ValueError("workers must be >= 1")
        if executor == "threads" and workers is not None and workers > 1:
            if self.backend == "torch" and self.device.type == "cuda":
                raise ValueError(
                    "workers > 1 under executor='threads' does not apply to "
                    "a CUDA session (the card already runs the whole chunk "
                    "on the device); use executor='processes' to fan out "
                    "across process workers")
            if self.backend == "scalar":
                raise ValueError(
                    "workers > 1 under executor='threads' cannot speed up "
                    "the scalar backend (the reference loop is GIL-bound); "
                    "use executor='processes' to fan out across process "
                    "workers")
        chunk = chunk_size if chunk_size is not None else space.chunk_size
        if chunk is None and (reducers is not None or workers is not None
                              or executor == "processes"):
            chunk = DEFAULT_CHUNK      # these options all imply streaming
        if chunk is not None:
            if not space.is_grid:
                raise TypeError("streaming sweeps need a grid space; "
                                "Space.random materializes its draws")
            return self._sweep_stream(space, int(chunk), reducers, workers,
                                      executor, constraints, profile)
        prof = {"path": "materialized"} if profile else None
        t0 = _perf_counter()
        points, n, cats = space.points(dram=self.dram, bsp=self.bsp,
                                       constraints=constraints)
        if profile:
            prof["enumerate_s"] = _perf_counter() - t0
        n_candidates = None
        if constraints and space.is_grid:
            # Mask the enumerated grid before anything is scored; scoring
            # is per-point independent, so this is bit-equal to scoring
            # everything and filtering after.
            from repro_torch.search.constraints import (
                columns_from_parts,
                feasibility_mask,
            )

            mask = feasibility_mask(
                constraints, columns_from_parts(points, cats, n))
            n_candidates = n
            points = {k: np.asarray(v)[mask] for k, v in points.items()}
            cats = {k: (t, np.asarray(idx)[mask])
                    for k, (t, idx) in cats.items()}
            n = int(np.count_nonzero(mask))
            if n == 0:
                return self._empty_report(n_candidates)
        t0 = _perf_counter()
        if self.backend == "scalar":
            result = _sweep._score_scalar(points, n, cats)
        else:
            result = _sweep._build(points, n, cats, functools.partial(
                _mb.estimate_batch, device=self.device, paired_kernel=True))
        if profile:
            prof["score_s"] = _perf_counter() - t0
        est = result.estimate
        if self.calibration_factor != 1.0:
            # points overridden by a hardware-axis spec already carry that
            # spec's own persisted host_factor and are not scaled twice
            own = np.asarray([h is None for h in result.points["hardware"]],
                             dtype=bool)
            c = np.where(own, self.calibration_factor, 1.0)
            est = dataclasses.replace(
                est, t_exe=np.asarray(est.t_exe) * c,
                t_ideal=np.asarray(est.t_ideal) * c,
                t_ovh=np.asarray(est.t_ovh) * c)
        return SweepReport(points=result.points, estimate=est,
                           resource=result.resource, backend=self.backend,
                           n_candidates=n_candidates, profile=prof)

    def _empty_report(self, n_candidates: int | None) -> SweepReport:
        """A zero-row materialized report (constraints ate every point)."""
        points = {name: (_sweep._object_array([])
                         if name in _sweep._CATEGORICAL else np.empty(0))
                  for name in _sweep.AXES}
        est = _mb.BatchEstimate(
            t_exe=np.empty(0), t_ideal=np.empty(0), t_ovh=np.empty(0),
            bound_ratio=np.empty(0),
            memory_bound=np.empty(0, dtype=bool),
            total_bytes=np.empty(0), n_lsu=np.empty(0, dtype=np.int64),
            groups={})
        return SweepReport(points=points, estimate=est,
                           resource=np.empty(0), backend=self.backend,
                           n_candidates=n_candidates)

    # -- streaming sweep ----------------------------------------------------

    def _sweep_stream(self, space: Space, chunk_size: int, reducers,
                      workers: int | None, executor: str = "threads",
                      constraints: tuple = (),
                      profile: bool = False) -> SweepReport:
        """Chunked, reducer-folded evaluation of a grid space.

        A thin consumer of :class:`SweepPlan`: in this process
        (``threads``: the device fold when the plan and reducers allow it,
        else the host pipeline) or across the process pool
        (``processes``).  Peak memory is O(chunk + front + k); survivor
        rows (front + top-k) are the only points materialized.
        """
        import copy
        import os

        from repro_torch.core import stream as _stream

        plan = self.plan(space, chunk_size=chunk_size,
                         constraints=constraints)
        if reducers is None:
            reducers = _stream.default_reducers()
        else:
            # Reducers accumulate state in place: each sweep folds into
            # copies, so a second sweep never mixes into the first.
            reducers = tuple(copy.deepcopy(r) for r in reducers)
        if not any(isinstance(r, _stream.StatsReducer) for r in reducers):
            reducers += (_stream.StatsReducer(),)

        prof: dict | None = {} if profile else None
        t0 = _perf_counter()
        outcome = None
        if executor == "processes":
            from repro_torch.core import distributed as _dist

            outcome = _dist.run_distributed(plan, reducers, workers=workers)
            if prof is not None:
                # per-stage walls live in the worker processes; only the
                # end-to-end wall is observable here
                prof["path"] = "distributed"
        else:
            threaded = workers is not None and workers > 1
            if self.backend == "torch" and not plan.constraints \
                    and not threaded:
                from repro_torch.core import device_stream as _dev

                outcome = _dev.try_outcome(plan, reducers, profile=prof)
                if outcome is not None and prof is not None:
                    prof["path"] = "device"
            if outcome is None:
                if prof is not None:
                    # drop an overflowed device attempt's stages, keep
                    # the fact that it overflowed
                    overflowed = prof.pop("device_overflow", False)
                    prof.clear()
                    if overflowed:
                        prof["device_overflow"] = True
                    prof["path"] = "host-stream"
                    outcome = _stream.run_stream(
                        plan.n, plan.chunk_size,
                        plan.evaluator(stage_times=prof), reducers,
                        stage_times=prof)
                else:
                    w = workers
                    if w is None and self.backend == "torch" \
                            and self.device.type == "cpu":
                        w = min(4, os.cpu_count() or 1)
                    outcome = _stream.run_stream(
                        plan.n, plan.chunk_size, plan.evaluator(), reducers,
                        workers=w if self.backend == "torch" else None)
        if prof is not None:
            prof["total_s"] = _perf_counter() - t0
        return _stream_report(
            outcome, plan.tables(), backend=self.backend,
            n_candidates=plan.n if plan.constraints else None,
            profile=prof)

    # -- optimizer-driven search -------------------------------------------

    def optimize(self, space: "Space | Mapping[str, Any] | None" = None, *,
                 objective="t_exe", constraints=(), seed: int = 0,
                 max_evals: int | None = None, n_starts: int = 2,
                 steps: int = 16, screen: int | None = None,
                 chunk_size: int | None = None, **axes):
        """Search a grid space for the best design *without* enumerating it.

        ``objective`` is an estimate/resource column to minimize (default
        ``"t_exe"``), or a pair such as ``("t_exe", "resource")`` to
        approximate the 2-objective Pareto front.  ``constraints`` restricts
        the search to the feasible region (same forms as ``sweep``);
        ``max_evals`` bounds the scored points (default ``max(1024, n //
        128)``, under 1% of any large grid).

        A seeded feasible screen picks starting points; the integer axes
        are relaxed to continuous and multi-start AdamW descends with
        ``torch.autograd`` through the torch estimator on this session's
        device (one lane per categorical combination, envelope caps as
        smooth penalties); each continuous optimum is refined on its
        discrete neighborhood and, in Pareto mode, a Pareto local search
        walks the front's neighbors — all through the same evaluator a
        full sweep uses, so every reported number is bit-comparable to the
        exhaustive grid.  Returns a
        :class:`repro_torch.search.OptimizeReport`.
        """
        from repro_torch.search.optimize import run_optimize

        space = self._as_space(space, axes)
        return run_optimize(
            self, space, objective=objective, constraints=constraints,
            seed=seed, max_evals=max_evals, n_starts=n_starts,
            steps=steps, screen=screen, chunk_size=chunk_size)

    # -- validate -----------------------------------------------------------

    def validate(self, cases=None, *, iters: int = 3, warmup: int = 1,
                 calibrate: bool = True) -> ValidateReport:
        """Measured-vs-predicted loop over the port's kernels on this
        session's device (``core.validate.default_cases`` by default).

        With ``calibrate=True`` the stream anchor fits the effective
        bandwidth and a host factor; with ``calibrate=False`` predictions
        come from this session's own ``dram`` alone.
        """
        from repro_torch.core import validate as _validate

        rep = _validate._validate(
            cases, device=self.device, iters=iters, warmup=warmup,
            dram=None if calibrate else self.dram, base=self.dram,
            fit_host_factor=calibrate)
        return ValidateReport(rep)

    # -- HLO predictor and roofline ----------------------------------------

    def autotune(self, cfg, shape, mesh, candidates=None, *,
                 cache=True, gather_row_bytes: float = 512.0,
                 ) -> AutotuneReport:
        """Model-guided candidate ranking: each candidate's sharded step is
        captured as one rank of ``mesh`` runs it (a ``DeviceMesh``, or a
        layout ``(shape, axis names)`` captured over a fake group of its
        size: no launch), then all are scored in one pass on the session's
        device.  The session's hardware spec is part of every on-disk
        cache key, so rankings made under one memory system are never
        reused under another."""
        from repro_torch.core import autotune as _at

        return AutotuneReport(_at._autotune(
            cfg, shape, mesh, candidates, self.hardware or self.hw,
            cache=cache, gather_row_bytes=gather_row_bytes,
            device=self.device))

    def roofline(self, design: Design) -> RooflineReport:
        """Place one design on the roofline: the Eqs. 1-10 memory time (on
        this session's backend and device) vs the compute floor
        (``flops / hw.peak_flops``; 0 when flops are unknown)."""
        est = self.estimate(design)
        t_compute = design.flops / self.hw.peak_flops
        ai = (design.flops / est.total_bytes if est.total_bytes
              else math.inf if design.flops else 0.0)
        dram, _ = self._hw_for(design)
        return RooflineReport(
            design=design, estimate=est,
            t_memory=est.t_exe, t_compute=t_compute,
            ridge_flops_per_byte=self.hw.ridge_flops_per_byte,
            arithmetic_intensity=ai, peak_bw=dram.bw_mem)

    def predict(self, hlo_text: str, cost: dict | None = None, *,
                gather_row_bytes: float = 512.0):
        """Step prediction from compiled HLO text
        (:func:`repro_torch.core.predictor.predict_step` under this
        session's ``hw``).  ``cost`` is ``compiled.cost_analysis()`` as
        plain data, recorded for cross-checks only."""
        from repro_torch.core import predictor as _pred

        return _pred.predict_step(hlo_text, cost, self.hw,
                                  gather_row_bytes=gather_row_bytes)

    # -- whole-model estimation (repro_torch.workload) ----------------------

    def _model_records(self, model, args, *, phases, batch, seq_len,
                       fused) -> tuple[str, dict[str, list]]:
        """(model name, phase -> op records) for every input form
        ``estimate_model``/``plan_model`` accept: compiled HLO text, a
        mapping of phase name -> HLO text (both walked, ``fused`` applies),
        a model-zoo config (its ``phases`` captured on this session's
        device by ``workload.steps``), or a torch callable with example
        args (captured op by op)."""
        from repro_torch import workload as _wl

        if isinstance(model, str):
            return "hlo", {"step": _wl.walk_module(model, fused=fused)}
        if isinstance(model, Mapping):
            return "hlo", {str(k): _wl.walk_module(str(v), fused=fused)
                           for k, v in model.items()}
        if hasattr(model, "block_pattern"):     # models.config.ModelConfig
            from repro_torch.workload import steps as _steps

            return model.name, {
                p: _steps.phase_records(model, p, batch=batch,
                                        seq_len=seq_len, device=self.device)
                for p in phases}
        if callable(model):
            return getattr(model, "__name__", "model"), {
                "step": _wl.walk_callable(model, *args)}
        raise TypeError(
            f"estimate_model wants HLO text, a mapping of phase -> HLO "
            f"text, a ModelConfig, or a torch callable; got "
            f"{type(model).__name__}")

    def estimate_model(self, model, *args, phases=("train", "decode"),
                       batch: int = 1, seq_len: int = 128, name: str = "",
                       access_bytes: int | None = None,
                       fused: bool = True):
        """End-to-end estimate of a whole model step.

        Walks every op of each phase (``workload.walk_module`` for HLO
        text, ``workload.walk_callable`` for the port's own steps), maps
        each op's
        access-class traffic onto LSU groups, scores all ops in **one**
        batched Eqs. 1-10 pass on this session's backend and device, and
        composes a :class:`~repro_torch.workload.ModelReport` — per-phase
        totals (the sum of the per-op estimates), per-layer and per-op-class
        breakdowns, and the aggregate roofline position.

        ``model`` may be compiled HLO text, a ``{phase: hlo_text}``
        mapping, a model-zoo :class:`~repro_torch.models.config.ModelConfig`
        (its ``phases`` captured at ``batch`` x ``seq_len``), or a torch
        callable with example ``*args``.
        """
        from repro_torch import workload as _wl

        mname, records = self._model_records(
            model, args, phases=phases, batch=batch, seq_len=seq_len,
            fused=fused)
        return _wl.compose_model(self, name or mname, records,
                                 access_bytes=access_bytes)

    def plan_model(self, model, *, phases=("decode",), batch=(1,),
                   seq_len=(128,), shards=(1,), hardware=(None,),
                   chunk_size: int = 256, access_bytes: int | None = None,
                   fused: bool = True, name: str = ""):
        """A frozen, picklable whole-model sweep plan.

        Every distinct ``(phase, batch, seq_len)`` combination is walked or
        captured **once here** (the only step that needs the model code);
        the returned :class:`~repro_torch.workload.ModelSweepPlan` is pure
        data, carrying this session's device as a string — JSON/pickle it
        to any process and stream it there.  ``hardware`` axis values may
        be specs, preset names, or ``None`` (= this session's hardware).
        """
        from repro_torch import workload as _wl
        from repro_torch.core import validate as _validate

        phases = tuple(phases)
        batch = tuple(int(b) for b in batch)
        seq_len = tuple(int(s) for s in seq_len)
        tables: dict[str, tuple] = {}
        mname = name
        for b in batch:
            for s in seq_len:
                pname, records = self._model_records(
                    model, (), phases=phases, batch=b, seq_len=s,
                    fused=fused)
                mname = mname or pname
                for p in phases:
                    if p not in records:
                        raise ValueError(
                            f"phase {p!r} not in walked phases "
                            f"{list(records)}")
                    tables[f"{p}|{b}|{s}"] = tuple(
                        {"classes": dict(r.bytes_by_class),
                         "flops": r.flops}
                        for r in records[p] if r.total_bytes > 0)
        pbytes = 0.0
        if hasattr(model, "block_pattern"):
            from repro_torch.workload import steps as _steps

            pbytes = _steps.param_bytes(model)
        return _wl.ModelSweepPlan(
            model=mname or "model",
            lists={"phase": phases, "batch": batch, "seq_len": seq_len,
                   "shards": tuple(shards), "hardware": tuple(hardware)},
            tables=tables, param_bytes=pbytes,
            dram=self.dram, bsp=self.bsp, backend=self.backend,
            calibration_factor=float(self.calibration_factor),
            chunk_size=chunk_size,
            access_bytes=access_bytes or _validate.ACCESS_BYTES,
            device=str(self.device))

    def sweep_model(self, model=None, *, plan=None, phases=("decode",),
                    batch=(1,), seq_len=(128,), shards=(1,),
                    hardware=(None,), chunk_size: int | None = None,
                    reducers=None, k: int = 10,
                    access_bytes: int | None = None, fused: bool = True):
        """Sweep model shape x sharding x hardware through the streaming
        engine.

        With ``chunk_size=None`` (default — model grids are small) the
        whole grid is evaluated in one materialized pass and the report
        holds every point; with a ``chunk_size`` the grid streams through
        ``run_stream`` into Pareto/top-k/stats reducers and the report
        holds the survivors — per-point values are bit-equal either way.
        Pass a prebuilt ``plan`` to skip the walk.
        """
        from repro_torch import workload as _wl
        from repro_torch.core import stream as _stream

        if plan is None:
            if model is None:
                raise ValueError("sweep_model needs a model or a plan")
            plan = self.plan_model(
                model, phases=phases, batch=batch, seq_len=seq_len,
                shards=shards, hardware=hardware,
                chunk_size=chunk_size or 256, access_bytes=access_bytes,
                fused=fused)
        elif chunk_size is not None:
            plan = dataclasses.replace(plan, chunk_size=chunk_size)

        if chunk_size is None:
            cols = plan.materialize()
            stats = _stream.StatsReducer()
            if len(cols["id"]):
                stats.update(cols)
            return _wl.ModelSweepReport(
                plan, cols, n_total=plan.n, stats=stats.summary(),
                streaming=False)

        reducers = tuple(reducers) if reducers is not None \
            else _stream.default_reducers(k)
        outcome = plan.run(reducers)
        front = next((r for r in outcome.reducers
                      if isinstance(r, _stream.ParetoReducer)), None)
        topk = next((r for r in outcome.reducers
                     if isinstance(r, _stream.TopKReducer)), None)
        stats = next((r for r in outcome.reducers
                      if isinstance(r, _stream.StatsReducer)), None)
        pieces = [r.cols for r in (front, topk)
                  if r is not None and r.cols is not None]
        if pieces:
            merged = {kk: np.concatenate([p[kk] for p in pieces])
                      for kk in pieces[0]}
            _, first = np.unique(
                np.asarray(merged["id"], dtype=np.int64),
                return_index=True)
            merged = {kk: np.asarray(v)[first] for kk, v in merged.items()}
        else:
            merged = {kk: np.empty(0) for kk in _wl.MODEL_COLUMNS}
        return _wl.ModelSweepReport(
            plan, merged, n_total=outcome.n_points,
            stats=stats.summary() if stats is not None else None,
            streaming=True, reducers=outcome.reducers)

    # -- serving ------------------------------------------------------------

    def serve(self, *, max_batch: int = 64, max_wait_ms: float = 1.0,
              cache_size: int = 4096, max_queue: int = 1024,
              timeout_ms: float | None = None) -> "Server":
        """This session as a long-lived concurrent query service.

        Returns a :class:`Server` whose ``estimate``/``submit``/``predict``
        calls are safe from any number of threads: a background batcher
        collects up to ``max_batch`` concurrent requests (lingering at most
        ``max_wait_ms`` for a partial batch), scores them in one
        ``estimate_many`` pass on this session's device, and scatters the
        results back to per-request futures, bit-equal to serial
        ``estimate`` calls.  A content-hash LRU of ``cache_size`` results
        sits in front (hits return immediately with ``Estimate.cached``
        set); ``max_queue`` bounds the backlog (beyond it submissions
        fast-fail with :class:`ServerOverloaded`); ``timeout_ms`` is the
        default per-request deadline.  Close with ``server.close()`` or use
        it as a context manager; ``server.stats()`` reports hits, misses
        and p50/p99 latency.
        """
        from repro_torch.core.serving import Server

        return Server(self, max_batch=max_batch, max_wait_ms=max_wait_ms,
                      cache_size=cache_size, max_queue=max_queue,
                      timeout_ms=timeout_ms)


# ---------------------------------------------------------------------------
# serving layer (implementation in repro_torch.core.serving; surface is
# Session.serve — imported last because serving's type hints point back here)
# ---------------------------------------------------------------------------

from repro_torch.core.serving import (  # noqa: E402
    RequestTimeout,
    Server,
    ServerClosed,
    ServerOverloaded,
)
