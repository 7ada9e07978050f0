"""The port's ``Design``/``Session`` API: one design description, one pipeline.

Port of ``repro.api`` for the paper's main loop:

* :class:`Design` — a frozen description of one design point: LSU groups
  (paper Table II), optional per-design DRAM/BSP overrides and the
  vectorization factor (``microbench``/``from_app``/``from_classes`` and
  the ``with_*`` builders);
* :class:`Space` — a grid or random design space over the microbenchmark
  axes;
* :class:`Session` — the evaluation context: hardware (DRAM + BSP, or one
  :class:`repro_torch.hw.Hardware` spec), a calibration factor, a backend
  (``scalar`` reference loop or the ``torch`` array core) and the
  ``device`` the torch core and the kernels run on — the CUDA card unless
  the caller passes ``device="cpu"``.

    >>> from repro_torch import Design, Session, Space, LsuType
    >>> sess = Session()                     # DDR4-1866 on the CUDA card
    >>> est = sess.estimate(Design.microbench(LsuType.BC_ALIGNED, n_ga=4))
    >>> res = sess.sweep(Space.grid(n_ga=[1, 2, 4], simd=[1, 4, 16]))
    >>> rep = sess.validate()                # the CUDA kernels, measured
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Iterable, Mapping, Sequence

import numpy as np

from repro_torch import compat
from repro_torch.core import apps as _apps
from repro_torch.core import model as _model
from repro_torch.core import model_batch as _mb
from repro_torch.core import sweep as _sweep
from repro_torch.core.fpga import BspParams, DramParams
from repro_torch.core.lsu import Lsu, LsuType, make_global_access
from repro_torch.hw import DEFAULT_BOARD, Hardware
from repro_torch.hw import get as _hw_get

#: Session compute backends: the readable scalar loop and the torch core.
BACKENDS = ("scalar", "torch")

__all__ = ["BACKENDS", "Design", "Space", "Session", "Estimate", "Report",
           "SweepReport", "ValidateReport"]

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

@dataclasses.dataclass(frozen=True)
class Space:
    """A design space over the microbenchmark axes (``sweep.AXES``):
    ``Space.grid(**axes)`` is the Cartesian product, ``Space.random(n,
    seed=..., **axes)`` samples ``n`` points (2-tuples of numbers =
    inclusive integer ranges).  Unset axes default to the session's
    hardware and the sweep defaults."""

    axes: Mapping[str, Any]
    n: int | None = None       # None -> full grid
    seed: int = 0

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

    def points(self, *, dram: DramParams, bsp: BspParams,
               ) -> tuple[dict[str, np.ndarray], int, dict]:
        """Materialize per-point axis arrays, defaulting hardware axes."""
        axes = dict(self.axes)
        axes.setdefault("dram", dram)
        axes.setdefault("bsp", bsp)
        if self.is_grid:
            return _sweep._grid_points(axes)
        return _sweep._random_points(self.n, self.seed, axes)


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
    that is also a :class:`Report`), tagged with the backend that scored it."""

    backend: str = "torch"
    kind = "sweep"

    def estimates(self, indices: Sequence[int] | None = None,
                  ) -> list[Estimate]:
        """Per-point :class:`Estimate` objects (default: all points)."""
        if indices is None:
            indices = range(self.n_points)
        return [_estimate_row(self.estimate, int(i), backend=self.backend)
                for i in indices]

    def best(self) -> Estimate:
        """The fastest design point of the space."""
        if self.n_points == 0:
            raise ValueError("the swept space is empty (n_points == 0); "
                             "there is no best design point")
        return self.estimates([int(np.argmin(self.t_exe))])[0]

    def summary(self) -> dict:
        return {
            "kind": self.kind, "backend": self.backend,
            "n_points": self.n_points,
            "memory_bound_points": int(np.asarray(self.memory_bound).sum()),
            "pareto_points": int(len(self.pareto()) if self.n_points else 0),
            "t_exe_min_ms": (float(np.min(self.t_exe)) * 1e3
                             if self.n_points else math.inf),
        }


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
    * ``backend`` — ``scalar`` (readable reference loop) or ``torch`` (the
      float64 array core on ``device``);
    * ``calibration_factor`` — measured/modeled scale fitted by
      ``validate`` (1.0 = uncalibrated), applied to every estimated time;
    * ``device`` — where the torch core and the kernels run: ``None`` means
      the CUDA card (and raises without one); pass ``"cpu"`` for the CPU.
    """

    dram: DramParams | None = None
    bsp: BspParams | None = None
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

    def sweep(self, space: "Space | Mapping[str, Any] | None" = None, *,
              chunk_size: int | None = None, reducers=None,
              workers: int | None = None, executor: str = "threads",
              constraints=(), **axes) -> SweepReport:
        """Score a whole design space (materialized) on this backend.

        Accepts a :class:`Space`, a plain axes mapping (a grid), or keyword
        axes.  The torch backend scores every point in one pass with the
        split-add segment sum, so ids and values agree bit for bit across
        devices.  Streaming (``chunk_size``/``reducers``/``workers``), the
        process executor and ``constraints`` are not ported yet.
        """
        if (chunk_size is not None or reducers is not None
                or workers is not None or executor != "threads"
                or constraints):
            raise NotImplementedError(
                "streaming sweeps, reducers, the process executor and "
                "constraints are not ported yet (ROADMAP.md, Queue 1: "
                "'Streaming sweeps, reducers and the process executor')")
        if space is None:
            space = Space.grid(**axes)
        elif axes:
            raise TypeError("pass either a Space/mapping or keyword axes, "
                            "not both")
        elif isinstance(space, Mapping):
            space = Space.grid(**space)
        points, n, cats = space.points(dram=self.dram, bsp=self.bsp)
        if self.backend == "scalar":
            result = _sweep._score_scalar(points, n, cats)
        else:
            result = _sweep._build(points, n, cats, functools.partial(
                _mb.estimate_batch, device=self.device, paired_kernel=True))
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
                           resource=result.resource, backend=self.backend)

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
