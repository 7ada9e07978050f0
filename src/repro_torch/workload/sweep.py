"""Model shape x sharding x hardware sweeps through the streaming engine.

Port of ``repro.workload.sweep``.  A :class:`ModelSweepPlan` is the
whole-model analogue of :class:`repro_torch.core.stream.SweepPlan`: a
frozen, picklable, JSON-able description of one grid over the axes

    ``phase`` x ``batch`` x ``seq_len`` x ``shards`` x ``hardware``

Each distinct ``(phase, batch, seq_len)`` combination is walked or
captured **once at plan-build time**; what the plan stores is pure data —
per-op access-class byte totals and FLOPs — so ``evaluator()`` rebuilds
the chunk-scoring function anywhere without the model code.  The plan
carries a ``device`` string, as :class:`~repro_torch.core.stream.SweepPlan`
does: the ``torch`` backend scores on it (the CUDA card unless it says
``cpu``), ``scalar`` runs the reference loop.  Every chunk scores all ops
of all its points in one ``GroupBatch`` pass (per-kernel sums in
``np.bincount``'s order on any device) and aggregates per point with
``np.bincount`` on the host, whose
per-point accumulation order depends only on the point's own op order —
the property that makes streaming folds bit-equal to one materialized
pass (tested).

First-order sharding model (documented, not silently assumed): ``shards``
divides every op's per-device traffic (batch-dimension data parallelism),
and a ``train`` phase with ``shards > 1`` gains one synthetic stream-class
op of ``2 (s-1)/s * param_bytes`` — the per-device DRAM traffic of a ring
gradient all-reduce.  Replicated-weight reads are *also* divided, which
understates small-batch decode traffic; refine when a sharded-layout
walker lands.

Aggregate column definitions (per point): ``t_exe``/``t_ideal``/``t_ovh``
/``total_bytes``/``n_lsu`` are sums over the point's ops; ``bound_ratio``
is the time-weighted mean of per-op ratios; ``memory_bound`` is true when
ops that are individually memory-bound account for more than half of
``t_exe``; ``resource`` is the *peak* per-op LSU interconnect width — the
widest simultaneously-live crossbar the composed schedule needs.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, Iterable, Mapping, Sequence

import numpy as np

from repro_torch import compat
from repro_torch.core import model as _model
from repro_torch.core import model_batch as _mb
from repro_torch.core import stream as _stream
from repro_torch.core import validate as _validate
from repro_torch.core.fpga import BspParams, DramParams
from repro_torch.hw import Hardware
from repro_torch.hw import get as _hw_get

__all__ = ["MODEL_AXES", "ModelSweepPlan", "ModelSweepReport"]

MODEL_AXES = ("phase", "batch", "seq_len", "shards", "hardware")

_PLAN_BACKENDS = ("scalar", "torch")

#: The reference's array backends, read as the port's array core when a
#: reference plan's JSON is loaded.
_REFERENCE_BACKENDS = {"numpy-batch": "torch", "jax-jit": "torch"}

#: Columns every model-sweep evaluator emits (reducer contract).
MODEL_COLUMNS = (("id",) + MODEL_AXES + _stream.ESTIMATE_COLUMNS
                 + ("resource",))


def _combo_key(phase: str, batch: int, seq_len: int) -> str:
    return f"{phase}|{batch}|{seq_len}"


def _resolve_hardware(spec) -> Hardware | None:
    """A spec passes through, a preset name looks up the registry, ``None``
    (the session's own hardware) stays ``None``."""
    if spec is None or isinstance(spec, Hardware):
        return spec
    if isinstance(spec, str):
        return _hw_get(spec)
    raise TypeError(f"cannot resolve {spec!r} to a Hardware spec "
                    f"(want Hardware | preset name | None)")


@dataclasses.dataclass(frozen=True)
class ModelSweepPlan:
    """Frozen data-only description of one whole-model sweep.

    ``tables`` maps ``"phase|batch|seq_len"`` to the walked op list of that
    compiled step: each op is ``{"classes": {access class: bytes},
    "flops": float}`` (whole-step totals).  ``dram``/``bsp`` and
    ``calibration_factor`` are the session context captured at build time,
    used for every point whose ``hardware`` axis value is ``None``; a
    point with its own :class:`~repro_torch.hw.Hardware` scores against that
    spec's params and host factor instead (same semantics as the kernel
    sweep's hardware axis).  ``device`` is where the ``torch`` backend
    scores, as a string so the plan pickles (``None``: the CUDA card).

    Build with ``Session.plan_model(...)``, not by hand.
    """

    model: str
    lists: Mapping[str, Sequence]
    tables: Mapping[str, tuple]
    param_bytes: float
    dram: DramParams
    bsp: BspParams
    backend: str = "torch"
    calibration_factor: float = 1.0
    chunk_size: int = 256
    access_bytes: int = _validate.ACCESS_BYTES
    device: str | None = None

    def __post_init__(self):
        if self.backend not in _PLAN_BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}: pick one "
                             f"of {_PLAN_BACKENDS}")
        if self.chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        missing = [a for a in MODEL_AXES if a not in self.lists]
        if missing:
            raise ValueError(f"plan lists must cover every model axis; "
                             f"missing {missing}")
        lists = {
            "phase": tuple(str(p) for p in self.lists["phase"]),
            "batch": tuple(int(b) for b in self.lists["batch"]),
            "seq_len": tuple(int(s) for s in self.lists["seq_len"]),
            "shards": tuple(int(s) for s in self.lists["shards"]),
            "hardware": tuple(_resolve_hardware(h)
                              for h in self.lists["hardware"]),
        }
        if any(s < 1 for s in lists["shards"]):
            raise ValueError("shards must be >= 1")
        object.__setattr__(self, "lists", lists)
        object.__setattr__(
            self, "tables",
            {k: tuple({"classes": dict(op["classes"]),
                       "flops": float(op.get("flops", 0.0))} for op in ops)
             for k, ops in dict(self.tables).items()})
        missing_combos = [
            _combo_key(p, b, s)
            for p in lists["phase"] for b in lists["batch"]
            for s in lists["seq_len"]
            if _combo_key(p, b, s) not in self.tables]
        if missing_combos:
            raise ValueError(f"tables missing walked combos "
                             f"{missing_combos[:4]}...")
        if self.device is not None:
            import torch

            object.__setattr__(self, "device", str(torch.device(self.device)))

    # -- geometry -----------------------------------------------------------

    def enumerator(self) -> _stream.GridEnumerator:
        return _stream.GridEnumerator(
            {a: list(self.lists[a]) for a in MODEL_AXES})

    @property
    def n(self) -> int:
        return self.enumerator().n

    # -- evaluation ---------------------------------------------------------

    def _point_kernels(self, phase: str, batch: int, seq_len: int,
                       shards: int):
        """(LSU lists, per-op resource widths) for one grid combo."""
        ops = [dict(op["classes"])
               for op in self.tables[_combo_key(phase, batch, seq_len)]]
        if shards > 1:
            ops = [{k: v / shards for k, v in cl.items()} for cl in ops]
            if phase == "train" and self.param_bytes > 0:
                ops.append({"stream":
                            2.0 * (shards - 1) / shards * self.param_bytes})
        kernels, widths = [], []
        for cl in ops:
            lsus = _validate.lsus_from_classes(
                cl, access_bytes=self.access_bytes)
            kernels.append(lsus)
            widths.append(float(sum(l.ls_width for l in lsus
                                    if l.lsu_type.is_global)))
        return kernels, widths

    def evaluator(self) -> Callable[[np.ndarray], dict[str, np.ndarray]]:
        """Chunk-scoring function over point ids (reducer-ready columns).

        Per-point aggregation is chunk-shape independent, so any chunking
        of the id range folds to bit-identical per-point values.
        """
        enum = self.enumerator()
        lists = self.lists
        backend = self.backend
        hw_ctx = []           # hardware code -> (dram, bsp, calibration)
        for h in lists["hardware"]:
            if h is None:
                hw_ctx.append((self.dram, self.bsp,
                               float(self.calibration_factor)))
            else:
                hw_ctx.append((h.dram_params(), h.bsp_params(),
                               float(h.host_factor)))

        kernel_cache: dict[tuple, tuple] = {}

        def combo(pc: int, bc: int, sc: int, shc: int):
            key = (pc, bc, sc, shc)
            hit = kernel_cache.get(key)
            if hit is None:
                hit = self._point_kernels(
                    lists["phase"][pc], lists["batch"][bc],
                    lists["seq_len"][sc], lists["shards"][shc])
                kernel_cache[key] = hit
            return hit

        device = (compat.resolve_device(self.device) if backend == "torch"
                  else None)

        def eval_chunk(ids: np.ndarray) -> dict[str, np.ndarray]:
            ids = np.asarray(ids, dtype=np.int64)
            m = len(ids)
            codes = enum.codes(ids)
            pc, bc, sc = codes["phase"], codes["batch"], codes["seq_len"]
            shc, hc = codes["shards"], codes["hardware"]
            flat, point_of, widths, drams, bsps = [], [], [], [], []
            cal = np.ones(m, dtype=np.float64)
            resource = np.zeros(m, dtype=np.float64)
            for i in range(m):
                kernels, w = combo(int(pc[i]), int(bc[i]), int(sc[i]),
                                   int(shc[i]))
                dram, bsp, c = hw_ctx[int(hc[i])]
                cal[i] = c
                for lsus, width in zip(kernels, w):
                    flat.append(lsus)
                    point_of.append(i)
                    drams.append(dram)
                    bsps.append(bsp)
                if w:
                    resource[i] = max(w)
            point_of = np.asarray(point_of, dtype=np.int64)

            if len(flat):
                if backend == "scalar":
                    ests = [_model._estimate(list(l), d, b)
                            for l, d, b in zip(flat, drams, bsps)]
                    t_exe_k = np.asarray([e.t_exe for e in ests])
                    t_ideal_k = np.asarray([e.t_ideal for e in ests])
                    t_ovh_k = np.asarray([e.t_ovh for e in ests])
                    ratio_k = np.asarray([e.bound_ratio for e in ests])
                    mb_k = np.asarray([e.memory_bound for e in ests],
                                      dtype=np.float64)
                    bytes_k = np.asarray([float(e.total_bytes)
                                          for e in ests])
                    nlsu_k = np.asarray([len(e.per_lsu) for e in ests],
                                        dtype=np.float64)
                else:
                    est = _mb.estimate_batch(_mb.GroupBatch.from_kernels(
                        flat, drams, bsps), device=device)
                    t_exe_k = np.asarray(est.t_exe, dtype=np.float64)
                    t_ideal_k = np.asarray(est.t_ideal, dtype=np.float64)
                    t_ovh_k = np.asarray(est.t_ovh, dtype=np.float64)
                    ratio_k = np.asarray(est.bound_ratio, dtype=np.float64)
                    mb_k = np.asarray(est.memory_bound, dtype=np.float64)
                    bytes_k = np.asarray(est.total_bytes, dtype=np.float64)
                    nlsu_k = np.asarray(est.n_lsu, dtype=np.float64)
            else:
                t_exe_k = t_ideal_k = t_ovh_k = ratio_k = mb_k = bytes_k \
                    = nlsu_k = np.empty(0, dtype=np.float64)

            def per_point(w):
                return np.bincount(point_of, weights=w, minlength=m)

            t_exe = per_point(t_exe_k)
            with np.errstate(invalid="ignore", divide="ignore"):
                bound_ratio = np.where(
                    t_exe > 0, per_point(t_exe_k * ratio_k)
                    / np.where(t_exe > 0, t_exe, 1.0), 0.0)
            memory_bound = per_point(t_exe_k * mb_k) > 0.5 * t_exe
            cols: dict[str, np.ndarray] = {
                "id": ids,
                "phase": np.asarray(pc, dtype=np.int64),
                "batch": np.asarray(lists["batch"])[bc],
                "seq_len": np.asarray(lists["seq_len"])[sc],
                "shards": np.asarray(lists["shards"])[shc],
                "hardware": np.asarray(hc, dtype=np.int64),
                "t_exe": t_exe * cal,
                "t_ideal": per_point(t_ideal_k) * cal,
                "t_ovh": per_point(t_ovh_k) * cal,
                "bound_ratio": bound_ratio,
                "memory_bound": memory_bound,
                "total_bytes": per_point(bytes_k),
                "n_lsu": per_point(nlsu_k).astype(np.int64),
                "resource": resource,
            }
            return cols

        return eval_chunk

    def run(self, reducers: Iterable[_stream.Reducer], *,
            workers: int | None = None) -> _stream.StreamOutcome:
        """Stream the whole grid into ``reducers`` (chunked fold)."""
        return _stream.run_stream(self.n, self.chunk_size,
                                  self.evaluator(), reducers,
                                  workers=workers)

    def materialize(self) -> dict[str, np.ndarray]:
        """All columns of the whole grid in one pass (no reducers)."""
        ids = np.arange(self.n, dtype=np.int64)
        return self.evaluator()(ids)

    # -- serialization ------------------------------------------------------

    def to_json(self) -> str:
        out = {
            "version": 1,
            "model": self.model,
            "backend": self.backend,
            "calibration_factor": self.calibration_factor,
            "chunk_size": self.chunk_size,
            "access_bytes": self.access_bytes,
            "param_bytes": self.param_bytes,
            "device": self.device,
            "dram": _stream._axis_value_to_json(self.dram),
            "bsp": _stream._axis_value_to_json(self.bsp),
            "lists": {a: [_stream._axis_value_to_json(v)
                          for v in self.lists[a]] for a in MODEL_AXES},
            "tables": {k: [{"classes": dict(op["classes"]),
                            "flops": op["flops"]} for op in ops]
                       for k, ops in self.tables.items()},
        }
        return json.dumps(out, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ModelSweepPlan":
        """A plan from ``to_json`` text, the port's or the reference's (its
        ``numpy-batch``/``jax-jit`` backends read as ``torch``; it names no
        device, so the plan scores on the CUDA card unless replaced)."""
        d = json.loads(text)
        return cls(
            model=d["model"],
            lists={a: [_stream._axis_value_from_json(v)
                       for v in d["lists"][a]] for a in MODEL_AXES},
            tables={k: tuple(ops) for k, ops in d["tables"].items()},
            param_bytes=float(d["param_bytes"]),
            dram=_stream._axis_value_from_json(d["dram"]),
            bsp=_stream._axis_value_from_json(d["bsp"]),
            backend=_REFERENCE_BACKENDS.get(d["backend"], d["backend"]),
            calibration_factor=float(d["calibration_factor"]),
            chunk_size=int(d["chunk_size"]),
            access_bytes=int(d["access_bytes"]),
            device=d.get("device"))


class ModelSweepReport:
    """Swept model grid as a Report (materialized or reducer-backed).

    ``cols`` holds the full grid's columns on a materialized run, or the
    survivors (Pareto front + top-k, deduplicated, ascending id) on a
    streaming run; ``stats`` is the exact whole-grid summary either way.
    """

    kind = "model-sweep"

    def __init__(self, plan: ModelSweepPlan, cols: Mapping[str, np.ndarray],
                 *, n_total: int, stats: Mapping | None,
                 streaming: bool, reducers: tuple = ()):
        self.plan = plan
        self.cols = {k: np.asarray(v) for k, v in cols.items()}
        self.n_total = int(n_total)
        self.stats = dict(stats) if stats else None
        self.streaming = bool(streaming)
        self.reducers = reducers
        self.backend = plan.backend

    @property
    def n_points(self) -> int:
        return self.n_total

    def __len__(self) -> int:
        return len(self.cols["id"])

    def _decode_row(self, i: int) -> dict:
        lists = self.plan.lists
        h = lists["hardware"][int(self.cols["hardware"][i])]
        row = {
            "id": int(self.cols["id"][i]),
            "phase": lists["phase"][int(self.cols["phase"][i])],
            "batch": int(self.cols["batch"][i]),
            "seq_len": int(self.cols["seq_len"][i]),
            "shards": int(self.cols["shards"][i]),
            "hardware": h.name if h is not None else self.plan.dram.name,
        }
        for name in _stream.ESTIMATE_COLUMNS + ("resource",):
            v = self.cols[name][i]
            row[name] = (bool(v) if name == "memory_bound"
                         else int(v) if name == "n_lsu" else float(v))
        return row

    def rows(self) -> list[dict]:
        return [self._decode_row(i) for i in range(len(self))]

    def to_csv(self) -> str:
        from repro_torch.api import Report

        return Report.to_csv(self)

    def top_k(self, k: int = 10, key: str = "t_exe") -> list[dict]:
        """The k held rows with the smallest ``key`` (ascending, ties by
        ascending id — the TopKReducer convention)."""
        order = np.lexsort((self.cols["id"], self.cols[key]))
        return [self._decode_row(int(i)) for i in order[:k]]

    def best(self, key: str = "t_exe") -> dict:
        if not len(self):
            raise ValueError("empty sweep (no points held)")
        return self.top_k(1, key)[0]

    def summary(self) -> dict:
        out = {"kind": self.kind, "model": self.plan.model,
               "backend": self.backend, "n_points": self.n_total,
               "held": len(self), "streaming": self.streaming}
        if self.stats:
            out["stats"] = self.stats
        if len(self):
            out["best"] = self.best()
        return out
