"""Materialized design-space sweeps over the paper's analytical model.

Port of the materialized path of ``repro.core.sweep``: describe a design
space over the SIV microbenchmark knobs — LSU type, number of global
accesses, SIMD width, input size, stride, element size, DRAM part, BSP
variant, hardware spec — and score every point in one pass of the torch
core (:func:`repro_torch.core.model_batch.estimate_batch`).

Points are enumerated exactly as the reference enumerates them (mixed-radix
ids, first axis slowest), every categorical axis is a ``(table, codes)``
pair, and each point expands to the LSU groups ``apps.microbench`` would
build, so point ``i`` here is point ``i`` of a reference sweep of the same
space.  The same scoring core (:func:`_score`) backs the bounded-memory
streaming path (:mod:`repro_torch.core.stream`), and a random space
rejection-samples against feasibility constraints
(:mod:`repro_torch.search.constraints`).
"""
from __future__ import annotations

import dataclasses
import numbers
from typing import Any, Callable, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import model_batch as _mb
from repro_torch.core.fpga import BspParams
from repro_torch.core.lsu import LsuType

#: Sweepable axes, in canonical order.  ``lsu_type``/``dram``/``bsp``/
#: ``hardware`` are categorical; the rest are numeric.  A ``hardware`` axis
#: value is a :class:`repro_torch.hw.Hardware` spec (or ``None``): its
#: DRAM/BSP views and persisted calibration override the ``dram``/``bsp``
#: axes at that point.
AXES = ("lsu_type", "n_ga", "simd", "n_elems", "delta", "elem_bytes",
        "include_write", "val_constant", "dram", "bsp", "hardware")

_CATEGORICAL = {"lsu_type", "dram", "bsp", "hardware"}
_NUMERIC = tuple(a for a in AXES if a not in _CATEGORICAL)

Estimator = Callable[[_mb.GroupBatch], _mb.BatchEstimate]


def _as_list(v) -> list:
    if isinstance(v, (list, tuple)):
        return list(v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    return [v]


def _object_array(values) -> np.ndarray:
    """1-D object array from a list (safe for dataclass/None elements)."""
    arr = np.empty(len(values), dtype=object)
    arr[:] = list(values)
    return arr


def _pareto_scan(vals: np.ndarray) -> np.ndarray:
    """O(N·F) front for any number of objectives: lexsort + forward scan."""
    order = np.lexsort(tuple(vals[:, d] for d in range(vals.shape[1] - 1, -1, -1)))
    fv = np.empty_like(vals)
    m = 0
    keep: list[int] = []
    for idx in order:
        v = vals[idx]
        if m:
            front = fv[:m]
            if np.any((front <= v).all(axis=1) & (front < v).any(axis=1)):
                continue
        fv[m] = v
        m += 1
        keep.append(int(idx))
    return np.asarray(sorted(keep), dtype=np.int64)


def _pareto_2d(vals: np.ndarray) -> np.ndarray:
    """Vectorized 2-objective front, O(N log N).

    Sort by (v0, v1); a row is dominated iff some row in a strictly
    smaller v0 group has v1 <= its own, or a row in its own v0 group has
    strictly smaller v1.  Duplicated non-dominated rows all survive.
    """
    n = len(vals)
    order = np.lexsort((vals[:, 1], vals[:, 0]))
    v0 = vals[order, 0]
    v1 = vals[order, 1]
    new_group = np.empty(n, dtype=bool)
    new_group[0] = True
    new_group[1:] = v0[1:] != v0[:-1]
    start = np.maximum.accumulate(np.where(new_group, np.arange(n), 0))
    gmin = v1[start]
    cm = np.minimum.accumulate(v1)
    prev_end = start - 1
    m_strict = np.where(prev_end >= 0, cm[np.maximum(prev_end, 0)], np.inf)
    dominated = (m_strict <= v1) | (gmin < v1)
    return np.sort(order[~dominated]).astype(np.int64)


def pareto_front(values: np.ndarray) -> np.ndarray:
    """Indices (ascending) of the Pareto-minimal rows of ``values`` [N, d].

    A row dominates another if it is <= in every objective and < in at
    least one; duplicated non-dominated rows are all kept.
    """
    vals = np.asarray(values, dtype=np.float64)
    if vals.ndim == 1:
        vals = vals[:, None]
    if len(vals) == 0:
        return np.empty(0, dtype=np.int64)
    if vals.shape[1] == 2:
        return _pareto_2d(vals)
    return _pareto_scan(vals)


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """Scored design space: per-point config values + batched model output."""

    points: dict[str, np.ndarray]     # axis -> per-point values [N]
    estimate: _mb.BatchEstimate
    resource: np.ndarray              # total LSU interconnect width [B] per point

    @property
    def n_points(self) -> int:
        return int(len(self.resource))

    @property
    def t_exe(self) -> np.ndarray:
        return np.asarray(self.estimate.t_exe)

    @property
    def memory_bound(self) -> np.ndarray:
        return np.asarray(self.estimate.memory_bound)

    @property
    def effective_bandwidth(self) -> np.ndarray:
        return np.asarray(self.estimate.effective_bandwidth)

    def pareto(self, objectives: Sequence[Any] | None = None) -> np.ndarray:
        """Indices of the Pareto front, minimizing every objective.

        Default objectives: predicted time vs. total LSU width.  Pass a list
        of arrays or names in (``t_exe``, ``resource``, ``bound_ratio``,
        ``total_bytes``) to change the trade-off.
        """
        named = {"t_exe": lambda: self.t_exe,
                 "resource": lambda: self.resource,
                 "bound_ratio": lambda: np.asarray(self.estimate.bound_ratio),
                 "total_bytes": lambda: np.asarray(self.estimate.total_bytes)}
        cols = []
        for obj in objectives if objectives is not None else ["t_exe", "resource"]:
            if isinstance(obj, str):
                if obj not in named:
                    raise KeyError(f"unknown objective {obj!r}")
                cols.append(named[obj]())
            else:
                cols.append(np.asarray(obj, dtype=np.float64))
        return pareto_front(np.stack(cols, axis=1))

    def top_k(self, k: int = 10, key: str = "t_exe") -> list[dict]:
        """The ``k`` best rows by ``key`` (ascending), as config dicts."""
        vals = {"t_exe": self.t_exe, "resource": self.resource}[key] \
            if key in ("t_exe", "resource") else np.asarray(getattr(self.estimate, key))
        return self.rows(np.argsort(vals, kind="stable")[:k])

    def rows(self, indices: Sequence[int] | None = None) -> list[dict]:
        """CSV-ready dict rows for the selected (default: all) points."""
        est = self.estimate
        ebw = self.effective_bandwidth
        if indices is None:
            indices = range(len(self.resource))
        out = []
        for i in indices:
            i = int(i)
            row = {}
            for name, vals in self.points.items():
                v = vals[i]
                if name == "lsu_type":
                    v = LsuType(v).value if not isinstance(v, LsuType) else v.value
                elif name == "bsp":
                    v = _bsp_name(v)
                elif name == "dram":
                    v = getattr(v, "name", repr(v))
                elif name == "hardware":
                    v = getattr(v, "name", "") if v is not None else ""
                elif isinstance(v, (np.integer, np.bool_)):
                    v = v.item()
                row[name] = v
            row.update(
                t_exe_ms=float(est.t_exe[i]) * 1e3,
                t_ovh_ms=float(est.t_ovh[i]) * 1e3,
                bound_ratio=float(est.bound_ratio[i]),
                memory_bound=bool(est.memory_bound[i]),
                eff_bw_gbs=float(ebw[i]) / 1e9,
                resource_bytes=float(self.resource[i]),
            )
            out.append(row)
        return out


def _bsp_name(b: BspParams) -> str:
    return f"bsp(burst_cnt={b.burst_cnt},max_th={b.max_th})"


def _factorize(objs) -> tuple[list, np.ndarray]:
    """(unique objects, per-row codes), by identity."""
    table: list = []
    index: dict[int, int] = {}
    codes = np.empty(len(objs), dtype=np.int64)
    for i, o in enumerate(objs):
        j = index.get(id(o))
        if j is None:
            j = index[id(o)] = len(table)
            table.append(o)
        codes[i] = j
    return table, codes


def _hardware_views(table: Sequence) -> tuple[list, list, np.ndarray, np.ndarray]:
    """Per-unique-spec (dram view, bsp view, host factor, is-None mask)."""
    drams, bsps, hf, is_none = [], [], [], []
    for h in table:
        if h is None:
            drams.append(None)
            bsps.append(None)
            hf.append(1.0)
            is_none.append(True)
        else:
            drams.append(h.dram_params())
            bsps.append(h.bsp_params())
            hf.append(float(h.host_factor))
            is_none.append(False)
    return drams, bsps, np.asarray(hf), np.asarray(is_none, dtype=bool)


def _apply_hardware_axis(points: dict[str, np.ndarray], n: int,
                         ) -> tuple[dict[str, np.ndarray], np.ndarray]:
    """Resolve the ``hardware`` axis into per-point dram/bsp objects and a
    host-factor scale (the scalar backend's form of
    :func:`_resolve_hardware_codes`; the two must resolve identically)."""
    hw_col = points.get("hardware")
    scale = np.ones(n)
    if hw_col is None or all(h is None for h in hw_col):
        return points, scale
    table, codes = _factorize(hw_col)
    drams, bsps, hf, is_none = _hardware_views(table)
    own = is_none[codes]
    scale = np.where(own, 1.0, hf[codes])
    dram_col = np.where(own, np.asarray(points["dram"], dtype=object),
                        _object_array(drams)[codes])
    bsp_col = np.where(own, np.asarray(points["bsp"], dtype=object),
                       _object_array(bsps)[codes])
    return {**points, "dram": dram_col, "bsp": bsp_col}, scale


def _resolve_hardware_codes(cats: dict[str, tuple[list, np.ndarray]], n: int,
                            ) -> tuple[dict, np.ndarray, np.ndarray]:
    """Rewrite the ``dram``/``bsp`` ``(table, codes)`` pairs so points with a
    hardware spec index that spec's views; returns ``(cats, host-factor
    scale [n], own [n])``, ``own`` marking the points that run on the
    session's own hardware (spec ``None``)."""
    hw_table, hw_codes = cats["hardware"]
    if all(h is None for h in hw_table):
        return cats, np.ones(n), np.ones(n, dtype=bool)
    drams, bsps, hf, is_none = _hardware_views(hw_table)
    own = is_none[np.asarray(hw_codes)]
    scale = np.where(own, 1.0, hf[hw_codes])
    d_table, d_codes = cats["dram"]
    b_table, b_codes = cats["bsp"]
    new_d = (list(d_table) + drams,
             np.where(own, d_codes, len(d_table) + np.asarray(hw_codes)))
    new_b = (list(b_table) + bsps,
             np.where(own, b_codes, len(b_table) + np.asarray(hw_codes)))
    return {**cats, "dram": new_d, "bsp": new_b}, scale, own


def _normalize_inert_axes(points: dict[str, np.ndarray],
                          is_atomic: np.ndarray,
                          is_ack: np.ndarray) -> dict[str, np.ndarray]:
    """Stride is inert for ACK/atomic, ``val_constant`` for non-atomics and
    ``include_write`` for atomics: normalize them so reported configs
    describe exactly what was scored."""
    delta = np.where(is_atomic | is_ack, 1,
                     np.asarray(points["delta"], dtype=np.int64))
    val_constant = np.asarray(points["val_constant"], dtype=bool) & is_atomic
    include_write = (np.asarray(points["include_write"], dtype=bool)
                     & ~is_atomic)
    return {**points, "delta": delta, "val_constant": val_constant,
            "include_write": include_write}


def _score(numeric: dict[str, np.ndarray],
           cats: dict[str, tuple[list, np.ndarray]], n: int,
           estimator: Estimator,
           ) -> tuple[_mb.BatchEstimate, np.ndarray, dict, dict, np.ndarray]:
    """Score ``n`` design points given numeric columns + coded categoricals.

    Each point expands to the LSU list ``apps.microbench`` would build, as
    at most two homogeneous LSU groups per point (group ``i`` and
    ``n + i``), which is the layout ``estimate_batch(paired_kernel=True)``
    requires:

    * burst-coalesced aligned/non-aligned/cache: one group of
      ``n_ga + include_write`` identical LSUs;
    * write-ACK: a group of ``n_ga`` aligned reads plus a group of ``simd``
      scalar ACK stores;
    * atomic: a group of ``n_ga`` atomic units (stride is always 1).

    Returns ``(estimate, resource, resolved cats, normalized numeric,
    own-hardware mask)``.
    """
    cats, hw_scale, own = _resolve_hardware_codes(cats, n)

    type_table, type_idx = cats["lsu_type"]
    type_codes = np.asarray([_mb.TYPE_CODE[t] for t in type_table],
                            dtype=np.int64)[type_idx]
    n_ga = np.asarray(numeric["n_ga"], dtype=np.int64)
    simd = np.asarray(numeric["simd"], dtype=np.int64)
    n_elems = np.asarray(numeric["n_elems"], dtype=np.int64)
    elem_bytes = np.asarray(numeric["elem_bytes"], dtype=np.int64)
    dram_table, dram_idx = cats["dram"]
    bsp_table, bsp_idx = cats["bsp"]

    if np.any(n_ga < 1) or np.any(simd < 1) \
            or np.any(np.asarray(numeric["delta"], dtype=np.int64) < 1):
        raise ValueError("n_ga, simd and delta must be >= 1")
    if np.any(n_elems % simd):
        raise ValueError("n_elems must be divisible by simd at every point")

    is_atomic = type_codes == _mb.ATOMIC
    is_ack = type_codes == _mb.WRITE_ACK

    numeric = _normalize_inert_axes(numeric, is_atomic, is_ack)
    delta = numeric["delta"]
    val_constant = numeric["val_constant"]
    include_write = numeric["include_write"]

    # Group 1: the read side (plus the same-type write for plain BC types).
    g1_type = np.where(is_ack, _mb.ALIGNED, type_codes)
    g1_count = np.where(is_atomic | is_ack, n_ga, n_ga + include_write)
    g1_width = np.where(is_atomic, elem_bytes, simd * elem_bytes)
    g1_acc = np.where(is_atomic, n_elems, n_elems // simd)

    # Group 2: the replicated write-ACK store LSUs (count 0 elsewhere).
    g2_count = np.where(is_ack & include_write, simd, 0)

    kernel = np.concatenate([np.arange(n), np.arange(n)])
    vec = np.concatenate
    dram_f = {k: np.asarray([getattr(d, k) if d is not None else 0
                             for d in dram_table])[dram_idx]
              for k in ("dq", "bl", "f_mem", "t_rcd", "t_rp", "t_wr")}
    bsp_f = {k: np.asarray([getattr(b, k) if b is not None else 0
                            for b in bsp_table])[bsp_idx]
             for k in ("burst_cnt", "max_th")}

    batch = _mb.GroupBatch(
        kernel=kernel,
        n_kernels=n,
        count=vec([g1_count, g2_count]),
        lsu_type=vec([g1_type, np.full(n, _mb.WRITE_ACK, dtype=np.int64)]),
        ls_width=vec([g1_width, elem_bytes]),
        ls_acc=vec([g1_acc, n_elems // simd]),
        ls_bytes=vec([g1_width, elem_bytes]),
        delta=vec([delta, np.ones(n, dtype=np.int64)]),
        val_constant=vec([val_constant, np.zeros(n, dtype=bool)]),
        f=vec([simd, simd]),
        **{k: vec([v, v]) for k, v in {**dram_f, **bsp_f}.items()},
    )
    est = estimator(batch)
    if np.any(hw_scale != 1.0):
        # apply each point's persisted hardware calibration (host_factor)
        est = dataclasses.replace(
            est, t_exe=np.asarray(est.t_exe) * hw_scale,
            t_ideal=np.asarray(est.t_ideal) * hw_scale,
            t_ovh=np.asarray(est.t_ovh) * hw_scale)
    resource = np.bincount(kernel,
                           weights=np.asarray(batch.count * batch.ls_width,
                                              dtype=np.float64),
                           minlength=n)
    return est, resource, cats, numeric, own


def _group_columns(type_codes: torch.Tensor, num: dict[str, torch.Tensor],
                   hw: dict[str, torch.Tensor],
                   ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """The two-group expansion of :func:`_score` in torch, for
    :func:`model_batch.estimate_columns` with ``paired_kernel=True``.

    ``type_codes`` are int64 type codes per point; ``num`` holds the
    numeric axes per point — ``n_ga``, ``simd``, ``n_elems``,
    ``elem_bytes``, ``delta`` as float64 and ``include_write``,
    ``val_constant`` as bool; ``hw`` the point's DRAM/BSP fields
    (``burst_cnt`` int64, the rest float64).  Returns ``(group columns,
    normalized inert axes)``.  The arithmetic is float64 throughout:
    ``n_elems / simd`` is exact where ``simd`` divides ``n_elems``, as the
    sweep requires, so at integer values every column equals the host's,
    and at relaxed values (the optimizer's descent) it is differentiable.
    """
    is_atomic = type_codes == _mb.ATOMIC
    is_ack = type_codes == _mb.WRITE_ACK
    latency = is_atomic | is_ack
    n_ga, simd = num["n_ga"], num["simd"]
    n_elems, elem_bytes = num["n_elems"], num["elem_bytes"]
    norm = {"delta": torch.where(latency, 1.0, num["delta"]),
            "include_write": num["include_write"] & ~is_atomic,
            "val_constant": num["val_constant"] & is_atomic}
    per_vec = n_elems / simd
    g1_count = torch.where(latency, n_ga, n_ga + norm["include_write"])
    g1_width = torch.where(is_atomic, elem_bytes, simd * elem_bytes)
    g2_count = torch.where(is_ack & norm["include_write"], simd, 0.0)
    g1_type = torch.where(is_ack, _mb.ALIGNED, type_codes)
    pair = lambda a, b: torch.cat([a, b])  # noqa: E731
    width = pair(g1_width, elem_bytes)
    cols = {
        "count": pair(g1_count, g2_count),
        "lsu_type": pair(g1_type, torch.full_like(g1_type, _mb.WRITE_ACK)),
        "ls_width": width, "ls_bytes": width,
        "ls_acc": pair(torch.where(is_atomic, n_elems, per_vec), per_vec),
        "delta": pair(norm["delta"], torch.ones_like(norm["delta"])),
        "val_constant": pair(norm["val_constant"],
                             torch.zeros_like(norm["val_constant"])),
        "f": pair(simd, simd),
        **{k: pair(v, v) for k, v in hw.items()},
    }
    return cols, norm


def _score_scalar(points: dict, n: int,
                  cats: dict[str, tuple[list, np.ndarray]]) -> SweepResult:
    """Reference scalar loop over the same points :func:`_score` scores:
    each point expands through ``apps.microbench`` and is estimated by the
    per-LSU scalar model, with hardware and inert axes resolved alike."""
    from repro_torch.core import apps as _apps
    from repro_torch.core import model as _model

    points = {name: (points[name] if name in points
                     else _object_array(cats[name][0])[cats[name][1]])
              for name in AXES}
    points, hw_scale = _apply_hardware_axis(points, n)
    lsu_types = [points["lsu_type"][i] for i in range(n)]
    is_atomic = np.array([t is LsuType.ATOMIC_PIPELINED
                          for t in lsu_types], dtype=bool)
    is_ack = np.array([t is LsuType.BC_WRITE_ACK for t in lsu_types],
                      dtype=bool)
    points = _normalize_inert_axes(points, is_atomic, is_ack)

    cols = {k: np.empty(n) for k in
            ("t_exe", "t_ideal", "t_ovh", "bound_ratio", "total_bytes")}
    memory_bound = np.empty(n, dtype=bool)
    n_lsu = np.empty(n)
    resource = np.empty(n)
    for i in range(n):
        simd = int(points["simd"][i])
        lsus = _apps.microbench(
            lsu_types[i],
            n_ga=int(points["n_ga"][i]),
            simd=simd,
            n_elems=int(points["n_elems"][i]),
            delta=int(points["delta"][i]),
            elem_bytes=int(points["elem_bytes"][i]),
            include_write=bool(points["include_write"][i]),
            val_constant=bool(points["val_constant"][i]))
        ke = _model._estimate(list(lsus), points["dram"][i], points["bsp"][i],
                              f=simd)
        cols["t_exe"][i] = ke.t_exe * hw_scale[i]
        cols["t_ideal"][i] = ke.t_ideal * hw_scale[i]
        cols["t_ovh"][i] = ke.t_ovh * hw_scale[i]
        cols["bound_ratio"][i] = ke.bound_ratio
        cols["total_bytes"][i] = ke.total_bytes
        memory_bound[i] = ke.memory_bound
        n_lsu[i] = len(ke.per_lsu)
        resource[i] = sum(l.ls_width for l in lsus if l.lsu_type.is_global)
    est = _mb.BatchEstimate(
        t_exe=cols["t_exe"], t_ideal=cols["t_ideal"],
        t_ovh=cols["t_ovh"], bound_ratio=cols["bound_ratio"],
        memory_bound=memory_bound, total_bytes=cols["total_bytes"],
        n_lsu=n_lsu, groups={})
    return SweepResult(points=points, estimate=est, resource=resource)


def _materialize_points(numeric: dict[str, np.ndarray],
                        cats: dict[str, tuple[list, np.ndarray]],
                        ) -> dict[str, np.ndarray]:
    """Per-point axis columns in canonical ``AXES`` order."""
    points: dict[str, np.ndarray] = {}
    for name in AXES:
        if name in _CATEGORICAL:
            table, codes = cats[name]
            points[name] = _object_array(table)[codes]
        else:
            points[name] = np.asarray(numeric[name])
    return points


def _build(points: dict[str, np.ndarray], n: int,
           cats: dict[str, tuple[list, np.ndarray]],
           estimator: Estimator) -> SweepResult:
    """Materialized scoring: every point's resolved config + estimate."""
    numeric = {k: points[k] for k in _NUMERIC}
    est, resource, cats, numeric, _ = _score(numeric, cats, n, estimator)
    return SweepResult(points=_materialize_points(numeric, cats),
                       estimate=est, resource=resource)


def _normalize_axes(overrides: Mapping[str, Any]) -> dict[str, list]:
    from repro_torch.hw import DEFAULT_BOARD, get as _hw_get

    board = _hw_get(DEFAULT_BOARD)
    defaults = {
        "lsu_type": LsuType.BC_ALIGNED,
        "n_ga": 1,
        "simd": 16,
        "n_elems": 1 << 22,
        "delta": 1,
        "elem_bytes": 4,
        "include_write": True,
        "val_constant": False,
        "dram": board.dram_params(),
        "bsp": board.bsp_params(),
        "hardware": None,
    }
    unknown = set(overrides) - set(AXES)
    if unknown:
        raise KeyError(f"unknown sweep axes: {sorted(unknown)}")
    return {k: _as_list(overrides.get(k, defaults[k])) for k in AXES}


def _grid_points(axes: Mapping[str, Any],
                 ) -> tuple[dict[str, np.ndarray], int,
                            dict[str, tuple[list, np.ndarray]]]:
    """Per-point axis arrays for the full Cartesian product of ``axes``.

    Point ids decode through :class:`repro_torch.core.stream.GridEnumerator`
    (mixed radix, C order, first axis slowest), so point ``i`` here is point
    ``i`` of the streaming path; categorical axes come back as ``(table,
    codes)`` only.
    """
    from repro_torch.core.stream import GridEnumerator

    enum = GridEnumerator(_normalize_axes(axes))
    codes = enum.codes(np.arange(enum.n, dtype=np.int64))
    points: dict[str, np.ndarray] = {}
    cats: dict[str, tuple[list, np.ndarray]] = {}
    for name, vals in enum.lists.items():
        idx = codes[name]
        if name in _CATEGORICAL:
            cats[name] = (vals, idx)
        else:
            points[name] = np.asarray(vals)[idx]
    n = enum.n
    return points, n, cats


def _is_numeric_range(v) -> bool:
    """True for a 2-tuple of plain numbers: an inclusive integer range."""
    return (isinstance(v, tuple) and len(v) == 2
            and all(isinstance(x, numbers.Real)
                    and not isinstance(x, bool)
                    and not isinstance(x, LsuType) for x in v))


def _random_points(n: int, seed: int, axes: Mapping[str, Any],
                   constraints: tuple = (),
                   ) -> tuple[dict[str, np.ndarray], int,
                              dict[str, tuple[list, np.ndarray]]]:
    """Per-point axis arrays for ``n`` uniformly sampled design points.

    Numeric 2-tuples ``(lo, hi)`` are inclusive integer ranges; lists are
    sampled uniformly; scalars are held fixed.  Each ``n_elems`` sample is
    rounded down to a multiple of that point's own ``simd`` (floored at
    ``simd``).  Same draws, in the same order, as the reference for the
    same seed.

    With ``constraints``, sampling is seeded rejection: draw a batch, keep
    the feasible rows, repeat until ``n`` points or a bounded number of
    draws — then raise instead of emitting infeasible points or spinning on
    an empty feasible region.
    """
    rng = np.random.default_rng(seed)
    tuples = {k: v for k, v in axes.items()
              if k not in _CATEGORICAL and _is_numeric_range(v)}
    lists = _normalize_axes({k: v for k, v in axes.items() if k not in tuples})

    def draw(m: int) -> tuple[dict[str, np.ndarray],
                              dict[str, tuple[list, np.ndarray]]]:
        points: dict[str, np.ndarray] = {}
        cats: dict[str, tuple[list, np.ndarray]] = {}
        for name in AXES:
            if name in tuples:
                lo, hi = tuples[name]
                points[name] = rng.integers(int(lo), int(hi) + 1, size=m)
            else:
                vals = lists[name]
                idx = rng.integers(0, len(vals), size=m)
                if name in _CATEGORICAL:
                    cats[name] = (vals, idx)
                else:
                    points[name] = np.asarray(vals)[idx]
        simd = np.asarray(points["simd"], dtype=np.int64)
        n_elems = np.asarray(points["n_elems"], dtype=np.int64)
        points["n_elems"] = np.maximum((n_elems // simd) * simd, simd)
        return points, cats

    if not constraints or n <= 0:
        points, cats = draw(n)
        return points, n, cats

    from repro_torch.search.constraints import (
        columns_from_parts,
        feasibility_mask,
        normalize_constraints,
    )

    constraints = normalize_constraints(constraints)
    batch = max(int(n), 1024)
    budget = 256 * int(n) + 10_000          # total draws before giving up
    drawn = found = 0
    kept_points: list[dict[str, np.ndarray]] = []
    kept_codes: list[dict[str, np.ndarray]] = []
    tables: dict[str, list] = {}
    while found < n and drawn < budget:
        m = min(batch, budget - drawn)
        points, cats = draw(m)
        drawn += m
        mask = feasibility_mask(
            constraints, columns_from_parts(points, cats, m))
        if not mask.any():
            continue
        kept_points.append({k: v[mask] for k, v in points.items()})
        kept_codes.append({k: idx[mask] for k, (_, idx) in cats.items()})
        tables = {k: vals for k, (vals, _) in cats.items()}
        found += int(mask.sum())
    if found < n:
        region = ("appears empty" if found == 0
                  else f"yielded only {found} of {n} requested points")
        raise ValueError(
            f"constrained random sampling: the feasible region {region} "
            f"after {drawn} seeded draws; relax the constraints or widen "
            f"the axis ranges")
    points = {k: np.concatenate([p[k] for p in kept_points])[:n]
              for k in kept_points[0]}
    cats = {k: (tables[k], np.concatenate([c[k] for c in kept_codes])[:n])
            for k in kept_codes[0]}
    return points, n, cats
