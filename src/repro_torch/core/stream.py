"""Bounded-memory streaming evaluation of huge design spaces.

Port of ``repro.core.stream``.  The materialized sweep
(:func:`repro_torch.core.sweep._build`) holds every point, estimate and
resource value in memory before any selection runs; this module supplies
the streaming counterpart:

* :class:`GridEnumerator` — a lazy Cartesian-product enumerator.  A design
  point is one integer id in ``[0, n)``; per-axis indices come out of
  mixed-radix arithmetic (``(ids // stride) % size``), point ``i`` here is
  point ``i`` of the materialized grid, and nothing O(n) is allocated.  An
  empty axis makes an empty (``n == 0``) grid, not an error.
* **Online mergeable reducers** — :class:`ParetoReducer`,
  :class:`TopKReducer` and :class:`StatsReducer` fold one scored chunk at
  a time into a running Pareto front, a bounded best-``k`` selection and
  exact summary stats, so peak memory is O(chunk + front + k).  Every
  reducer implements the **merge protocol** (``merge`` / ``state_dict`` /
  ``from_state`` / ``fresh``): fold any partition of ``[0, n)`` into
  independent reducers, merge the states, and the result is bit-equal to
  the serial fold (variance, combined through the Chan formula, to ~1e-12).
  That is what the process executor (:mod:`repro_torch.core.distributed`)
  and the device fold (:mod:`repro_torch.core.device_stream`) are held to.
  The folds run in NumPy on the host: they are the semantics the device
  fold reproduces.
* :class:`SweepPlan` — a frozen, picklable, data-only description of one
  streaming sweep (normalized axis lists, backend, calibration, chunk
  size, constraints, device).  ``plan.evaluator()`` rebuilds the
  chunk-scoring function from that data alone, so a spawned worker process
  rebuilds the same evaluation from a pickled (or JSON round-tripped) plan.
* :func:`run_stream` — the chunk loop: fixed-shape chunks (the last one
  padded by repeating its last id), sliced before folding, optionally
  pipelined through a thread pool.

A *chunk-column* dict is the currency between the evaluator and the
reducers: ``id`` (global point ids), the normalized numeric axis values,
integer codes for the categorical axes, the per-point estimate fields
(``t_exe``, ``t_ideal``, ``t_ovh``, ``bound_ratio``, ``memory_bound``,
``total_bytes``, ``n_lsu``) and ``resource``, with the dtypes of
:data:`COL_DTYPES`.  Every column is a plain 1-D NumPy array of the chunk
length.
"""
from __future__ import annotations

import dataclasses
import json
import math
from time import perf_counter as _perf_counter
from typing import Callable, Iterable, Mapping, Sequence

import numpy as np

#: Estimate columns every evaluator must provide per chunk.
ESTIMATE_COLUMNS = ("t_exe", "t_ideal", "t_ovh", "bound_ratio",
                    "memory_bound", "total_bytes", "n_lsu")

#: Sweep axes in canonical order (``repro_torch.core.sweep.AXES``, restated
#: so this module imports nothing of the sweep engine at load time).
_AXES = ("lsu_type", "n_ga", "simd", "n_elems", "delta", "elem_bytes",
         "include_write", "val_constant", "dram", "bsp", "hardware")

#: Every chunk column, in order.
COLUMNS = ("id",) + _AXES + ESTIMATE_COLUMNS + ("resource",)

#: The dtype of each chunk column.  ``total_bytes`` and ``n_lsu`` are
#: float64, as the reference's ``np.bincount`` segment sum makes them.
COL_DTYPES = {
    **{a: np.int64 for a in ("id", "lsu_type", "n_ga", "simd", "n_elems",
                             "delta", "elem_bytes", "dram", "bsp",
                             "hardware")},
    **{a: np.float64 for a in ("t_exe", "t_ideal", "t_ovh", "bound_ratio",
                               "resource", "total_bytes", "n_lsu")},
    **{a: np.bool_ for a in ("include_write", "val_constant",
                             "memory_bound")},
}


class GridEnumerator:
    """Lazy mixed-radix view of the Cartesian product of normalized axes.

    ``lists`` maps axis name -> list of values (the output of
    ``sweep._normalize_axes``).  Point ids count through the product in C
    order (first axis slowest), exactly matching the materialized
    ``_grid_points`` layout, so point ``i`` here is point ``i`` there.

    An axis with no values makes the whole grid empty (``n == 0``): no
    point id exists, ``codes`` only ever sees empty id arrays, and the
    streaming loop builds no chunks.
    """

    def __init__(self, lists: Mapping[str, Sequence]):
        self.lists = {k: list(v) for k, v in lists.items()}
        self.names = list(self.lists)
        self.sizes = np.asarray([len(v) for v in self.lists.values()],
                                dtype=np.int64)
        # Strides/modulos are clamped to 1 so an empty axis (size 0) never
        # divides by zero; with n == 0 no id is ever decoded through them.
        sizes_c = np.maximum(self.sizes, 1)
        strides = np.ones(len(sizes_c), dtype=np.int64)
        for i in range(len(sizes_c) - 2, -1, -1):
            strides[i] = strides[i + 1] * sizes_c[i + 1]
        self.strides = strides
        self._mod = sizes_c
        self.n = int(self.sizes.prod()) if len(self.sizes) else 0

    def codes(self, ids: np.ndarray) -> dict[str, np.ndarray]:
        """Per-axis index arrays for the given point ids (no materialization)."""
        ids = np.asarray(ids, dtype=np.int64)
        return {name: (ids // self.strides[i]) % self._mod[i]
                for i, name in enumerate(self.names)}

    def encode(self, codes: Mapping[str, np.ndarray]) -> np.ndarray:
        """Point ids from per-axis index arrays (the inverse of ``codes``).

        This is how the discrete refinement of ``Session.optimize`` maps a
        neighborhood of axis indices back onto global point ids for the
        streaming evaluator.
        """
        out = None
        for i, name in enumerate(self.names):
            term = np.asarray(codes[name], dtype=np.int64) * self.strides[i]
            out = term if out is None else out + term
        return out if out is not None else np.empty(0, dtype=np.int64)


def _concat(held: dict[str, np.ndarray] | None,
            cols: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    if held is None:
        return {k: np.asarray(v) for k, v in cols.items()}
    return {k: np.concatenate([held[k], np.asarray(cols[k])]) for k in held}


def _take(cols: Mapping[str, np.ndarray], idx) -> dict[str, np.ndarray]:
    return {k: np.asarray(v)[idx] for k, v in cols.items()}


def _cols_to_state(cols: dict[str, np.ndarray] | None):
    """Held chunk columns as (dtype, nested-list) pairs — plain picklable
    primitives, lossless for float64/int64/bool round-trips."""
    if cols is None:
        return None
    return {k: [np.asarray(v).dtype.str, np.asarray(v).tolist()]
            for k, v in cols.items()}


def _cols_from_state(state) -> dict[str, np.ndarray] | None:
    if state is None:
        return None
    return {k: np.asarray(data, dtype=np.dtype(dt))
            for k, (dt, data) in state.items()}


class _ExactSum:
    """Exact, mergeable float accumulator (Shewchuk partials, the
    ``math.fsum`` algorithm).

    ``partials`` is a list of non-overlapping doubles whose mathematical
    sum *is* the running total — every ``add`` is exact, so accumulation
    is associative and commutative with no rounding anywhere, and
    ``value`` rounds the total exactly once.  Any grouping of the same
    addends therefore yields the bit-identical ``value``, which is what
    makes distributed stats merges bit-equal to the serial fold no matter
    how ``[0, n)`` was partitioned.
    """

    __slots__ = ("partials",)

    def __init__(self, partials: Iterable[float] = ()):
        self.partials = [float(p) for p in partials]

    def add(self, x: float) -> None:
        x = float(x)
        ps = self.partials
        i = 0
        for y in ps:
            if abs(x) < abs(y):
                x, y = y, x
            hi = x + y
            lo = y - (hi - x)
            if lo:
                ps[i] = lo
                i += 1
            x = hi
        ps[i:] = [x]

    def merge(self, other: "_ExactSum") -> None:
        for p in other.partials:
            self.add(p)

    @property
    def value(self) -> float:
        return math.fsum(self.partials)


def _tree_sum(x: np.ndarray) -> float:
    """Deterministic binary-tree sum of a 1-D float64 array.

    Zero-pads to the next power of two and repeatedly folds ``x[0::2] +
    x[1::2]``.  The pairing is a pure function of element *positions*, and
    zero-extension is exact for the non-negative summands the stats fold
    feeds it (``x + 0.0 == x``), so the result is independent of how much
    the array was padded — an array of ``m`` values zero-extended to any
    power of two >= ``m`` sums to the same bits.  That is the contract that
    lets the fixed-shape device fold (:mod:`repro_torch.core.device_stream`),
    which always sums a full zero-masked chunk, reproduce the host fold's
    per-chunk sums bit-for-bit.
    """
    m = len(x)
    if m == 0:
        return 0.0
    buf = np.zeros(1 << (m - 1).bit_length(), dtype=np.float64)
    buf[:m] = x
    while len(buf) > 1:
        buf = buf[0::2] + buf[1::2]
    return float(buf[0])


def _chan_merge(n_a: int, mean_a: float, m2_a: float,
                n_b: int, mean_b: float, m2_b: float,
                ) -> tuple[int, float, float]:
    """Parallel (Chan et al.) combine of two (count, mean, M2) moment sets.

    Exact in exact arithmetic; in float64 the combined M2 agrees with the
    serial single-pass fold to ~1e-12 relative under any re-grouping.
    Combining with an empty side (n == 0, mean == 0, M2 == 0) is the
    identity bit-for-bit.
    """
    n = n_a + n_b
    if n == 0:
        return 0, 0.0, 0.0
    d = mean_b - mean_a
    mean = mean_a + d * (n_b / n)
    m2 = m2_a + m2_b + d * d * (n_a / n * n_b)
    return n, mean, m2


class Reducer:
    """Protocol of a mergeable online reducer.

    ``update(cols)`` folds one scored chunk.  The merge protocol lets
    independent reducers cover disjoint id ranges and be unioned:

    * ``fresh()`` — an empty reducer with this one's configuration;
    * ``state_dict()`` — accumulated state as picklable primitives;
    * ``from_state(state)`` — rebuild a reducer from ``state_dict()``;
    * ``merge(other)`` — fold another reducer's accumulation into this
      one; merging any partition of the id space must equal the serial
      fold (the distributed executor's correctness contract).

    Custom reducers passed to ``Session.sweep(..., executor="processes")``
    must implement all five and be picklable.
    """

    def update(self, cols: Mapping[str, np.ndarray]) -> None:
        raise NotImplementedError

    def merge(self, other: "Reducer") -> None:
        raise NotImplementedError(
            f"{type(self).__name__} does not implement the merge protocol "
            f"(merge/state_dict/from_state/fresh) required for distributed "
            f"sweeps")

    def state_dict(self) -> dict:
        raise NotImplementedError(
            f"{type(self).__name__} does not implement state_dict()")

    @classmethod
    def from_state(cls, state: dict) -> "Reducer":
        raise NotImplementedError(
            f"{cls.__name__} does not implement from_state()")

    def fresh(self) -> "Reducer":
        raise NotImplementedError(
            f"{type(self).__name__} does not implement fresh()")


class StatsReducer(Reducer):
    """Exact running summary: counts, min (smallest id on ties), sums,
    mean and variance.

    ``n_points``, ``memory_bound``, ``t_exe_min``/``t_exe_min_id`` and the
    sums are bit-equal to the serial fold under *any* partition of the id
    space: the min tie-breaks lexicographically by (value, id) and the
    sums accumulate one float64 partial per chunk through an exact
    (Shewchuk) accumulator, so neither fold order nor merge grouping can
    perturb a bit.  The mean reported by ``summary()`` derives from the
    exact sum.  Variance combines through the parallel/Chan formula
    (:func:`_chan_merge`) — exact in exact arithmetic, ~1e-12 relative in
    float64 under re-grouping.
    """

    def __init__(self):
        self.n_points = 0
        self.memory_bound = 0
        self.t_exe_min = math.inf
        self.t_exe_min_id = -1
        self._t_exe_sum = _ExactSum()
        self._total_bytes_sum = _ExactSum()
        self._mean = 0.0        # Chan running mean of t_exe
        self._m2 = 0.0          # Chan running sum of squared deviations

    # Exact-sum reads (the public names predate the mergeable protocol).
    @property
    def t_exe_sum(self) -> float:
        return self._t_exe_sum.value

    @property
    def total_bytes_sum(self) -> float:
        return self._total_bytes_sum.value

    @property
    def t_exe_mean(self) -> float:
        return self._t_exe_sum.value / self.n_points if self.n_points else 0.0

    @property
    def t_exe_var(self) -> float:
        return self._m2 / self.n_points if self.n_points else 0.0

    def update(self, cols: Mapping[str, np.ndarray]) -> None:
        t = np.asarray(cols["t_exe"], dtype=np.float64)
        m = len(t)
        if not m:
            return
        self.memory_bound += int(np.asarray(cols["memory_bound"]).sum())
        # All chunk-level reductions go through the position-deterministic
        # _tree_sum so the fused on-device fold (device_stream), which sums
        # zero-masked fixed-shape chunks, produces bit-identical chunk
        # contributions to this host fold.
        s = _tree_sum(t)
        self._t_exe_sum.add(s)
        self._total_bytes_sum.add(
            _tree_sum(np.asarray(cols["total_bytes"], dtype=np.float64)))
        cmean = s / m
        cm2 = _tree_sum((t - cmean) ** 2)
        self.n_points, self._mean, self._m2 = _chan_merge(
            self.n_points, self._mean, self._m2, m, cmean, cm2)
        i = int(np.argmin(t))                  # first occurrence on ties
        v, pid = float(t[i]), int(np.asarray(cols["id"])[i])
        if v < self.t_exe_min or (v == self.t_exe_min
                                  and pid < self.t_exe_min_id):
            self.t_exe_min, self.t_exe_min_id = v, pid

    def merge(self, other: "Reducer") -> None:
        if not isinstance(other, StatsReducer):
            raise TypeError(f"cannot merge {type(other).__name__} into "
                            f"StatsReducer")
        if (other.t_exe_min < self.t_exe_min
                or (other.t_exe_min == self.t_exe_min
                    and other.t_exe_min_id < self.t_exe_min_id)):
            self.t_exe_min = other.t_exe_min
            self.t_exe_min_id = other.t_exe_min_id
        self.memory_bound += other.memory_bound
        self._t_exe_sum.merge(other._t_exe_sum)
        self._total_bytes_sum.merge(other._total_bytes_sum)
        self.n_points, self._mean, self._m2 = _chan_merge(
            self.n_points, self._mean, self._m2,
            other.n_points, other._mean, other._m2)

    def state_dict(self) -> dict:
        return {
            "n_points": self.n_points,
            "memory_bound": self.memory_bound,
            "t_exe_min": self.t_exe_min,
            "t_exe_min_id": self.t_exe_min_id,
            "t_exe_sum": list(self._t_exe_sum.partials),
            "total_bytes_sum": list(self._total_bytes_sum.partials),
            "mean": self._mean,
            "m2": self._m2,
        }

    @classmethod
    def from_state(cls, state: dict) -> "StatsReducer":
        r = cls()
        r.n_points = int(state["n_points"])
        r.memory_bound = int(state["memory_bound"])
        r.t_exe_min = float(state["t_exe_min"])
        r.t_exe_min_id = int(state["t_exe_min_id"])
        r._t_exe_sum = _ExactSum(state["t_exe_sum"])
        r._total_bytes_sum = _ExactSum(state["total_bytes_sum"])
        r._mean = float(state["mean"])
        r._m2 = float(state["m2"])
        return r

    def fresh(self) -> "StatsReducer":
        return StatsReducer()

    def summary(self) -> dict:
        return {
            "n_points": self.n_points,
            "memory_bound_points": self.memory_bound,
            "t_exe_min": self.t_exe_min,
            "t_exe_min_id": self.t_exe_min_id,
            "t_exe_sum": self.t_exe_sum,
            "total_bytes_sum": self.total_bytes_sum,
            "t_exe_mean": self.t_exe_mean,
            "t_exe_var": self.t_exe_var,
        }


class TopKReducer(Reducer):
    """Bounded best-``k`` selection by one column (ascending).

    Each fold concatenates the held rows with the chunk, cuts to the ``k``
    smallest with ``np.argpartition`` and breaks value ties by point id, so
    the surviving rows are exactly the first ``k`` of a stable argsort over
    the whole space — bit-equal to the materialized ``top_k``.  Because
    selection depends only on the (value, id) pairs, merging per-range
    top-k states (each of which contains every global-top-k candidate of
    its range) reproduces the global selection bit-for-bit under any
    partition.
    """

    def __init__(self, k: int = 10, key: str = "t_exe"):
        if k < 1:
            raise ValueError("top-k needs k >= 1")
        self.k = int(k)
        self.key = key
        self.cols: dict[str, np.ndarray] | None = None

    def update(self, cols: Mapping[str, np.ndarray]) -> None:
        merged = _concat(self.cols, cols)
        vals = np.asarray(merged[self.key], dtype=np.float64)
        if len(vals) > self.k:
            # argpartition bounds the exact-order work to the candidate set:
            # everything at or below the k-th value competes, then value
            # ties are broken by id (== original position, since ids only
            # grow across folds) to match a stable full argsort.
            part = np.argpartition(vals, self.k - 1)[:self.k]
            cutoff = float(vals[part].max())
            cand = np.flatnonzero(vals <= cutoff)
            order = cand[np.lexsort((merged["id"][cand], vals[cand]))][:self.k]
        else:
            order = np.lexsort((merged["id"], vals))
        self.cols = _take(merged, order)       # kept in rank order

    def merge(self, other: "Reducer") -> None:
        if not isinstance(other, TopKReducer) \
                or (other.k, other.key) != (self.k, self.key):
            raise ValueError(
                f"cannot merge top-k reducers with different configs: "
                f"k={self.k}/key={self.key!r} vs "
                f"k={getattr(other, 'k', None)}/"
                f"key={getattr(other, 'key', None)!r}")
        if other.cols is not None:
            self.update(other.cols)

    def state_dict(self) -> dict:
        return {"k": self.k, "key": self.key,
                "cols": _cols_to_state(self.cols)}

    @classmethod
    def from_state(cls, state: dict) -> "TopKReducer":
        r = cls(int(state["k"]), str(state["key"]))
        r.cols = _cols_from_state(state["cols"])
        return r

    def fresh(self) -> "TopKReducer":
        return TopKReducer(self.k, self.key)

    @property
    def ids(self) -> np.ndarray:
        """Selected point ids, best first."""
        return (np.empty(0, dtype=np.int64) if self.cols is None
                else np.asarray(self.cols["id"], dtype=np.int64))


class ParetoReducer(Reducer):
    """Running Pareto front over the given objective columns (minimized).

    Folding is just ``pareto_front`` over (held front + chunk); because
    every globally non-dominated point survives any partial fold and every
    dominated point is dominated by some front member, the final front is
    invariant to chunk size, chunk order and partition/merge grouping.
    Memory is O(front).
    """

    def __init__(self, objectives: Sequence[str] = ("t_exe", "resource")):
        if not objectives:
            raise ValueError("pareto needs at least one objective column")
        self.objectives = tuple(objectives)
        self.cols: dict[str, np.ndarray] | None = None

    def update(self, cols: Mapping[str, np.ndarray]) -> None:
        from repro_torch.core.sweep import pareto_front

        merged = _concat(self.cols, cols)
        vals = np.stack([np.asarray(merged[o], dtype=np.float64)
                         for o in self.objectives], axis=1)
        self.cols = _take(merged, pareto_front(vals))

    def merge(self, other: "Reducer") -> None:
        if not isinstance(other, ParetoReducer) \
                or other.objectives != self.objectives:
            raise ValueError(
                f"cannot merge pareto reducers with different objectives: "
                f"{self.objectives} vs {getattr(other, 'objectives', None)}")
        if other.cols is not None:
            self.update(other.cols)

    def state_dict(self) -> dict:
        return {"objectives": list(self.objectives),
                "cols": _cols_to_state(self.cols)}

    @classmethod
    def from_state(cls, state: dict) -> "ParetoReducer":
        r = cls(tuple(state["objectives"]))
        r.cols = _cols_from_state(state["cols"])
        return r

    def fresh(self) -> "ParetoReducer":
        return ParetoReducer(self.objectives)

    @property
    def ids(self) -> np.ndarray:
        """Front point ids, ascending."""
        if self.cols is None:
            return np.empty(0, dtype=np.int64)
        return np.sort(np.asarray(self.cols["id"], dtype=np.int64))


def default_reducers(k: int = 10) -> tuple[Reducer, ...]:
    """The reducer set ``Session.sweep`` streams into unless told otherwise."""
    return (ParetoReducer(), TopKReducer(k), StatsReducer())


@dataclasses.dataclass(frozen=True)
class StreamOutcome:
    """What ``run_stream`` hands back: the folded reducers + loop telemetry."""

    reducers: tuple[Reducer, ...]
    n_points: int
    n_chunks: int
    chunk_size: int


def _chunk_ids(start: int, n: int, chunk_size: int) -> tuple[np.ndarray, int]:
    """The fixed-shape id block of the chunk at ``start`` and its valid
    length.  Only the final chunk of the *global* grid is ever padded (by
    repeating its last valid id), so a chunk's contents depend on nothing
    but (start, n, chunk_size) — the property that makes range-partitioned
    evaluation bit-identical to the serial pass."""
    stop = min(start + chunk_size, n)
    ids = np.arange(start, stop, dtype=np.int64)
    if len(ids) < chunk_size:
        ids = np.concatenate(
            [ids, np.full(chunk_size - len(ids), ids[-1], dtype=np.int64)])
    return ids, stop - start


def run_stream(
    n: int,
    chunk_size: int,
    eval_chunk: Callable[[np.ndarray], Mapping[str, np.ndarray]],
    reducers: Iterable[Reducer],
    *,
    workers: int | None = None,
    chunk_order: Sequence[int] | None = None,
    stage_times: dict | None = None,
) -> StreamOutcome:
    """Drive ``eval_chunk`` over ``n`` points in fixed-shape chunks.

    ``eval_chunk(ids)`` always receives exactly ``chunk_size`` ids — the
    last chunk is padded by repeating its final valid id, so an evaluator
    sees one shape only (the device fold's rule too).  The padded
    tail is sliced off every returned column before the reducers fold it.
    ``n == 0`` builds no chunks at all and returns the reducers untouched.

    ``workers > 1`` evaluates chunks through a thread pool while folding
    strictly in submission order, so results are identical to the serial
    loop (the reducers themselves are order-invariant for the Pareto front,
    but top-k tie-breaking and stats argmins rely on ascending ids).
    The evaluator must then be thread-safe (the plan's is).

    ``chunk_order`` permutes which chunk is evaluated when (a testing hook
    for the reducers' order invariance); folding follows that order.

    ``stage_times`` (a mutable dict) accumulates the per-stage wall-time
    breakdown ``Session.sweep(profile=True)`` reports: ``score_s`` (chunk
    evaluation, the host<->device copies of the torch core included) and
    ``reduce_s`` (reducer folds).  Only the
    serial loop is instrumented — the threaded path overlaps stages, so
    per-stage attribution would be meaningless there.
    """
    if chunk_size < 1:
        raise ValueError("chunk_size must be >= 1")
    reducers = tuple(reducers)
    starts = list(range(0, n, chunk_size))
    if chunk_order is not None:
        starts = [starts[i] for i in chunk_order]

    def fold(cols: Mapping[str, np.ndarray], valid: int) -> None:
        # A constrained evaluator returns pre-compacted columns (feasible
        # rows only) — it can only come back full-length when every point
        # of a full chunk was feasible, so slicing off the padded tail is
        # needed exactly when the columns still have the fixed shape.
        if valid != chunk_size and len(cols["id"]) == chunk_size:
            cols = {k: np.asarray(v)[:valid] for k, v in cols.items()}
        if len(cols["id"]) == 0:
            return
        for r in reducers:
            r.update(cols)

    if workers and workers > 1 and len(starts) > 1:
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        w = int(workers)
        with ThreadPoolExecutor(max_workers=w) as ex:
            # At most w+1 chunks exist at once (in flight or awaiting their
            # in-order fold), so the threaded path's peak memory is
            # O(workers * chunk + front + k), not unbounded.
            pending: deque = deque()
            for s in starts:
                ids, valid = _chunk_ids(s, n, chunk_size)
                pending.append((ex.submit(eval_chunk, ids), valid))
                if len(pending) > w:          # fold in submission order
                    fut, v = pending.popleft()
                    fold(fut.result(), v)
            while pending:
                fut, v = pending.popleft()
                fold(fut.result(), v)
    elif stage_times is not None:
        import time as _time

        stage_times.setdefault("score_s", 0.0)
        stage_times.setdefault("reduce_s", 0.0)
        for s in starts:
            ids, valid = _chunk_ids(s, n, chunk_size)
            t0 = _time.perf_counter()
            cols = eval_chunk(ids)
            t1 = _time.perf_counter()
            fold(cols, valid)
            t2 = _time.perf_counter()
            stage_times["score_s"] += t1 - t0
            stage_times["reduce_s"] += t2 - t1
    else:
        for s in starts:
            ids, valid = _chunk_ids(s, n, chunk_size)
            fold(eval_chunk(ids), valid)

    return StreamOutcome(reducers=reducers, n_points=n,
                         n_chunks=len(starts), chunk_size=chunk_size)


# ---------------------------------------------------------------------------
# SweepPlan: the picklable, data-only sweep description
# ---------------------------------------------------------------------------

_PLAN_BACKENDS = ("scalar", "torch")


def _axis_value_to_json(v):
    """One normalized axis value as a JSON-able primitive or tagged dict
    (the reference's encoding, so plans read across the two packages)."""
    from repro_torch.core.fpga import BspParams, DramParams
    from repro_torch.core.lsu import LsuType

    if isinstance(v, LsuType):
        return {"$kind": "lsu_type", "value": v.value}
    if isinstance(v, DramParams):
        return {"$kind": "dram", **dataclasses.asdict(v)}
    if isinstance(v, BspParams):
        return {"$kind": "bsp", **dataclasses.asdict(v)}
    if isinstance(v, np.bool_):
        return bool(v)
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    to_json = getattr(v, "to_json", None)      # repro_torch.hw.Hardware
    if callable(to_json):
        return {"$kind": "hardware", "spec": json.loads(to_json())}
    raise TypeError(f"axis value {v!r} has no JSON encoding")


def _axis_value_from_json(v):
    if not isinstance(v, dict):
        return v
    kind = v.get("$kind")
    fields = {k: x for k, x in v.items() if k != "$kind"}
    if kind == "lsu_type":
        from repro_torch.core.lsu import LsuType

        return LsuType(fields["value"])
    if kind == "dram":
        from repro_torch.core.fpga import DramParams

        return DramParams(**fields)
    if kind == "bsp":
        from repro_torch.core.fpga import BspParams

        return BspParams(**fields)
    if kind == "hardware":
        from repro_torch.hw import Hardware

        return Hardware.from_json(json.dumps(fields["spec"]))
    raise TypeError(f"unknown encoded axis value {v!r}")


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """A frozen, picklable description of one streaming sweep.

    Everything ``Session.sweep`` knows when it streams — the normalized
    per-axis value lists (``Space.lists`` output, hardware axes defaulted),
    the backend (``scalar`` or ``torch``), the session calibration factor,
    the chunk size, the feasibility constraints and the ``device`` the torch
    core scores on — as *data only*.  ``device`` is a string (``"cuda"``,
    ``"cpu"``) so the plan pickles to a spawned worker, which resolves it
    itself; ``None`` means the CUDA card.  ``evaluator()`` rebuilds the
    chunk-scoring function from that data in any process;
    ``to_json()``/``from_json()`` round-trip the plan through text.

    Build one with ``Session.plan(...)`` rather than by hand — that applies
    the same axis normalization ``Session.sweep`` uses.
    """

    lists: Mapping[str, Sequence]
    backend: str = "torch"
    calibration_factor: float = 1.0
    chunk_size: int = 1 << 16
    constraints: tuple = ()
    device: str | None = None

    def __post_init__(self):
        if self.backend not in _PLAN_BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}: pick one "
                             f"of {_PLAN_BACKENDS}")
        if self.chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        missing = [a for a in _AXES if a not in self.lists]
        if missing:
            raise ValueError(f"plan lists must cover every sweep axis; "
                             f"missing {missing}")
        object.__setattr__(
            self, "lists", {k: tuple(self.lists[k]) for k in _AXES})
        if self.constraints:
            from repro_torch.search.constraints import normalize_constraints

            object.__setattr__(
                self, "constraints", normalize_constraints(self.constraints))
        else:
            object.__setattr__(self, "constraints", ())
        if self.device is not None:
            import torch

            object.__setattr__(self, "device", str(torch.device(self.device)))

    # -- geometry -----------------------------------------------------------

    def enumerator(self) -> GridEnumerator:
        return GridEnumerator(self.lists)

    @property
    def n(self) -> int:
        """Total points of the grid (0 when any axis is empty)."""
        return self.enumerator().n

    @property
    def n_chunks(self) -> int:
        return -(-self.n // self.chunk_size)

    def feasible_mask(self, ids: np.ndarray) -> np.ndarray:
        """Boolean keep-mask of the plan's constraints over point ids.

        A pure function of each point's own configuration — no scoring —
        which is why masking a chunk *before* evaluation is bit-equal to
        post-filtering the unconstrained sweep.  All-True when the plan
        carries no constraints.
        """
        ids = np.asarray(ids, dtype=np.int64)
        if not self.constraints:
            return np.ones(len(ids), dtype=bool)
        from repro_torch.search.constraints import (
            columns_from_lists,
            feasibility_mask,
        )

        enum = self.enumerator()
        cols = columns_from_lists(self.lists, enum.codes(ids))
        return feasibility_mask(self.constraints, cols)

    # -- evaluation ---------------------------------------------------------

    def evaluator(self, stage_times: dict | None = None,
                  ) -> Callable[[np.ndarray], dict[str, np.ndarray]]:
        """The chunk-scoring function, rebuilt from plan data alone.

        Maps an id block to the chunk-column dict the reducers fold: ids
        decoded and axis values gathered on the host, scored by the torch
        core on the plan's device (resolved here, so the CUDA card unless
        the plan says ``cpu``) or by the scalar loop.

        When the plan carries constraints, each chunk is feasibility-masked
        *before* scoring: the returned columns hold only the feasible rows
        (possibly zero), already unpadded.

        ``stage_times`` (see :func:`run_stream`) accumulates ``enumerate_s``
        (mixed-radix decode + axis gathers).
        """
        import functools

        from repro_torch.core import sweep as _sweep

        lists = {k: list(v) for k, v in self.lists.items()}
        enum = GridEnumerator(lists)
        backend = self.backend
        cat_names = [a for a in _AXES if a in _sweep._CATEGORICAL]
        num_names = [a for a in _AXES if a not in _sweep._CATEGORICAL]
        c = self.calibration_factor

        estimator = None
        if backend == "torch":
            from repro_torch import compat
            from repro_torch.core import model_batch as _mb

            estimator = functools.partial(
                _mb.estimate_batch, device=compat.resolve_device(self.device),
                paired_kernel=True)

        def score_ids(ids: np.ndarray) -> dict[str, np.ndarray]:
            m = len(ids)
            t0 = _perf_counter() if stage_times is not None else 0.0
            codes = enum.codes(ids)
            numeric = {k: np.asarray(lists[k])[codes[k]] for k in num_names}
            cats = {k: (lists[k], codes[k]) for k in cat_names}
            if stage_times is not None:
                stage_times["enumerate_s"] = (
                    stage_times.get("enumerate_s", 0.0)
                    + _perf_counter() - t0)
            if backend == "scalar":
                result = _sweep._score_scalar(dict(numeric), m, cats)
                est, resource = result.estimate, result.resource
                numeric = {k: result.points[k] for k in num_names}
                cats, _, own = _sweep._resolve_hardware_codes(cats, m)
            else:
                est, resource, cats, numeric, own = _sweep._score(
                    numeric, cats, m, estimator)
            cols: dict[str, np.ndarray] = {
                "id": np.asarray(ids, dtype=np.int64)}
            for k in num_names:
                cols[k] = np.asarray(numeric[k])
            for k in cat_names:
                cols[k] = np.asarray(cats[k][1], dtype=np.int64)
            scale = np.where(own, c, 1.0) if c != 1.0 else None
            for name in ESTIMATE_COLUMNS:
                v = np.asarray(getattr(est, name), dtype=COL_DTYPES[name])
                if scale is not None and name in ("t_exe", "t_ideal",
                                                  "t_ovh"):
                    v = v * scale       # session calibration, like sweep()
                cols[name] = v
            cols["resource"] = np.asarray(resource)
            return cols

        if not self.constraints:
            return score_ids

        from repro_torch.search.constraints import (
            columns_from_lists,
            feasibility_mask,
        )

        constraints = self.constraints

        def eval_chunk(ids: np.ndarray) -> dict[str, np.ndarray]:
            ids = np.asarray(ids, dtype=np.int64)
            # Chunk ids are strictly increasing until the padded tail
            # repeats the last valid id, so the first occurrence of the
            # final id marks the valid length.
            valid = int(np.searchsorted(ids, ids[-1])) + 1 if len(ids) else 0
            live = ids[:valid]
            mask = feasibility_mask(
                constraints, columns_from_lists(lists, enum.codes(live)))
            feas = live[mask]
            f = len(feas)
            if f == len(ids):
                return score_ids(ids)
            # score one throwaway row when empty so every column keeps
            # its dtype
            cols = score_ids(feas if f else ids[:1])
            return {k: np.asarray(v)[:f] for k, v in cols.items()}

        return eval_chunk

    def tables(self) -> dict[str, list]:
        """Resolved categorical tables (dram/bsp extended with the
        hardware-axis views) — what survivor-row codes index into."""
        from repro_torch.core import sweep as _sweep

        cat_names = [a for a in _AXES if a in _sweep._CATEGORICAL]
        probe = {k: (list(self.lists[k]), np.zeros(1, dtype=np.int64))
                 for k in cat_names}
        return {k: v[0] for k, v in
                _sweep._resolve_hardware_codes(probe, 1)[0].items()}

    def run_range(self, lo: int, hi: int, reducers: Iterable[Reducer], *,
                  eval_chunk: Callable | None = None) -> tuple[Reducer, ...]:
        """Fold the chunks covering point ids ``[lo, hi)`` into ``reducers``.

        ``lo`` (and ``hi``, unless it is ``n``) must sit on chunk
        boundaries: work units are unions of whole chunks of the *global*
        chunk grid, so every chunk a worker evaluates is bit-identical to
        the chunk the serial pass would have evaluated.
        """
        n = self.n
        lo, hi = int(lo), min(int(hi), n)
        if lo % self.chunk_size:
            raise ValueError(f"range start {lo} is not chunk-aligned "
                             f"(chunk_size={self.chunk_size})")
        if hi % self.chunk_size and hi != n:
            raise ValueError(f"range stop {hi} is not chunk-aligned "
                             f"(chunk_size={self.chunk_size}) and is not "
                             f"the grid end {n}")
        if eval_chunk is None:
            eval_chunk = self.evaluator()
        reducers = tuple(reducers)
        for start in range(lo, hi, self.chunk_size):
            ids, valid = _chunk_ids(start, n, self.chunk_size)
            cols = eval_chunk(ids)
            # Same rule as run_stream's fold: a constrained evaluator has
            # already compacted to the feasible rows.
            if valid != self.chunk_size \
                    and len(cols["id"]) == self.chunk_size:
                cols = {k: np.asarray(v)[:valid] for k, v in cols.items()}
            if len(cols["id"]) == 0:
                continue
            for r in reducers:
                r.update(cols)
        return reducers

    def run(self, reducers: Iterable[Reducer], *,
            workers: int | None = None) -> StreamOutcome:
        """Serial/threaded whole-grid host fold (``run_stream`` over this
        plan)."""
        return run_stream(self.n, self.chunk_size, self.evaluator(),
                          reducers, workers=workers)

    # -- serialization ------------------------------------------------------

    def to_json(self) -> str:
        """The plan as canonical JSON (axis values via typed codecs).

        Constraints ride along as tagged dicts; a plan carrying a custom
        callable constraint raises here (pickle still carries it).
        """
        out = {
            "version": 1,
            "backend": self.backend,
            "calibration_factor": self.calibration_factor,
            "chunk_size": self.chunk_size,
            "device": self.device,
            "lists": {k: [_axis_value_to_json(v) for v in vs]
                      for k, vs in self.lists.items()},
        }
        if self.constraints:
            from repro_torch.search.constraints import constraint_to_json

            out["constraints"] = [constraint_to_json(c)
                                  for c in self.constraints]
        return json.dumps(out, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "SweepPlan":
        d = json.loads(text)
        encoded = d.get("constraints", [])
        constraints: tuple = ()
        if encoded:
            from repro_torch.search.constraints import constraint_from_json

            constraints = tuple(constraint_from_json(o) for o in encoded)
        return cls(
            lists={k: [_axis_value_from_json(v) for v in vs]
                   for k, vs in d["lists"].items()},
            backend=d["backend"],
            calibration_factor=float(d["calibration_factor"]),
            chunk_size=int(d["chunk_size"]),
            constraints=constraints,
            device=d.get("device"))


def make_range_folder(plan: SweepPlan) -> Callable:
    """``fold(lo, hi, reducers)`` for chunk-aligned ranges of ``plan``.

    On the unconstrained torch backend with the standard reducers this is
    the device fold (:mod:`repro_torch.core.device_stream`: enumeration,
    scoring and the reducer folds on the plan's device, one state pull per
    range); otherwise, or when a device carry overflows its capacity
    (:class:`~repro_torch.core.device_stream.DeviceFoldOverflow`), the host
    ``plan.run_range`` loop refolds the range.  Both are bit-equal by the
    reducer merge contract, so callers (the process workers) never see
    which one ran.  The host evaluator is built lazily.
    """
    device = None
    if plan.backend == "torch" and not plan.constraints:
        from repro_torch.core import device_stream as _dev

        device = _dev.DeviceSweep.build(plan)

    evaluator = None

    def fold_range(lo: int, hi: int, reducers: Iterable[Reducer]) -> None:
        nonlocal evaluator
        reducers = tuple(reducers)
        if device is not None and device.supports(reducers):
            from repro_torch.core.device_stream import DeviceFoldOverflow
            try:
                device.fold_range(lo, hi, reducers)
                return
            except DeviceFoldOverflow:
                pass        # reducers untouched; refold on the host path
        if evaluator is None:
            evaluator = plan.evaluator()
        plan.run_range(lo, hi, reducers, eval_chunk=evaluator)

    return fold_range
