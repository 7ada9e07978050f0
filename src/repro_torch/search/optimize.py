"""``Session.optimize`` — find grid optima without enumerating the grid.

Port of ``repro.search.optimize``.  The analytical model is closed-form
and differentiable, so the integer axes can be relaxed to continuous
coordinates and descended through the same Eqs. 1-10 the sweep scores.
The search runs in phases:

1. **screen** — a seeded uniform sample of the grid, feasibility-masked
   *before* scoring, scored through the plan's streaming evaluator.
2. **descend** — the screened winners seed one *lane* per categorical
   combination; each lane relaxes the numeric axes to continuous
   sorted-index coordinates (a piecewise-linear lookup over the sorted
   axis values) and multi-start AdamW (:mod:`repro_torch.optim.adamw`)
   descends ``log(objective)`` plus smooth envelope-cap penalties with
   ``torch.autograd`` in float64 through
   :func:`repro_torch.core.model_batch.estimate_columns` on the plan's
   device.  All lanes descend together as one batch of ``2 * lanes`` LSU
   groups — the exact group expansion ``sweep._score`` uses.
3. **refine** — each continuous optimum is snapped to its discrete
   neighborhood (round plus axis-wise floor/ceil), then a greedy ±1-code
   coordinate descent polishes the incumbent.  Every candidate goes
   through the *unconstrained* plan evaluator, so each scored number is
   bit-identical to what the exhaustive sweep produces for that id.
4. **Pareto local search** (2-objective mode) — the running front's
   ±1-code neighbors are expanded, masked and scored until the front
   stops moving or the evaluation budget runs out.

Everything is budgeted: ``max_evals`` (default ``max(1024, n // 128)`` —
under 1% of any large grid) caps scored rows across all phases, and the
report carries the exact telemetry.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import model_batch as _mb
from repro_torch.core import stream as _stream
from repro_torch.core import sweep as _sweep
from repro_torch.search.constraints import (
    columns_from_lists,
    envelope_caps,
    feasibility_mask,
    normalize_constraints,
)
from repro_torch.search.envelope import max_transaction_bytes, usage_from_axes

#: Columns an objective may name: estimator outputs + the interconnect cost.
OBJECTIVE_COLUMNS = _stream.ESTIMATE_COLUMNS + ("resource",)

#: Weight of the smooth envelope penalty in the relaxed descent loss.
_PENALTY_RHO = 10.0


def _cat_label(v) -> str:
    if v is None:
        return "-"
    return getattr(v, "name", None) or str(v)


# ---------------------------------------------------------------------------
# evaluation log: every grid point ever scored, with budget accounting
# ---------------------------------------------------------------------------


class _EvalLog:
    """Scored-point store + the eval budget, shared by every phase.

    All ids handed to :meth:`evaluate` are deduplicated against what was
    already scored and feasibility-masked *before* spending budget, so the
    log only ever holds feasible rows and the budget only pays for fresh
    work.
    """

    def __init__(self, plan, constraints, budget: int):
        self.plan = plan
        self.enum = plan.enumerator()
        self.lists = {k: list(v) for k, v in plan.lists.items()}
        self.constraints = constraints
        self.budget = int(budget)
        self.spent = 0              # total charged rows (padding included)
        self.grid_evals = 0         # distinct grid points actually scored
        self.relaxed_evals = 0      # continuous-descent model rows
        self._eval = plan.evaluator()
        self._seen: set[int] = set()
        self._blocks: list[dict[str, np.ndarray]] = []
        self._cols: dict[str, np.ndarray] | None = None

    @property
    def remaining(self) -> int:
        return max(0, self.budget - self.spent)

    def feasible(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids, dtype=np.int64)
        if not self.constraints or not len(ids):
            return ids
        cols = columns_from_lists(self.lists, self.enum.codes(ids))
        return ids[feasibility_mask(self.constraints, cols)]

    def evaluate(self, ids: np.ndarray) -> int:
        """Score the fresh, feasible subset of ``ids`` (budget permitting).

        Returns how many new grid points were scored.
        """
        ids = np.unique(np.asarray(ids, dtype=np.int64))
        ids = ids[(ids >= 0) & (ids < self.enum.n)]
        if len(self._seen):
            ids = np.asarray([i for i in ids.tolist() if i not in self._seen],
                             dtype=np.int64)
        ids = self.feasible(ids)
        if not len(ids) or self.remaining <= 0:
            return 0
        if len(ids) > self.remaining:
            ids = ids[:self.remaining]
        m = len(ids)
        cols = {k: np.asarray(v) for k, v in self._eval(ids).items()}
        self.spent += m
        self.grid_evals += m
        self._seen.update(ids.tolist())
        self._blocks.append(cols)
        self._cols = None
        return m

    def columns(self) -> dict[str, np.ndarray]:
        """Everything scored so far, concatenated (cached until next eval)."""
        if self._cols is None:
            if not self._blocks:
                return {}
            self._cols = {k: np.concatenate([b[k] for b in self._blocks])
                          for k in self._blocks[0]}
        return self._cols

    def argbest(self, objective: str) -> int | None:
        """Row index of the incumbent (min objective, min id tie-break)."""
        cols = self.columns()
        if not cols or not len(cols["id"]):
            return None
        vals = np.asarray(cols[objective], dtype=np.float64)
        best = np.flatnonzero(vals == vals.min())
        return int(best[np.argmin(cols["id"][best])])

    def front(self, objectives: Sequence[str]) -> np.ndarray:
        """Row indices of the Pareto front over the scored points."""
        cols = self.columns()
        if not cols or not len(cols["id"]):
            return np.empty(0, dtype=np.int64)
        vals = np.stack([np.asarray(cols[o], dtype=np.float64)
                         for o in objectives], axis=1)
        return _sweep.pareto_front(vals)


# ---------------------------------------------------------------------------
# neighborhoods on the coded grid
# ---------------------------------------------------------------------------


def _neighbor_ids(enum: _stream.GridEnumerator, ids: np.ndarray) -> np.ndarray:
    """±1-code neighbors of ``ids`` along every axis (clipped, deduped)."""
    ids = np.asarray(ids, dtype=np.int64)
    if not len(ids):
        return ids
    codes = enum.codes(ids)
    out = []
    for i, name in enumerate(enum.names):
        k = int(enum.sizes[i])
        if k < 2:
            continue
        for step in (-1, 1):
            c = codes[name] + step
            ok = (c >= 0) & (c < k)
            if not ok.any():
                continue
            shifted = dict(codes)
            shifted = {a: v[ok] for a, v in shifted.items()}
            shifted[name] = c[ok]
            out.append(enum.encode(shifted))
    if not out:
        return np.empty(0, dtype=np.int64)
    return np.unique(np.concatenate(out))


# ---------------------------------------------------------------------------
# phase 2: continuous relaxation + multi-start AdamW descent
# ---------------------------------------------------------------------------


def _interp(u: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear lookup of ``table`` at continuous index ``u``
    (``jnp.interp(u, arange(K), table)``): on each segment ``[i-1, i]``
    with ``i = searchsorted(knots, u, right)`` clipped to ``[1, K-1]``,
    ``table[i-1] + (u - (i-1)) * (table[i] - table[i-1])``.  Exact at the
    knots, and its gradient is the slope of the segment to the right."""
    k = table.shape[0]
    knots = torch.arange(k, dtype=table.dtype, device=table.device)
    hi = torch.clamp(torch.searchsorted(knots, u.detach(), right=True),
                     1, k - 1)
    lo = hi - 1
    return table[lo] + (u - knots[lo]) * (table[hi] - table[lo])


class _Relaxed:
    """The relaxed descent objective of a set of seed lanes.

    Each lane fixes its categorical axes and narrow numeric axes at its
    seed's values and relaxes every numeric axis with at least three
    distinct values to a continuous sorted-index coordinate.  ``values``
    maps coordinates to per-lane objective values through the sweep's
    two-group expansion (:func:`sweep._group_columns`) and
    :func:`model_batch.estimate_columns` — at integer coordinates bit-equal
    to the grid's own scores — and ``loss`` is ``sum(log(objective))``
    plus the envelope penalties.
    """

    def __init__(self, log: "_EvalLog", seeds: np.ndarray, objective: str,
                 constraints, relaxed: list[str], device):
        enum, lists = log.enum, log.lists
        self.objective = objective
        self.relaxed = relaxed
        self.device = device
        S = self.S = len(seeds)
        codes = self.codes = enum.codes(seeds)
        f64 = dict(dtype=torch.float64, device=device)
        # Per-axis sorted value tables; ``perm`` maps sorted index -> code.
        self.svals, self.perms, self.inv = {}, {}, {}
        for a in relaxed:
            vals = np.asarray(lists[a], dtype=np.float64)
            self.perms[a] = np.argsort(vals, kind="stable")
            self.svals[a] = torch.as_tensor(vals[self.perms[a]], **f64)
            self.inv[a] = np.argsort(self.perms[a])   # code -> sorted index
        type_table = [_mb.TYPE_CODE[t] for t in lists["lsu_type"]]
        tc = np.asarray(type_table, dtype=np.int64)[codes["lsu_type"]]
        self.tc = torch.as_tensor(tc, device=device)
        self.fixed = {a: torch.as_tensor(np.asarray(lists[a], dtype=np.float64)
                                         [codes[a]], **f64)
                      for a in _sweep._NUMERIC if a not in relaxed}
        cats = {a: (lists[a], codes[a])
                for a in _sweep.AXES if a in _sweep._CATEGORICAL}
        cats, hw_scale, _ = _sweep._resolve_hardware_codes(cats, S)
        self.hw_scale = torch.as_tensor(np.asarray(hw_scale, np.float64),
                                        **f64)
        dram_table, dram_idx = cats["dram"]
        bsp_table, bsp_idx = cats["bsp"]
        hwf = {k: np.asarray([getattr(d, k) if d is not None else 0
                              for d in dram_table], dtype=np.float64)[dram_idx]
               for k in ("dq", "bl", "f_mem", "t_rcd", "t_rp", "t_wr")}
        hwf["max_th"] = np.asarray([getattr(b, "max_th") if b is not None
                                    else 0 for b in bsp_table],
                                   dtype=np.float64)[bsp_idx]
        burst = np.asarray([getattr(b, "burst_cnt") if b is not None else 0
                            for b in bsp_table], dtype=np.int64)[bsp_idx]
        self.max_txn = torch.as_tensor(
            max_transaction_bytes(hwf["dq"], hwf["bl"], burst), **f64)
        self.hw = {k: torch.as_tensor(v, device=device)
                   for k, v in dict(hwf, burst_cnt=burst).items()}
        self.caps = envelope_caps(constraints)
        self.kmax = {a: float(len(self.svals[a]) - 1) for a in relaxed}
        self._lo = torch.zeros((), **f64)
        self._hi = {a: torch.as_tensor(k, **f64) for a, k in self.kmax.items()}

    def start(self) -> dict[str, torch.Tensor]:
        """Each lane's seed as sorted-index coordinates."""
        return {a: torch.as_tensor(self.inv[a][self.codes[a]],
                                   dtype=torch.float64, device=self.device)
                for a in self.relaxed}

    def values(self, params: dict[str, torch.Tensor]):
        """``(per-lane objective, per-lane axis values)``."""
        v = dict(self.fixed)
        for a in self.relaxed:
            # jnp.clip as max-then-min: a coordinate sitting on a bound
            # (every seed on an axis end) passes half its gradient, as in
            # the reference; torch.clamp would pass all of it
            u = torch.minimum(torch.maximum(params[a], self._lo),
                              self._hi[a])
            v[a] = _interp(u, self.svals[a])
        num = {a: v[a] for a in ("n_ga", "simd", "n_elems", "elem_bytes",
                                 "delta")}
        num.update(include_write=v["include_write"] != 0,
                   val_constant=v["val_constant"] != 0)
        cols, norm = _sweep._group_columns(self.tc, num, self.hw)
        if self.objective == "resource":
            w = cols["count"] * cols["ls_width"]
            obj = w[:self.S] + w[self.S:]
        else:
            est, _ = _mb.estimate_columns(cols, self.S, paired_kernel=True,
                                          want=(self.objective,))
            obj = est[self.objective]
            if self.objective in ("t_exe", "t_ideal", "t_ovh"):
                obj = obj * self.hw_scale
        return obj, dict(num, include_write=norm["include_write"])

    def loss(self, params: dict[str, torch.Tensor]) -> torch.Tensor:
        obj, v = self.values(params)
        loss = torch.sum(torch.log(torch.clamp(obj.to(torch.float64),
                                               min=1e-300)))
        if self.caps:
            usage = usage_from_axes(
                type_codes=self.tc, n_ga=v["n_ga"], simd=v["simd"],
                elem_bytes=v["elem_bytes"], include_write=v["include_write"],
                max_txn=self.max_txn)
            for name, cap in self.caps.items():
                over = torch.clamp((usage[name] - cap) / max(cap, 1e-300),
                                   min=0.0)
                loss = loss + _PENALTY_RHO * torch.sum(over ** 2)
        return loss


def _descend(log: _EvalLog, seeds: np.ndarray, objective: str,
             constraints, steps: int) -> tuple[np.ndarray, dict]:
    """Relax the wide numeric axes and descend all seed lanes at once.

    Returns (candidate grid ids near the continuous optima, phase record).
    Returns no candidates when there is nothing to relax, no seed survived
    screening, or ``steps < 1``.  The descent runs with ``torch.autograd``
    in float64 on the plan's device.
    """
    from repro_torch import compat
    from repro_torch.optim.adamw import (
        OptimizerConfig,
        adamw_init,
        adamw_update,
    )

    enum, lists = log.enum, log.lists
    relaxed = [a for a in _sweep._NUMERIC
               if len(set(map(float, lists[a]))) >= 3]
    record: dict[str, Any] = {"phase": "descend", "lanes": 0, "steps": 0,
                              "relaxed_axes": relaxed}
    if not len(seeds) or not relaxed or steps < 1:
        record["skipped"] = "no seeds" if not len(seeds) else "no relaxed axes"
        return np.empty(0, dtype=np.int64), record

    S = len(seeds)
    relax = _Relaxed(log, seeds, objective, constraints, relaxed,
                     compat.resolve_device(log.plan.device))
    cfg = OptimizerConfig(lr=0.15, warmup_steps=0, total_steps=steps,
                          weight_decay=0.0, clip_norm=1e6, min_lr_ratio=0.2,
                          state_dtype="float32")
    params = relax.start()
    state = adamw_init(params, cfg)
    losses = []
    for _ in range(steps):
        leaves = {a: p.detach().requires_grad_(True)
                  for a, p in params.items()}
        loss = relax.loss(leaves)
        losses.append(loss.detach())
        if not loss.requires_grad:
            # A constant objective (``memory_bound``): its gradient is zero
            # everywhere, so no step can move a lane.
            continue
        # An objective that ignores an axis leaves that leaf unused; its
        # gradient is zero, as ``jax.value_and_grad`` gives it.
        grads = {a: torch.zeros_like(leaves[a]) if g is None else g
                 for a, g in zip(leaves, torch.autograd.grad(
                     loss, list(leaves.values()), allow_unused=True))}
        with torch.no_grad():
            params, state, _ = adamw_update(grads, state, leaves, cfg)
            params = {a: torch.clamp(p, 0.0, relax.kmax[a])
                      for a, p in params.items()}
    losses = torch.stack(losses).cpu().numpy()
    u_final = {a: params[a].cpu().numpy().astype(np.float64)
               for a in relaxed}

    # Descent evaluations count against the budget: S model rows per step.
    log.spent += S * steps
    log.relaxed_evals += S * steps

    # Snap each lane back to the grid: rounded point + axis-wise floor/ceil.
    base = {a: np.asarray(c) for a, c in relax.codes.items()}
    cands = []

    def snap(u_codes):
        c = dict(base)
        for a in relaxed:
            c[a] = relax.perms[a][u_codes[a]]
        cands.append(log.enum.encode(c))

    kmax = relax.kmax
    rounded = {a: np.clip(np.rint(u_final[a]).astype(np.int64), 0,
                          int(kmax[a])) for a in relaxed}
    snap(rounded)
    for a in relaxed:
        for f in (np.floor, np.ceil):
            variant = dict(rounded)
            variant[a] = np.clip(f(u_final[a]).astype(np.int64), 0,
                                 int(kmax[a]))
            snap(variant)
    record.update(lanes=S, steps=steps, loss_first=float(losses[0]),
                  loss_last=float(losses[-1]))
    return np.unique(np.concatenate(cands)), record


# ---------------------------------------------------------------------------
# the report
# ---------------------------------------------------------------------------


def _report_base():
    from repro_torch import api as _api

    return _api.Report


@dataclasses.dataclass(frozen=True)
class OptimizeReport:
    """What ``Session.optimize`` found, plus the telemetry backing it.

    ``best`` is a full :class:`repro_torch.Estimate` for the winning grid point
    (scored by the same evaluator an exhaustive sweep uses, so it is
    bit-comparable to the grid optimum); ``front`` holds the evaluated
    2-objective Pareto approximation in Pareto mode.  ``n_evals`` counts
    every model row the search paid for — screen, relaxed descent and
    discrete refinement — and ``evals_fraction``
    is the headline <1%-of-the-grid number.
    """

    kind = "optimize"
    objectives: tuple
    backend: str
    n_total: int
    n_evals: int
    n_grid_evals: int
    n_relaxed_evals: int
    n_screened: int
    best_id: int
    best: Any                     # repro_torch.Estimate
    best_config: Mapping[str, Any]
    front_ids: np.ndarray
    front: Mapping[str, np.ndarray]
    trajectory: tuple
    constraints: tuple = ()

    @property
    def evals_fraction(self) -> float:
        return self.n_evals / self.n_total if self.n_total else 0.0

    @property
    def n_front(self) -> int:
        return len(self.front_ids)

    def rows(self) -> list[dict]:
        """One dict per front point (the best point alone in scalar mode)."""
        cols = self.front
        out = []
        for i in range(len(self.front_ids)):
            row = {"id": int(self.front_ids[i])}
            for a in _sweep.AXES:
                v = cols[a][i]
                row[a] = _cat_label(v) if a in _sweep._CATEGORICAL else v
            for o in ("t_exe", "resource"):
                row[o] = float(cols[o][i])
            for o in self.objectives:
                row[o] = float(cols[o][i])
            out.append(row)
        return out

    def to_csv(self) -> str:
        return _report_base().to_csv(self)

    def summary(self) -> dict:
        return {
            "kind": self.kind,
            "objectives": list(self.objectives),
            "backend": self.backend,
            "n_total": self.n_total,
            "n_evals": self.n_evals,
            "n_grid_evals": self.n_grid_evals,
            "n_relaxed_evals": self.n_relaxed_evals,
            "n_screened": self.n_screened,
            "evals_fraction": self.evals_fraction,
            "best_id": self.best_id,
            "best_t_exe": self.best.t_exe,
            "best_" + self.objectives[0]: float(
                np.asarray(self.front[self.objectives[0]]).min())
            if len(self.front_ids) else None,
            "n_front": self.n_front,
            "phases": [dict(t) for t in self.trajectory],
        }


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------


def run_optimize(session, space, *, objective="t_exe", constraints=(),
                 seed: int = 0, max_evals: int | None = None,
                 n_starts: int = 2, steps: int = 16,
                 screen: int | None = None,
                 chunk_size: int | None = None) -> OptimizeReport:
    """The engine behind ``Session.optimize`` (see its docstring).

    Free function of (session, space) so tests can drive phases with
    explicit budgets; always returns an :class:`OptimizeReport`.
    """
    from repro_torch import api as _api

    objectives = ((objective,) if isinstance(objective, str)
                  else tuple(objective))
    if not 1 <= len(objectives) <= 2:
        raise ValueError("objective must be one column or a pair of columns")
    for o in objectives:
        if o not in OBJECTIVE_COLUMNS:
            raise ValueError(f"unknown objective {o!r}: pick from "
                             f"{OBJECTIVE_COLUMNS}")
    primary = objectives[0]
    pareto_mode = len(objectives) == 2

    cons = normalize_constraints(constraints)
    plan = session.plan(space, chunk_size=chunk_size)
    n = plan.n
    if n == 0:
        raise ValueError("cannot optimize an empty space")
    budget = int(max_evals) if max_evals is not None else max(1024, n // 128)
    if budget < 1:
        raise ValueError("max_evals must be >= 1")
    log = _EvalLog(plan, cons, budget)
    enum = log.enum
    rng = np.random.default_rng(seed)
    trajectory: list[dict] = []

    if n <= budget:
        # Small grid: the budget covers exhaustive evaluation — be exact.
        scored = log.evaluate(np.arange(n, dtype=np.int64))
        if scored == 0 and cons:
            raise ValueError(
                "Session.optimize: constraints eliminated every point of "
                f"the {n}-point grid; relax the constraints or widen the "
                "space")
        trajectory.append({"phase": "exhaustive", "evals": scored})
        n_screened = scored
    else:
        # Phase 1: seeded feasible screen (rejection sampling on the grid).
        target = (int(screen) if screen is not None
                  else min(1024, max(128, budget // 8)))
        target = min(target, budget)
        feas: list[np.ndarray] = []
        found, drawn = 0, 0
        attempts = max(50_000, 64 * target)
        while found < target and drawn < attempts:
            batch = rng.integers(0, n, size=min(4 * target, attempts - drawn))
            drawn += len(batch)
            keep = log.feasible(np.unique(batch))
            if len(keep):
                feas.append(keep)
                found += len(keep)
        if not found:
            raise ValueError(
                "Session.optimize: no feasible point in the first "
                f"{drawn} seeded probes of the {n}-point grid; relax the "
                "constraints or widen the space")
        screened = np.unique(np.concatenate(feas))[:target]
        log.evaluate(screened)
        n_screened = len(screened)
        trajectory.append({"phase": "screen", "probes": drawn,
                           "feasible": int(found), "evals": n_screened})

        # Phase 2: lane seeds = best screened point(s) per categorical
        # combination (plus the narrow numeric axes descent cannot move).
        cols = log.columns()
        relaxed = {a for a in _sweep._NUMERIC
                   if len(set(map(float, log.lists[a]))) >= 3}
        key_axes = [a for a in _sweep.AXES if a not in relaxed]
        ids_sorted = np.asarray(cols["id"])[np.argsort(
            np.asarray(cols[primary], dtype=np.float64), kind="stable")]
        lane_cap = max(int(n_starts), int(0.4 * budget) // max(steps, 1))
        per_lane: dict[tuple, int] = {}
        seeds = []
        key_codes = enum.codes(ids_sorted)
        for i, pid in enumerate(ids_sorted.tolist()):
            key = tuple(int(key_codes[a][i]) for a in key_axes)
            if per_lane.get(key, 0) >= int(n_starts):
                continue
            per_lane[key] = per_lane.get(key, 0) + 1
            seeds.append(pid)
            if len(seeds) >= lane_cap:
                break
        seeds = np.asarray(seeds, dtype=np.int64)

        cands, record = _descend(log, seeds, primary, cons, steps)
        trajectory.append(record)
        if len(cands):
            scored = log.evaluate(cands)
            trajectory.append({"phase": "refine-snap", "candidates":
                               len(cands), "evals": scored})

        # Phase 3: greedy ±1-code coordinate descent from the incumbent.
        polish_evals, rounds = 0, 0
        while log.remaining > 0:
            b = log.argbest(primary)
            if b is None:
                break
            best_id = int(log.columns()["id"][b])
            best_val = float(log.columns()[primary][b])
            scored = log.evaluate(_neighbor_ids(enum, np.asarray([best_id])))
            polish_evals += scored
            rounds += 1
            nb = log.argbest(primary)
            if nb is None or float(log.columns()[primary][nb]) >= best_val:
                break
        trajectory.append({"phase": "polish", "rounds": rounds,
                           "evals": polish_evals})

        # Phase 4: Pareto local search — walk the front's neighbors until
        # it stops moving (2-objective mode only).
        if pareto_mode:
            pls_evals, rounds = 0, 0
            prev: frozenset = frozenset()
            while log.remaining > 0 and rounds < 16:
                fidx = log.front(objectives)
                fids = np.asarray(log.columns()["id"])[fidx]
                if frozenset(fids.tolist()) == prev:
                    break
                prev = frozenset(fids.tolist())
                scored = log.evaluate(_neighbor_ids(enum, fids))
                pls_evals += scored
                rounds += 1
                if scored == 0:
                    break
            trajectory.append({"phase": "pareto-local-search",
                               "rounds": rounds, "evals": pls_evals})

    cols = log.columns()
    if not cols or not len(cols["id"]):
        raise ValueError("Session.optimize: the evaluation budget "
                         f"({budget}) was too small to score any feasible "
                         "point; raise max_evals")
    b = log.argbest(primary)
    best_id = int(cols["id"][b])
    best = _api.Estimate(
        t_exe=float(cols["t_exe"][b]), t_ideal=float(cols["t_ideal"][b]),
        t_ovh=float(cols["t_ovh"][b]),
        bound_ratio=float(cols["bound_ratio"][b]),
        memory_bound=bool(cols["memory_bound"][b]),
        total_bytes=float(cols["total_bytes"][b]),
        n_lsu=int(cols["n_lsu"][b]), backend=plan.backend)

    tables = plan.tables()
    def config_at(rows: np.ndarray) -> dict[str, np.ndarray]:
        out = {}
        for a in _sweep.AXES:
            if a in _sweep._CATEGORICAL:
                out[a] = _sweep._object_array(tables[a])[
                    np.asarray(cols[a], dtype=np.int64)[rows]]
            else:
                out[a] = np.asarray(cols[a])[rows]
        return out

    front_rows = (log.front(objectives) if pareto_mode
                  else np.asarray([b], dtype=np.int64))
    front_cols = config_at(front_rows)
    for name in OBJECTIVE_COLUMNS:
        front_cols[name] = np.asarray(cols[name])[front_rows]
    best_cfg = {a: v[0] for a, v in config_at(
        np.asarray([b], dtype=np.int64)).items()}

    return OptimizeReport(
        objectives=objectives, backend=plan.backend, n_total=n,
        n_evals=log.spent, n_grid_evals=log.grid_evals,
        n_relaxed_evals=log.relaxed_evals,
        n_screened=n_screened, best_id=best_id, best=best,
        best_config=best_cfg,
        front_ids=np.asarray(cols["id"])[front_rows].astype(np.int64),
        front=front_cols, trajectory=tuple(trajectory), constraints=cons)
