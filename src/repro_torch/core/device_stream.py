"""Device-resident streaming sweep: enumerate, score and fold on the device.

Port of ``repro.core.device_stream``.  The host streaming loop
(:func:`repro_torch.core.stream.run_stream`) decodes every chunk on the
host, copies the axis columns to the device, scores them, copies every
estimate column back and folds the reducers in NumPy.  Here the whole
chunk step stays on the session's device, and only one reducer state
crosses back, at the end of a range:

* **Enumeration on the device** — the mixed-radix id decode
  ``(ids // stride) % mod`` runs from a chunk-start scalar against axis
  value tables that live on the device for the whole sweep; the padded
  tail is :func:`stream._chunk_ids`'s: ``ids = min(start + iota, n - 1)``.
* **Scoring on the device** — the two-group expansion of
  :func:`repro_torch.core.sweep._score` in tensor ops, through
  :func:`repro_torch.core.model_batch.estimate_columns` with
  ``paired_kernel=True``, so every column is bit-equal to the host
  evaluator's for the same ids.
* **Reducer folds on the device** — fixed-shape carries for
  :class:`stream.StatsReducer` (Shewchuk partials and Chan moments,
  operation for operation), :class:`stream.TopKReducer` and the
  2-objective :class:`stream.ParetoReducer`.  Chunk sums follow
  :func:`stream._tree_sum`'s pairing in explicit pairwise adds, which makes
  the zero-masked fixed-shape fold bit-equal to the host fold under any
  chunk partition.  Selection keys are order-isomorphic int64s
  (:func:`_f64_key` for floats); candidate lanes are compacted by prefix
  sums, never by a sort of the chunk, and merged with the carry by stable
  sorts of a few thousand keys.

The chunk step is a few hundred small tensor operations and holds no host
sync: nothing is read back per chunk (no ``.item()``).  On a CUDA device,
for ranges long enough to repay the capture, it is captured once as a
CUDA graph and replayed per chunk, the chunk start, valid length and
points folded refilled as 0-dim tensors; otherwise it runs op by op with
those quantities as Python numbers.  Both issue
the same operations on the same data.  The whole chunk is scored once,
with every column, and the candidate lanes of the selection folds are
gathered from it.

Fixed-shape carries have two capacity limits the host fold lacks: the
Pareto front cap (:data:`FRONT_CAP`) and the exact-sum partial count
(:data:`N_PARTIALS`).  Both set overflow flags on the device, read once at
the end before any reducer is touched; an overflow raises
:class:`DeviceFoldOverflow` and the caller refolds the range on the host
path — never a truncated result.  Any other failure raises.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import compat
from repro_torch.core import model_batch as _mb
from repro_torch.core import stream as _stream
from repro_torch.core import sweep as _sweep

#: Pareto front capacity of the fixed-shape device carry.  A front larger
#: than this overflows to the host path (flagged, never truncated).
FRONT_CAP = 4096

#: Shewchuk partial slots of the on-device exact sum.  Real sweeps use 2-4;
#: adversarial magnitude spreads overflow to the host path.
N_PARTIALS = 16

_NUM_AXES = tuple(a for a in _sweep.AXES if a not in _sweep._CATEGORICAL)
_DRAM_FIELDS = ("dq", "bl", "f_mem", "t_rcd", "t_rp", "t_wr")
_BSP_FIELDS = ("burst_cnt", "max_th")

COLUMNS = _stream.COLUMNS
_COL_DTYPES = _stream.COL_DTYPES

#: Carried columns, split by storage: integer and bool columns ride in one
#: int64 matrix, float columns in one float64 matrix, so a carry gathers
#: and concatenates two tensors instead of one per column.
_INT_COLS = tuple(c for c in COLUMNS if _COL_DTYPES[c] is not np.float64)
_F64_COLS = tuple(c for c in COLUMNS if _COL_DTYPES[c] is np.float64)

_SENT_ID = 1 << 62                    # sorts after every real point id
_I64MAX = (1 << 63) - 1

#: ``_f64_key(+inf)`` — the masked-lane / empty-slot sentinel for
#: float-keyed selection, so dead lanes behave like the host's ``+inf``.
_INFKEY = 0x7FF0000000000000


class DeviceFoldOverflow(RuntimeError):
    """A fixed-shape device carry ran out of capacity; refold on the host."""


# ---------------------------------------------------------------------------
# elementwise building blocks
# ---------------------------------------------------------------------------

def _tree_sum_rows(x: torch.Tensor) -> torch.Tensor:
    """:func:`stream._tree_sum` of each row of ``x`` [R, m]: zero-pad to a
    power of two, then fold ``x[0::2] + x[1::2]`` in separate adds, so the
    pairing is a function of position alone on every device."""
    m = x.shape[-1]
    size = 1 << (m - 1).bit_length()
    if size != m:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (size - m,))], dim=-1)
    while size > 1:
        x = x[..., 0::2] + x[..., 1::2]
        size //= 2
    return x[..., 0]


def _exact_add(parts: torch.Tensor, cnt: torch.Tensor, x: torch.Tensor,
               max_cnt: int):
    """:meth:`stream._ExactSum.add` on each row: ``parts`` [R, P] holds
    ``cnt`` [R] non-overlapping partials in slots ``[0, cnt)`` and zeros
    after them; add ``x`` [R] by the grow-expansion, reading the original
    slots, then compact the surviving ``lo`` terms left and append ``hi``.
    A zero slot is a no-op of the two-sum (``hi == x``, ``lo == 0``, not
    kept), so the slots past ``cnt`` need no mask, and ``max_cnt`` — a
    host bound on ``cnt``, one slot at most per earlier add — stops the
    walk early.  Returns ``(parts, cnt, overflowed)``.  Two-sum runs as
    separate elementwise ops: no fused multiply-add can enter."""
    n_rows, n_slots = parts.shape
    walk = min(n_slots, max_cnt)
    ay = parts.abs()
    los = []
    for j in range(walk):
        y = parts[:, j]
        swap = x.abs() < ay[:, j]
        big = torch.where(swap, y, x)
        small = torch.where(swap, x, y)
        x = big + small                      # hi
        los.append(small - (x - big))        # lo
    out = torch.zeros((n_rows, n_slots + 1), dtype=parts.dtype,
                      device=parts.device)
    if los:
        lo = torch.stack(los, 1)
        keep = lo != 0.0
        pos = torch.cumsum(keep, 1) - 1
        out.scatter_(1, torch.where(keep, pos, n_slots), lo)
        i = keep.sum(1)
    else:
        i = torch.zeros_like(cnt)
    out.scatter_(1, torch.clamp(i, max=n_slots)[:, None], x[:, None])
    return out[:, :n_slots], torch.clamp(i + 1, max=n_slots), i >= n_slots


def _f64_key(x: torch.Tensor) -> torch.Tensor:
    """Order-isomorphic int64 key of a float64 tensor.

    ``x + 0.0`` folds ``-0.0`` into ``+0.0`` (bit-distinct, numerically
    equal), then the sign-aware flip makes the IEEE-754 pattern ordered as
    a signed int64: ``key(a) < key(b)`` iff ``a < b`` and equal keys iff
    equal values, for every non-NaN pair.
    """
    b = (x + 0.0).view(torch.int64)
    return b ^ ((b >> 63) & 0x7FFFFFFFFFFFFFFF)


def _col_key(v: torch.Tensor, mask: torch.Tensor, name: str):
    """``(monotonic int64 key, sentinel)`` of one column, masked lanes set
    to the sentinel: floats through :func:`_f64_key` (sentinel the +inf
    key), integers and bools exact as int64 (sentinel int64 max)."""
    if _COL_DTYPES[name] is np.float64:
        key, sent = _f64_key(v.to(torch.float64)), _INFKEY
    else:
        key, sent = v.to(torch.int64), _I64MAX
    return torch.where(mask, key, sent), sent


def _place(pos: torch.Tensor, width: int, fill: int) -> torch.Tensor:
    """Lane indices placed at their positions ``pos`` (one scatter; lanes
    at ``width`` or beyond are dropped), empty slots at ``fill``."""
    out = torch.full((width + 1,), fill, dtype=torch.int64, device=pos.device)
    out.scatter_(0, torch.clamp(pos, max=width),
                 torch.arange(pos.shape[0], device=pos.device))
    return out[:width]


def _compact(keep: torch.Tensor, width: int, fill: int) -> torch.Tensor:
    """The positions of the first ``width`` set lanes of ``keep``, in
    ascending order, padded with ``fill``: a prefix sum and one scatter,
    the same lanes a sort of ``where(keep, iota, big)`` would put first."""
    return _place(torch.where(keep, torch.cumsum(keep, 0) - 1, width),
                  width, fill)


def _lexsort2(major: torch.Tensor, minor: torch.Tensor) -> torch.Tensor:
    """Permutation sorting by (``major``, ``minor``), ties by position:
    two stable sorts, the least significant key first."""
    o = torch.sort(minor, stable=True).indices
    return o[torch.sort(major[o], stable=True).indices]


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------

def _score_ids(tb: dict, ids: torch.Tensor) -> tuple[dict, torch.Tensor,
                                                      torch.Tensor]:
    """The device twin of ``plan.evaluator()``'s ``score_ids``.

    Gathers axis values from the device tables for an id vector, resolves
    the hardware axis as :func:`sweep._resolve_hardware_codes` does, and
    scores through :func:`sweep._group_columns` and
    :func:`model_batch.estimate_columns` with ``paired_kernel``, so every
    column is bit-equal to the host evaluator's for the same ids.
    Returns ``(columns by name, int64 matrix of _INT_COLS, float64 matrix
    of _F64_COLS)``; the named columns are views of the matrices.
    """
    m = ids.shape[0]
    code = {name: (ids // s) % d
            for name, s, d in zip(_sweep.AXES, tb["strides"], tb["mods"])}
    num = {k: tb["num_" + k][code[k]] for k in _NUM_AXES}

    type_codes = tb["lsu_code"][code["lsu_type"]]
    own = tb["hw_own"][code["hardware"]]
    hw_scale = torch.where(own, 1.0, tb["hw_hf"][code["hardware"]])
    d_code = torch.where(own, code["dram"], tb["len_d"] + code["hardware"])
    b_code = torch.where(own, code["bsp"], tb["len_b"] + code["hardware"])

    hw = {**{k: tb["dram_" + k][d_code] for k in _DRAM_FIELDS},
          **{k: tb["bsp_" + k][b_code] for k in _BSP_FIELDS}}
    cols, norm = _sweep._group_columns(type_codes, num, hw)
    est, _ = _mb.estimate_columns(cols, m, paired_kernel=True)

    # hardware host_factor, then session calibration: the host's two
    # multiplies in its order (a 1.0 factor is an exact identity, so
    # applying both everywhere matches the host's conditional skips).
    cal = torch.where(own, tb["calib"], 1.0)
    w = cols["count"] * cols["ls_width"]
    floats = {name: (est[name] * hw_scale) * cal
              if name in ("t_exe", "t_ideal", "t_ovh") else est[name]
              for name in ("t_exe", "t_ideal", "t_ovh", "bound_ratio",
                           "total_bytes", "n_lsu")}
    # np.bincount folds (0 + w1) + w2 per point; 0 + w1 == w1 exactly.
    floats["resource"] = w[:m] + w[m:]
    ints = {
        "id": ids, "lsu_type": code["lsu_type"],
        **{k: num[k] for k in ("n_ga", "simd", "n_elems", "elem_bytes")},
        **norm, "dram": d_code, "bsp": b_code,
        "hardware": code["hardware"], "memory_bound": est["memory_bound"],
    }
    ci = torch.stack([ints[c].to(torch.int64) for c in _INT_COLS])
    cf = torch.stack([floats[c] for c in _F64_COLS])
    named = {c: ci[i] for i, c in enumerate(_INT_COLS)}
    named.update({c: cf[i] for i, c in enumerate(_F64_COLS)})
    return named, ci, cf


# ---------------------------------------------------------------------------
# the folds
# ---------------------------------------------------------------------------

def _fold_stats(st: dict, cols: dict, mask: torch.Tensor, valid, n_before,
                walk: int) -> dict:
    """The device twin of :meth:`stream.StatsReducer.update` for one chunk.
    ``valid`` and the points folded before it (``n_before``) are Python
    numbers, or 0-dim tensors in a captured graph: either way the moments
    take the host's float64 divisions.  ``walk`` bounds the partial slots
    the exact sums visit (:func:`_exact_add`)."""
    t = cols["t_exe"]
    sums = _tree_sum_rows(torch.stack([
        torch.where(mask, t, 0.0), torch.where(mask, cols["total_bytes"],
                                               0.0)]))
    s = sums[0]
    mb = torch.where(mask, cols["memory_bound"], 0).sum()
    parts, cnt, ovf = _exact_add(st["parts"], st["cnt"], sums, walk)

    cmean = s / valid
    d_t = t - cmean
    cm2 = _tree_sum_rows(torch.where(mask, d_t * d_t, 0.0)[None, :])[0]
    # stream._chan_merge(n_before, mean, m2, valid, cmean, cm2), same order
    n_new = n_before + valid
    d = cmean - st["mean"]
    mean = st["mean"] + d * (valid / n_new)
    m2 = st["m2"] + cm2 + d * d * (n_before / n_new * valid)

    vals = torch.where(mask, t, float("inf"))
    # first occurrence, like numpy; a 1-element index, since indexing by
    # a 0-dim tensor reads it back to the host
    i = torch.argmin(vals).reshape(1)
    v, pid = vals[i][0], cols["id"][i][0]
    better = (v < st["vmin"]) | ((v == st["vmin"]) & (pid < st["vid"]))
    return {
        "mb": st["mb"] + mb,
        "vmin": torch.where(better, v, st["vmin"]),
        "vid": torch.where(better, pid, st["vid"]),
        "parts": parts, "cnt": cnt, "mean": mean, "m2": m2,
        "ovf": st["ovf"] | ovf.any(),
    }


def _topk_candidates(cols: dict, mask: torch.Tensor, k: int, key: str):
    """Lanes of the chunk that can enter the top-``k`` by (``key``, id):
    every lane strictly below the k-th smallest key (at most k - 1 of
    them) ahead of the lanes tied with it, each group in ascending lane
    (= id) order, cut at 2k — which always holds the exact top-k, however
    many ties.  Returns ``(lanes, candidate keys, candidate ids)`` with
    dead slots at the sentinels."""
    kkey, sent = _col_key(cols[key], mask, key)
    chunk = kkey.shape[0]
    if k >= chunk:
        lanes = torch.arange(chunk, device=kkey.device)
        real = mask
    else:
        thr = torch.kthvalue(kkey, k).values
        below, tied = kkey < thr, kkey == thr
        b = 2 * k
        ent = _place(torch.where(
            below, torch.cumsum(below, 0) - 1,
            torch.where(tied, below.sum() + torch.cumsum(tied, 0) - 1, b)),
            b, chunk)
        lanes = torch.clamp(ent, max=chunk - 1)
        real = (ent < chunk) & mask[lanes]
    return (lanes, torch.where(real, kkey[lanes], sent),
            torch.where(real, cols["id"][lanes], _SENT_ID))


def _fold_topk(st: dict, cols: dict, ci, cf, mask, k: int,
               key: str) -> dict:
    """The device twin of :meth:`stream.TopKReducer.update`: the chunk's
    candidates merged with the carry by an exact (key, id) sort."""
    lanes, ckk, cid = _topk_candidates(cols, mask, k, key)
    mk = torch.cat([st["sortkey"], ckk])
    mi = torch.cat([st["sortid"], cid])
    perm = _lexsort2(mk, mi)[:k]
    return {"ci": torch.cat([st["ci"], ci[:, lanes]], 1)[:, perm],
            "cf": torch.cat([st["cf"], cf[:, lanes]], 1)[:, perm],
            "sortkey": mk[perm], "sortid": mi[perm]}


def _fold_pareto(st: dict, cols: dict, ci, cf, mask, cap: int,
                 objectives, chunk: int) -> dict:
    """The device twin of :meth:`stream.ParetoReducer.update` (2
    objectives).

    An exact in-chunk dominance prefilter first: rank the first key by a
    sort and ``searchsorted``, scatter-min the second key per rank group,
    prefix-min across groups, and drop every lane those minima dominate.
    That is :func:`sweep._pareto_2d`'s predicate restricted to the chunk,
    and a lane dominated inside the chunk is dominated in the union, so no
    dropped lane can reach the front; every dropped lane's dominator chain
    ends in a kept one, so the merge flags exactly the rows the host fold
    flags.  The kept lanes (ascending id) are merged with the carry by
    ``_pareto_2d`` in key space over cap + S lanes, carry first, which
    keeps the host's ascending-id order.  More than S kept lanes or more
    than ``cap`` survivors set the overflow flag.
    """
    o0, o1 = objectives
    k0, sent0 = _col_key(cols[o0], mask, o0)
    k1, sent1 = _col_key(cols[o1], mask, o1)
    dev = k0.device

    s0 = torch.sort(k0).values
    g = torch.searchsorted(s0, k0)
    gm = torch.full((chunk,), _I64MAX, dtype=torch.int64, device=dev
                    ).scatter_reduce(0, g, k1, "amin")
    cm = torch.cummin(gm, 0).values
    m_strict = torch.where(g > 0, cm[torch.clamp(g - 1, min=0)], sent1)
    keep = mask & ~((m_strict <= k1) | (gm[g] < k1))
    s_count = keep.sum()

    s_cap = min(cap, chunk)
    ent = _compact(keep, s_cap, chunk)
    lanes = torch.clamp(ent, max=chunk - 1)
    cand = ent < chunk
    v0 = torch.cat([st["v0k"], torch.where(cand, k0[lanes], sent0)])
    v1 = torch.cat([st["v1k"], torch.where(cand, k1[lanes], sent1)])

    m = cap + s_cap
    midx = torch.arange(m, device=dev)
    sidx = _lexsort2(v0, v1)
    sm0, sm1 = v0[sidx], v1[sidx]
    new_group = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           sm0[1:] != sm0[:-1]])
    group_start = torch.cummax(torch.where(new_group, midx, 0), 0).values
    gmin = sm1[group_start]
    cmm = torch.cummin(sm1, 0).values
    prev_end = group_start - 1
    m_str = torch.where(prev_end >= 0, cmm[torch.clamp(prev_end, min=0)],
                        sent1)
    survives = ~((m_str <= sm1) | (gmin < sm1))
    count = survives.sum()
    # survivors in ascending merged position (carry first, then lanes)
    in_place = torch.zeros(m, dtype=torch.bool, device=dev
                           ).scatter_(0, sidx, survives)
    perm = _compact(in_place, cap, m - 1)
    live = torch.arange(cap, device=dev) < torch.clamp(count, max=cap)
    return {
        "ci": torch.cat([st["ci"], ci[:, lanes]], 1)[:, perm],
        "cf": torch.cat([st["cf"], cf[:, lanes]], 1)[:, perm],
        "v0k": torch.where(live, v0[perm], sent0),
        "v1k": torch.where(live, v1[perm], sent1),
        "count": torch.clamp(count, max=cap),
        "ovf": st["ovf"] | (count > cap) | (s_count > s_cap),
    }


# ---------------------------------------------------------------------------
# DeviceSweep: the host-side driver
# ---------------------------------------------------------------------------

class DeviceSweep:
    """One plan's device-resident fold driver (build via :meth:`build`)."""

    #: On a CUDA device, replay the chunk step as one captured CUDA graph
    #: (:meth:`_run_graph`) for ranges of at least ``graph_min_chunks``
    #: chunks; shorter ranges, ``use_graph`` off, or the CPU issue it op by
    #: op.  On the H100 a capture took as long as 6-15 op-by-op chunk
    #: steps and a replay a third to two thirds of one (PERF.md §6, the
    #: stream table); 16 lies between the measured 8-chunk grid (op by op
    #: faster) and the 79-chunk grid (graph faster).
    use_graph = True
    graph_min_chunks = 16

    def __init__(self, plan: "_stream.SweepPlan", tables: dict, device):
        self.plan = plan
        self.device = device
        self.n = plan.enumerator().n
        self.chunk = plan.chunk_size
        self.front_cap = FRONT_CAP
        self._tables_host = tables
        self._tables_dev = None

    # -- eligibility --------------------------------------------------------

    @classmethod
    def build(cls, plan: "_stream.SweepPlan") -> "DeviceSweep | None":
        """A driver for ``plan`` on its device, or ``None`` when the host
        path must run: a backend other than ``torch``, a constrained plan,
        an empty grid, numeric axis values outside the integer/bool domain
        the device tables mirror exactly, or axis values the host
        evaluator itself would reject."""
        if plan.backend != "torch" or plan.constraints:
            return None
        lists = {k: list(v) for k, v in plan.lists.items()}
        enum = _stream.GridEnumerator(lists)
        if enum.n == 0:
            return None
        tables: dict = {
            "strides": [int(s) for s in enum.strides],
            "mods": [int(m) for m in enum._mod],
            "calib": np.asarray(float(plan.calibration_factor)),
        }
        for k in _NUM_AXES:
            arr = np.asarray(lists[k])
            if arr.dtype == object or not (
                    np.issubdtype(arr.dtype, np.integer)
                    or np.issubdtype(arr.dtype, np.bool_)):
                return None
            # integer axes as float64 (exact), the arithmetic's own dtype
            want = np.bool_ if k in ("include_write",
                                     "val_constant") else np.float64
            tables["num_" + k] = arr.astype(want)
        if (tables["num_n_ga"].min() < 1 or tables["num_simd"].min() < 1
                or tables["num_delta"].min() < 1):
            return None
        if np.any(tables["num_n_elems"][:, None]
                  % tables["num_simd"][None, :]):
            return None
        try:
            tables["lsu_code"] = np.asarray(
                [_mb.TYPE_CODE[t] for t in lists["lsu_type"]], dtype=np.int64)
            drams_v, bsps_v, hf, is_none = _sweep._hardware_views(
                lists["hardware"])
            # sweep._resolve_hardware_codes extends the dram/bsp tables
            # with the per-hardware views only when some spec is set
            all_own = bool(is_none.all())
            d_table = lists["dram"] + ([] if all_own else drams_v)
            b_table = lists["bsp"] + ([] if all_own else bsps_v)
            for k in _DRAM_FIELDS:
                tables["dram_" + k] = np.asarray(
                    [getattr(d, k) if d is not None else 0
                     for d in d_table], dtype=np.float64)
            for k in _BSP_FIELDS:
                tables["bsp_" + k] = np.asarray(
                    [getattr(b, k) if b is not None else 0
                     for b in b_table],
                    dtype=np.int64 if k == "burst_cnt" else np.float64)
        except (AttributeError, TypeError, KeyError):
            return None
        tables["hw_own"] = np.asarray(is_none, dtype=bool)
        tables["hw_hf"] = np.asarray(hf, dtype=np.float64)
        tables["len_d"] = len(lists["dram"])
        tables["len_b"] = len(lists["bsp"])
        return cls(plan, tables, compat.resolve_device(plan.device))

    def supports(self, reducers) -> bool:
        return self._sig(reducers) is not None

    def _sig(self, reducers) -> tuple | None:
        sig = []
        for r in reducers:
            if type(r) is _stream.StatsReducer:
                sig.append(("stats",))
            elif type(r) is _stream.TopKReducer and r.key in COLUMNS:
                sig.append(("topk", r.k, r.key))
            elif (type(r) is _stream.ParetoReducer
                    and len(r.objectives) == 2
                    and all(o in COLUMNS for o in r.objectives)):
                sig.append(("pareto", self.front_cap, tuple(r.objectives)))
            else:
                return None
        return tuple(sig)

    # -- carries ------------------------------------------------------------

    def _tables(self) -> dict:
        if self._tables_dev is None:
            self._tables_dev = {
                k: (torch.as_tensor(v, device=self.device)
                    if isinstance(v, np.ndarray) else v)
                for k, v in self._tables_host.items()}
        return self._tables_dev

    def _init_carry(self, sig: tuple) -> list[dict]:
        dev = self.device
        i64 = dict(dtype=torch.int64, device=dev)
        f64 = dict(dtype=torch.float64, device=dev)
        carry = []
        for spec in sig:
            if spec[0] == "stats":
                carry.append({
                    "mb": torch.zeros((), **i64),
                    "vmin": torch.full((), float("inf"), **f64),
                    "vid": torch.full((), -1, **i64),
                    "parts": torch.zeros((2, N_PARTIALS), **f64),
                    "cnt": torch.zeros(2, **i64),
                    "mean": torch.zeros((), **f64),
                    "m2": torch.zeros((), **f64),
                    "ovf": torch.zeros((), dtype=torch.bool, device=dev),
                })
                continue
            width = spec[1]
            cols = {"ci": torch.zeros((len(_INT_COLS), width), **i64),
                    "cf": torch.zeros((len(_F64_COLS), width), **f64)}
            if spec[0] == "topk":
                sent = (_INFKEY if _COL_DTYPES[spec[2]] is np.float64
                        else _I64MAX)
                carry.append({**cols,
                              "sortkey": torch.full((width,), sent, **i64),
                              "sortid": torch.full((width,), _SENT_ID, **i64)})
            else:
                s0, s1 = (_INFKEY if _COL_DTYPES[o] is np.float64
                          else _I64MAX for o in spec[2])
                carry.append({**cols,
                              "v0k": torch.full((width,), s0, **i64),
                              "v1k": torch.full((width,), s1, **i64),
                              "count": torch.zeros((), **i64),
                              "ovf": torch.zeros((), dtype=torch.bool,
                                                 device=dev)})
        return carry

    def _step(self, carry: list[dict], sig: tuple, start, valid, n_before,
              walk: int) -> list[dict]:
        """One chunk: decode, score, fold every reducer.  ``start``,
        ``valid`` and ``n_before`` are Python numbers, or 0-dim tensors
        that a captured graph reads at replay."""
        chunk = self.chunk
        tb = self._tables()
        iota = torch.arange(chunk, device=self.device)
        ids = torch.clamp(iota + start, max=self.n - 1)
        mask = iota < valid
        cols, ci, cf = _score_ids(tb, ids)
        out = []
        for spec, st in zip(sig, carry):
            if spec[0] == "stats":
                out.append(_fold_stats(st, cols, mask, valid, n_before,
                                       walk))
            elif spec[0] == "topk":
                out.append(_fold_topk(st, cols, ci, cf, mask, spec[1],
                                      spec[2]))
            else:
                out.append(_fold_pareto(st, cols, ci, cf, mask, spec[1],
                                        spec[2], chunk))
        return out

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _timed(self, profile: dict | None, stage: str, t0: float) -> None:
        if profile is not None:
            self._sync()
            profile[stage] = (profile.get(stage, 0.0)
                              + time.perf_counter() - t0)

    def _run_eager(self, carry, sig, lo, hi, profile) -> list[dict]:
        """Issue every chunk step op by op; the walk of the exact sums
        grows one slot per chunk."""
        for c, start in enumerate(range(lo, hi, self.chunk)):
            t0 = time.perf_counter()
            carry = self._step(carry, sig, start,
                               min(self.chunk, self.n - start), start - lo,
                               walk=c)
            self._timed(profile, "compile_s" if c == 0 else "score_s", t0)
        return carry

    def _run_graph(self, carry, sig, lo, hi, profile) -> list[dict]:
        """Capture one chunk step as a CUDA graph, then replay it per
        chunk: the same kernels on the same data as the eager loop, one
        host call per chunk instead of one per operation.  The carry
        tensors are the graph's static state, updated in place; the chunk
        scalars are 0-dim tensors refilled before each replay; the exact
        sums walk every partial slot (a zero slot is a no-op)."""
        dev = self.device
        sc = {"start": torch.zeros((), dtype=torch.int64, device=dev),
              "valid": torch.zeros((), dtype=torch.int64, device=dev),
              "n_before": torch.zeros((), dtype=torch.float64, device=dev)}

        def load(start: int) -> None:
            sc["start"].fill_(start)
            sc["valid"].fill_(min(self.chunk, self.n - start))
            sc["n_before"].fill_(float(start - lo))

        def step() -> list[dict]:
            return self._step(carry, sig, sc["start"], sc["valid"],
                              sc["n_before"], walk=N_PARTIALS)

        t0 = time.perf_counter()
        load(lo)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step()                                  # warm-up, discarded
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            new = step()
            for st, nw in zip(carry, new):
                for k, v in nw.items():
                    st[k].copy_(v)
        self._timed(profile, "compile_s", t0)
        for start in range(lo, hi, self.chunk):
            t0 = time.perf_counter()
            load(start)
            graph.replay()
            self._timed(profile, "score_s", t0)
        return carry

    # -- the fold -----------------------------------------------------------

    def fold_range(self, lo: int, hi: int, reducers,
                   profile: dict | None = None) -> None:
        """Fold chunk-aligned ``[lo, hi)`` into ``reducers`` on the device.

        Same alignment contract as :meth:`SweepPlan.run_range`.  The loop
        issues every chunk step without a host sync; the reducer state is
        pulled to the host once.  Overflow flags are checked *before* any
        reducer is touched, so on :class:`DeviceFoldOverflow` the reducers
        are untouched and the caller refolds the same range on the host.

        With ``profile``, each step is synchronized for honest attribution
        (``compile_s`` the CUDA graph's warm-up and capture, or the first
        eager step; ``score_s`` the chunk steps after it; ``transfer_s``
        the table upload and the final state pull), which serializes the
        host and the device on purpose.
        """
        n, chunk = self.n, self.chunk
        lo, hi = int(lo), min(int(hi), n)
        if lo % chunk:
            raise ValueError(f"range start {lo} is not chunk-aligned "
                             f"(chunk_size={chunk})")
        if hi % chunk and hi != n:
            raise ValueError(f"range stop {hi} is not chunk-aligned "
                             f"(chunk_size={chunk}) and is not the grid "
                             f"end {n}")
        if hi <= lo:
            return
        reducers = tuple(reducers)
        sig = self._sig(reducers)
        if sig is None:
            raise ValueError("unsupported reducer set for the device fold; "
                             "check supports() first")

        with torch.no_grad():
            t0 = time.perf_counter()
            self._tables()
            carry = self._init_carry(sig)
            self._timed(profile, "transfer_s", t0)
            graph = (self.device.type == "cuda" and self.use_graph
                     and -(-(hi - lo) // chunk) >= self.graph_min_chunks)
            run = self._run_graph if graph else self._run_eager
            carry = run(carry, sig, lo, hi, profile)
            t0 = time.perf_counter()
            state = [{k: v.cpu().numpy() for k, v in st.items()}
                     for st in carry]
            if profile is not None:
                profile["transfer_s"] += time.perf_counter() - t0
                profile.setdefault("enumerate_s", 0.0)   # fused on device
                profile.setdefault("reduce_s", 0.0)      # fused on device

        # Validate every capacity flag before touching any reducer — a
        # partial merge would double-count when the host refolds the range.
        for spec, st in zip(sig, state):
            if spec[0] == "stats" and bool(st["ovf"]):
                raise DeviceFoldOverflow(
                    f"exact-sum partial count exceeded {N_PARTIALS}")
            if spec[0] == "pareto" and bool(st["ovf"]):
                raise DeviceFoldOverflow(
                    f"pareto front exceeded the device cap {spec[1]}")

        points = hi - lo
        for r, spec, st in zip(reducers, sig, state):
            if spec[0] == "stats":
                te_cnt, tb_cnt = (int(c) for c in st["cnt"])
                r.merge(_stream.StatsReducer.from_state({
                    "n_points": points,
                    "memory_bound": int(st["mb"]),
                    "t_exe_min": float(st["vmin"]),
                    "t_exe_min_id": int(st["vid"]),
                    "t_exe_sum": [float(p) for p in st["parts"][0, :te_cnt]],
                    "total_bytes_sum":
                        [float(p) for p in st["parts"][1, :tb_cnt]],
                    "mean": float(st["mean"]),
                    "m2": float(st["m2"]),
                }))
                continue
            held = (min(points, spec[1]) if spec[0] == "topk"
                    else int(st["count"]))
            rows = {c: st["ci"][i, :held].astype(_COL_DTYPES[c])
                    for i, c in enumerate(_INT_COLS)}
            rows.update({c: st["cf"][i, :held]
                         for i, c in enumerate(_F64_COLS)})
            rows = {c: rows[c] for c in COLUMNS}
            tmp = (_stream.TopKReducer(spec[1], spec[2]) if spec[0] == "topk"
                   else _stream.ParetoReducer(spec[2]))
            tmp.cols = rows
            r.merge(tmp)


def try_outcome(plan: "_stream.SweepPlan", reducers,
                profile: dict | None = None) -> "_stream.StreamOutcome | None":
    """Fold the whole grid on the device, or ``None`` for the host path
    (an ineligible plan or reducer set, or a capacity overflow — the
    reducers are only touched on success)."""
    dev = DeviceSweep.build(plan)
    if dev is None:
        return None
    reducers = tuple(reducers)
    if not dev.supports(reducers):
        return None
    try:
        dev.fold_range(0, dev.n, reducers, profile=profile)
    except DeviceFoldOverflow:
        if profile is not None:
            profile["device_overflow"] = True
        return None
    return _stream.StreamOutcome(
        reducers=reducers, n_points=dev.n,
        n_chunks=-(-dev.n // plan.chunk_size), chunk_size=plan.chunk_size)
