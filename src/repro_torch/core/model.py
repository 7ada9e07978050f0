"""The paper's analytical model (Eqs. 1-10): the scalar reference.

Port of ``repro.core.model``.  Execution time of a memory-bound kernel is

    T_exe = sum_i  delta_i * (T_ideal_i + T_ovh_i)            (Eq. 1)

over all GMI LSUs ``i``, with ``T_ideal_i = ls_bytes_i * ls_acc_i / bw_mem``
(Eq. 2) and ``T_ovh_i`` the DRAM row-miss overhead of the LSU's type
(Eqs. 4-10); the design is memory bound when the LHS of Eq. 3,
``sum_i ls_width_i / (dq * bl * K_lsu_i)``, reaches 1.

:func:`_estimate` runs each LSU through the same
:func:`repro_torch.core.model_batch.group_timing` body as the batched path,
on plain Python scalars: the ``scalar`` backend of ``Session``, and the
source of :attr:`Estimate.per_lsu`.  :func:`lsu_timing` and its helpers
(``k_lsu``, ``burst_size_bytes``, ``t_row_seconds``) are the readable
per-LSU statement of the same equations, which the DRAM simulator and the
paper tables read; :func:`pipeline_time` is Fig. 3's compute bound.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core import model_batch as _mb
from repro_torch.core.fpga import BspParams, DramParams
from repro_torch.core.lsu import Lsu, LsuType


def _default_bsp() -> BspParams:
    """The registry default board's BSP view."""
    from repro_torch.hw import DEFAULT_BOARD, get as _get

    return _get(DEFAULT_BOARD).bsp_params()


@dataclasses.dataclass(frozen=True)
class LsuTiming:
    """Per-LSU breakdown of the estimate."""

    lsu: Lsu
    burst_size: float      # effective bytes per DRAM transaction
    n_bursts: float        # number of DRAM transactions issued
    t_ideal: float         # Eq. 2 [s]
    t_ovh: float           # Eq. 4 / 9 / 10 [s]

    @property
    def t_total(self) -> float:
        """Contribution to Eq. 1: delta * (T_ideal + T_ovh)."""
        return self.lsu.delta * (self.t_ideal + self.t_ovh)


@dataclasses.dataclass(frozen=True)
class KernelEstimate:
    """Model output for one kernel."""

    t_exe: float                     # Eq. 1 [s]
    memory_bound: bool               # Eq. 3
    bound_ratio: float               # LHS of Eq. 3
    per_lsu: tuple[LsuTiming, ...]

    @property
    def t_ideal(self) -> float:
        return sum(t.lsu.delta * t.t_ideal for t in self.per_lsu)

    @property
    def t_ovh(self) -> float:
        return sum(t.lsu.delta * t.t_ovh for t in self.per_lsu)

    @property
    def total_bytes(self) -> int:
        return sum(t.lsu.total_bytes for t in self.per_lsu)

    @property
    def effective_bandwidth(self) -> float:
        """Useful bytes / predicted time [B/s]."""
        return self.total_bytes / self.t_exe if self.t_exe > 0 else math.inf


def k_lsu(lsu: Lsu) -> float:
    """Eq. 3 coalescing-efficiency factor per LSU type."""
    if lsu.lsu_type in (LsuType.BC_ALIGNED, LsuType.BC_NON_ALIGNED, LsuType.BC_CACHE):
        return float(lsu.delta)
    # write-ACK (paper SIII-A3: "K_lsu equals 1") and atomic.
    return 1.0


def burst_size_bytes(lsu: Lsu, dram: DramParams, bsp: BspParams) -> float:
    """Effective DRAM transaction size for this LSU [bytes]."""
    max_txn = bsp.max_transaction_bytes(dram)  # Eq. 5: 2**burst_cnt * dq * bl
    if lsu.lsu_type in (LsuType.BC_ALIGNED, LsuType.BC_CACHE, LsuType.BC_WRITE_ACK):
        return float(max_txn)
    if lsu.lsu_type is LsuType.BC_NON_ALIGNED:
        # Eq. 7: the thread-count trigger caps the assembled request.
        max_reqs = bsp.max_th * lsu.ls_width / (lsu.delta + 1)
        # Eq. 8: whichever trigger fires first defines the effective burst.
        if max_reqs <= max_txn:
            return max_reqs / lsu.delta
        return lsu.ls_width / lsu.delta
    if lsu.lsu_type is LsuType.ATOMIC_PIPELINED:
        return float(dram.min_burst_bytes)  # no burst grouping at all
    raise ValueError(f"{lsu.lsu_type} does not issue DRAM bursts")


def t_row_seconds(lsu: Lsu, dram: DramParams) -> float:
    """Row-miss inter-command delay for this LSU type [s]."""
    if lsu.lsu_type in (LsuType.BC_ALIGNED, LsuType.BC_NON_ALIGNED, LsuType.BC_CACHE):
        return dram.t_row                                   # Eq. 6
    if lsu.lsu_type is LsuType.BC_WRITE_ACK:
        return dram.t_row + dram.t_wr                       # Eq. 9
    if lsu.lsu_type is LsuType.ATOMIC_PIPELINED:
        return 2.0 * dram.t_row + dram.t_wr                 # Eq. 10 (read+write)
    raise ValueError(f"{lsu.lsu_type} has no DRAM row timing")


def lsu_timing(
    lsu: Lsu,
    dram: DramParams,
    bsp: BspParams,
    *,
    n_lsu: int,
    f: int = 1,
) -> LsuTiming:
    """Timing terms for a single LSU (Eqs. 2, 4-10)."""
    t_ideal = lsu.total_bytes / dram.bw_mem                 # Eq. 2
    bsz = burst_size_bytes(lsu, dram, bsp)
    n_bursts = lsu.total_bytes / bsz
    t_row = t_row_seconds(lsu, dram)

    if lsu.lsu_type is LsuType.ATOMIC_PIPELINED:
        # Eq. 10: per-operation overhead, merged across f when val is constant.
        per_op = t_row / f if lsu.val_constant else t_row
        t_ovh = lsu.ls_acc * per_op
        return LsuTiming(lsu=lsu, burst_size=bsz, n_bursts=float(lsu.ls_acc),
                         t_ideal=t_ideal, t_ovh=t_ovh)

    # Burst-coalesced family, Eq. 4: a single stream never thrashes rows.
    if n_lsu < 2:
        t_ovh = 0.0
    else:
        t_ovh = n_bursts * t_row
    if lsu.lsu_type is LsuType.BC_WRITE_ACK:
        # Wasted-burst transfer inflation (SIII-A3): each dq*bl burst carries
        # only ls_bytes useful bytes.
        waste = dram.min_burst_bytes - lsu.ls_bytes
        if waste > 0:
            t_ovh += lsu.ls_acc * waste / dram.bw_mem
        if n_lsu < 2:
            # the ACK round-trip itself is never hidden
            t_ovh += n_bursts * t_row
    return LsuTiming(lsu=lsu, burst_size=bsz, n_bursts=n_bursts,
                     t_ideal=t_ideal, t_ovh=t_ovh)


def memory_bound_ratio(lsus: Sequence[Lsu], dram: DramParams) -> float:
    """LHS of Eq. 3."""
    return sum(lsu.ls_width / (dram.min_burst_bytes * k_lsu(lsu)) for lsu in lsus)


def _estimate(
    lsus: Sequence[Lsu],
    dram: DramParams,
    bsp: BspParams | None = None,
    *,
    f: int = 1,
) -> KernelEstimate:
    """Full model: Eq. 3 classification + Eq. 1 execution time."""
    bsp = bsp if bsp is not None else _default_bsp()
    glob = [l for l in lsus if l.lsu_type.is_global]
    if not glob:
        return KernelEstimate(t_exe=0.0, memory_bound=False, bound_ratio=0.0,
                              per_lsu=())
    t_exe = 0.0
    ratio = 0.0
    latency_bound = False
    timings = []
    for l in glob:
        g = _mb.group_timing(
            lsu_type=_mb.TYPE_CODE[l.lsu_type],
            ls_width=l.ls_width, ls_acc=l.ls_acc, ls_bytes=l.ls_bytes,
            delta=l.delta, val_constant=l.val_constant,
            n_lsu=len(glob), f=f,
            dq=dram.dq, bl=dram.bl, f_mem=dram.f_mem,
            t_rcd=dram.t_rcd, t_rp=dram.t_rp, t_wr=dram.t_wr,
            burst_cnt=bsp.burst_cnt, max_th=bsp.max_th,
            xp=_mb.SCALAR_XP,
        )
        timings.append(LsuTiming(lsu=l, burst_size=float(g["burst_size"]),
                                 n_bursts=float(g["n_bursts"]),
                                 t_ideal=float(g["t_ideal"]),
                                 t_ovh=float(g["t_ovh"])))
        t_exe += g["t_total"]                               # Eq. 1
        ratio += g["ratio_term"]                            # Eq. 3 LHS
        latency_bound = latency_bound or bool(g["latency_bound"])
    return KernelEstimate(
        t_exe=float(t_exe),
        memory_bound=ratio >= 1.0 or latency_bound,
        bound_ratio=float(ratio),
        per_lsu=tuple(timings),
    )


def pipeline_time(
    n_work_items: int,
    *,
    f: int = 1,
    f_kernel: float = 300e6,
    depth: int = 300,
    ii: int = 1,
) -> float:
    """Simple kernel-pipeline bound (outside the paper's scope; used only to
    reproduce Fig. 3's compute-bound points — the paper defers those to prior
    models [6,7]):  (n_wi/f * II + depth) / f_kernel.
    """
    return (n_work_items / f * ii + depth) / f_kernel
