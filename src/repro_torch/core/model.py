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
source of :attr:`Estimate.per_lsu`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.core import model_batch as _mb
from repro_torch.core.fpga import BspParams, DramParams
from repro_torch.core.lsu import Lsu


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


def _estimate(
    lsus: Sequence[Lsu],
    dram: DramParams,
    bsp: BspParams | None = None,
    *,
    f: int = 1,
) -> KernelEstimate:
    """Full model: Eq. 3 classification + Eq. 1 execution time."""
    if bsp is None:
        from repro_torch.hw import DEFAULT_BOARD, get as _get

        bsp = _get(DEFAULT_BOARD).bsp_params()
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
