"""Benchmark descriptors: the paper's SIV microbenchmarks (Listings 3-5) and
the Table IV applications' LSU structure.  Port of ``repro.core.apps``
(the descriptors behind ``Design.microbench`` and ``Design.from_app``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.lsu import Lsu, LsuType


def microbench(
    lsu_type: LsuType,
    *,
    n_ga: int,
    simd: int = 16,
    n_elems: int = 1 << 22,
    delta: int = 1,
    elem_bytes: int = 4,
    include_write: bool = True,
    span_bytes: int | None = None,
    val_constant: bool = False,
) -> list[Lsu]:
    """LSU list for the SIV sum-reduction microbenchmarks.

    ``z[id] = x1[id] + ... + xn[id]`` with ``n_ga`` read arrays; the write is
    of the same type as the reads (Listing 4 uses one body per modifier).
    Atomic microbenchmarks (Listing 5) have ``n_ga`` atomic updates.
    """
    lsus: list[Lsu] = []
    if lsu_type is LsuType.ATOMIC_PIPELINED:
        for g in range(n_ga):
            lsus.append(Lsu(LsuType.ATOMIC_PIPELINED, ls_width=elem_bytes,
                            ls_acc=n_elems, ls_bytes=elem_bytes, is_write=True,
                            val_constant=val_constant, name=f"atomic{g}"))
        return lsus

    if lsu_type is LsuType.BC_WRITE_ACK:
        # data-dependent store: the compiler replicates `simd` scalar LSUs for
        # the write; the reads stay burst-coalesced aligned.  The paper's
        # microbenchmark confines the random target to 2048 ints (= one 8 KB
        # DRAM row), which is the default footprint here.
        span_bytes = span_bytes or 2048 * elem_bytes
        for g in range(n_ga):
            lsus.append(Lsu(LsuType.BC_ALIGNED, ls_width=simd * elem_bytes,
                            ls_acc=n_elems // simd, ls_bytes=simd * elem_bytes,
                            name=f"x{g}"))
        if include_write:
            for k in range(simd):
                lsus.append(Lsu(LsuType.BC_WRITE_ACK, ls_width=elem_bytes,
                                ls_acc=n_elems // simd, ls_bytes=elem_bytes,
                                is_write=True, span_bytes=span_bytes,
                                name=f"z[{k}]"))
        return lsus

    for g in range(n_ga):
        lsus.append(Lsu(lsu_type, ls_width=simd * elem_bytes,
                        ls_acc=n_elems // simd, ls_bytes=simd * elem_bytes,
                        delta=delta, name=f"x{g}"))
    if include_write:
        lsus.append(Lsu(lsu_type, ls_width=simd * elem_bytes,
                        ls_acc=n_elems // simd, ls_bytes=simd * elem_bytes,
                        delta=delta, is_write=True, name="z"))
    return lsus


@dataclasses.dataclass(frozen=True)
class AppDescriptor:
    """One Table IV row: LSU structure + paper-reported times."""

    name: str
    source: str
    gmi: LsuType
    n_read: int
    n_write: int
    delta: int = 1
    simd: int = 16
    elem_bytes: int = 4
    measured_ms: float = 0.0     # Table IV "M.Time"
    paper_est_ms: float = 0.0    # Table IV "E.Time"
    paper_err_pct: float = 0.0   # Table IV "Error"
    calibrate_to: str | None = None  # calibrate scale on another app's row

    @property
    def n_lsu(self) -> int:
        return self.n_read + self.n_write

    def lsus(self, n_elems: int) -> list[Lsu]:
        out: list[Lsu] = []
        if self.gmi is LsuType.BC_WRITE_ACK:
            # Table IV reports total #lsu directly for ACK apps (NW: 4).
            per = max(1, n_elems)
            for k in range(self.n_read):
                out.append(Lsu(LsuType.BC_WRITE_ACK, ls_width=self.elem_bytes,
                               ls_acc=per, ls_bytes=self.elem_bytes,
                               name=f"{self.name}.r{k}"))
            for k in range(self.n_write):
                out.append(Lsu(LsuType.BC_WRITE_ACK, ls_width=self.elem_bytes,
                               ls_acc=per, ls_bytes=self.elem_bytes,
                               is_write=True, name=f"{self.name}.w{k}"))
            return out
        w = self.simd * self.elem_bytes
        acc = max(1, n_elems // self.simd)
        for k in range(self.n_read):
            out.append(Lsu(self.gmi, ls_width=w, ls_acc=acc, ls_bytes=w,
                           delta=self.delta, name=f"{self.name}.r{k}"))
        for k in range(self.n_write):
            out.append(Lsu(self.gmi, ls_width=w, ls_acc=acc, ls_bytes=w,
                           delta=self.delta, is_write=True,
                           name=f"{self.name}.w{k}"))
        return out


_T = LsuType
APPS: dict[str, AppDescriptor] = {
    a.name: a
    for a in [
        # name        source            gmi            r  w  delta
        AppDescriptor("dot", "FBLAS [16]", _T.BC_ALIGNED, 2, 1,
                      measured_ms=60.2, paper_est_ms=64.5, paper_err_pct=7.3),
        AppDescriptor("fft1d", "Intel SDK [10]", _T.BC_ALIGNED, 1, 1,
                      measured_ms=9.5, paper_est_ms=8.8, paper_err_pct=7.3),
        AppDescriptor("nn", "Rodinia [5]", _T.BC_ALIGNED, 1, 1,
                      measured_ms=157.5, paper_est_ms=172.1, paper_err_pct=9.2),
        AppDescriptor("rot", "FBLAS [16]", _T.BC_ALIGNED, 2, 2,
                      measured_ms=92.7, paper_est_ms=86.1, paper_err_pct=7.2),
        AppDescriptor("vectoradd", "Intel SDK [10]", _T.BC_ALIGNED, 2, 1,
                      measured_ms=33.3, paper_est_ms=33.2, paper_err_pct=5.1),
        AppDescriptor("vectoradd_d2", "Intel SDK [10]", _T.BC_ALIGNED, 2, 1,
                      delta=2, measured_ms=67.9, paper_est_ms=63.0,
                      paper_err_pct=6.5, calibrate_to="vectoradd"),
        AppDescriptor("hotspot", "Rodinia [5]", _T.BC_NON_ALIGNED, 2, 1,
                      measured_ms=9.7, paper_est_ms=8.8, paper_err_pct=8.7),
        AppDescriptor("pathfinder", "Rodinia [5]", _T.BC_NON_ALIGNED, 2, 1,
                      measured_ms=275.9, paper_est_ms=254.0, paper_err_pct=7.9),
        AppDescriptor("wm", "Vivado [17]", _T.BC_NON_ALIGNED, 1, 1,
                      measured_ms=59.8, paper_est_ms=55.8, paper_err_pct=6.6),
        AppDescriptor("nw", "Rodinia [5]", _T.BC_WRITE_ACK, 3, 1,
                      measured_ms=1.4, paper_est_ms=1.4, paper_err_pct=4.0),
    ]
}
