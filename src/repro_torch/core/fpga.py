"""Hardware parameter sets for the faithful FPGA/DRAM model (paper Table III).

The port's copy of ``repro.core.fpga``.  The paper evaluates on an Intel
Stratix 10 GX Development Kit with one DDR4 DIMM.  Table III gives the DRAM
datasheet values; the BSP/IP parameters (``burst_cnt``, ``max_th``) come
from the generated Verilog (param BURSTCOUNT_WIDTH / MAX_THREADS).  The
values themselves live in :mod:`repro_torch.hw.presets`.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DramParams:
    """DRAM datasheet values (paper Table II `Datasheet` rows + Table III)."""

    name: str
    f_mem: float        # memory frequency [Hz] (I/O bus clock)
    dq: int             # memory data width [bytes]
    bl: int             # memory burst length [beats]
    t_rcd: float        # row activation time [s]
    t_rp: float         # precharge (row miss) time [s]
    t_wr: float         # write recovery time [s]
    banks: int = 4      # paper SIV: "2GB DDR4 ... 4 memory banks"
    row_bytes: int = 8192  # DDR4 page size per bank

    @property
    def bw_mem(self) -> float:
        """Peak DRAM bandwidth [B/s]: dq * 2 * f_mem (Eq. 2, DDR double rate)."""
        return self.dq * 2.0 * self.f_mem

    @property
    def t_row(self) -> float:
        """Row-miss inter-command delay (Eq. 6): T_RCD + T_RP."""
        return self.t_rcd + self.t_rp

    @property
    def min_burst_bytes(self) -> int:
        """Minimum DRAM burst transaction size: dq * bl."""
        return self.dq * self.bl


@dataclasses.dataclass(frozen=True)
class BspParams:
    """BSP / generated-IP parameters (paper Table II `Verilog` rows)."""

    burst_cnt: int = 4   # BURSTCOUNT_WIDTH: log2(max #min-bursts per transaction)
    max_th: int = 128    # MAX_THREADS: max coalesced threads per request

    def max_transaction_bytes(self, dram: DramParams) -> int:
        """Eq. 5 upper bound: 2**burst_cnt * dq * bl."""
        return (1 << self.burst_cnt) * dram.min_burst_bytes
