"""Built-in ``Hardware`` presets: the same four specs as the reference.

* ``stratix10_ddr4_1866`` / ``stratix10_ddr4_2666`` — the paper's Intel
  Stratix 10 GX devkit with one DDR4 DIMM (Table III datasheet rows + the
  BSP Verilog parameters; see :mod:`repro_torch.core.fpga`).
* ``tpu_v5e`` / ``tpu_v4`` — the TPU transplant targets.  The DRAM
  organization expresses the HBM transaction model in bank/burst terms
  (``dq * bl`` = the 512 B transaction granularity, ``t_rcd + t_rp`` = the
  28 ns row-miss class), so the same Eqs. 1-10 machinery scores them.
"""
from __future__ import annotations

from repro_torch.hw.registry import register
from repro_torch.hw.spec import (ClockDomain, DramOrganization, Hardware,
                                 MemorySystem)
from repro_torch.search.envelope import ResourceEnvelope

#: Registry names the library itself relies on for defaults.
DEFAULT_BOARD = "stratix10_ddr4_1866"
DEFAULT_CHIP = "tpu_v5e"

# -- the paper's FPGA board (Stratix 10 GX devkit, one DDR4 DIMM) -----------

_S10_CLOCK = ClockDomain(
    burst_cnt=4,            # BURSTCOUNT_WIDTH: max txn = 2**4 * dq * bl = 1 KiB
    max_th=128,             # MAX_THREADS: Fig. 5b knee at stride 7 for SIMD=16
    f_kernel=300e6,
    peak_flops=9.2e12,      # Stratix 10 GX 2800 single-precision peak
)


#: What one Stratix-10 board can actually host: the global-memory
#: interconnect arbitrates up to 128 LSU ports, a kernel wider than 4 KiB
#: of aggregate LSU width does not close timing, one DDR4 channel, and the
#: burst buffers must fit the ~30 MB of on-chip BRAM.
_S10_ENVELOPE = ResourceEnvelope(
    lsu_ports=128, interconnect_bytes=4096,
    dram_channels=1, buffer_bytes=30e6)

#: TPU transplant budget: wider interconnect and more VMEM, one HBM stack
#: presented as a single channel to the model.
_TPU_ENVELOPE = ResourceEnvelope(
    lsu_ports=256, interconnect_bytes=16384,
    dram_channels=1, buffer_bytes=128e6)


def _s10_board(name: str, dram: DramOrganization) -> Hardware:
    return Hardware(
        name=name,
        dram=dram,
        clock=_S10_CLOCK,
        mem=MemorySystem(
            peak_bw=dram.bw_mem,
            txn_bytes=(1 << _S10_CLOCK.burst_cnt) * dram.min_burst_bytes,
            t_row=dram.t_row,
            mlp=dram.banks,         # bank interleaving hides row opens
            capacity_bytes=2e9,     # paper SIV: "2GB DDR4"
            local_bytes=30e6,       # on-chip BRAM order of magnitude
        ),
        envelope=_S10_ENVELOPE,
    )


STRATIX10_DDR4_1866 = register(_s10_board(
    "stratix10_ddr4_1866",
    DramOrganization(                # paper Table III: DDR4-1866
        name="DDR4-1866", f_mem=933.3e6, dq=8, bl=8,
        t_rcd=13.5e-9, t_rp=13.5e-9, t_wr=15e-9,
        banks=4, row_bytes=8192, interleave_bytes=1024)))

STRATIX10_DDR4_2666 = register(_s10_board(
    "stratix10_ddr4_2666",
    DramOrganization(                # JEDEC DDR4-2666 19-19-19 speed bin
        name="DDR4-2666", f_mem=1333.0e6, dq=8, bl=8,
        t_rcd=14.25e-9, t_rp=14.25e-9, t_wr=15e-9,
        banks=4, row_bytes=8192, interleave_bytes=1024)))

# -- TPU transplant targets -------------------------------------------------

TPU_V5E = register(Hardware(
    name="tpu_v5e",
    mem=MemorySystem(
        peak_bw=819e9, txn_bytes=512, t_row=28e-9, mlp=64,
        k_stream=0.92, k_strided=0.92, k_gather=0.92,
        capacity_bytes=16e9, local_bytes=128e6),
    # HBM expressed in bank/burst terms: dq*bl = 512 B transaction, f_mem
    # chosen so dq * 2 * f_mem equals the 819 GB/s interface bandwidth.
    dram=DramOrganization(
        name="HBM-v5e", f_mem=819e9 / (2 * 64), dq=64, bl=8,
        t_rcd=14e-9, t_rp=14e-9, t_wr=15e-9,
        banks=32, row_bytes=1024, interleave_bytes=512),
    clock=ClockDomain(
        burst_cnt=0,                 # one min-burst per transaction (512 B)
        max_th=128, f_kernel=940e6, peak_flops=197e12,
        ici_bw=50e9, ici_links=4, ici_hop_latency=1e-6),
    envelope=_TPU_ENVELOPE,
))

TPU_V4 = register(Hardware(
    name="tpu_v4",
    mem=MemorySystem(
        peak_bw=1228e9, txn_bytes=512, t_row=28e-9, mlp=64,
        k_stream=0.92, k_strided=0.92, k_gather=0.92,
        capacity_bytes=32e9, local_bytes=128e6),
    dram=DramOrganization(
        name="HBM2-v4", f_mem=1228e9 / (2 * 64), dq=64, bl=8,
        t_rcd=14e-9, t_rp=14e-9, t_wr=15e-9,
        banks=32, row_bytes=1024, interleave_bytes=512),
    clock=ClockDomain(
        burst_cnt=0, max_th=128, f_kernel=1050e6, peak_flops=275e12,
        ici_bw=50e9, ici_links=6,    # 3D torus: six ICI links per chip
        ici_hop_latency=1e-6),
    envelope=_TPU_ENVELOPE,
))
