"""TPU-transplant chip constants: the port's copy of ``repro.core.hbm.TpuParams``.

Only the dataclass that :meth:`repro_torch.hw.Hardware.tpu_params` returns
is carried over; the HBM traffic model that reads it waits for the slice
that ports the roofline/predictor layer.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TpuParams:
    """TPU chip + interconnect constants (v5e datasheet values as given)."""

    name: str = "tpu-v5e"
    peak_flops: float = 197e12          # bf16 FLOP/s per chip
    hbm_bw: float = 819e9               # HBM bytes/s per chip
    ici_bw: float = 50e9                # bytes/s per ICI link (~50 GB/s/link)
    ici_links: int = 4                  # links per chip on a 2D torus
    hbm_bytes: float = 16e9             # HBM capacity per chip
    vmem_bytes: float = 128e6           # VMEM per chip (order of magnitude)
    # HBM transaction model (the burst/`dq*bl` analogue):
    txn_bytes: int = 512                # HBM transaction granularity
    t_row: float = 28e-9                # row-miss latency (tRCD+tRP class)
    mlp: int = 64                       # outstanding-transaction parallelism
    ici_hop_latency: float = 1e-6       # per-hop collective launch latency
    # Class efficiency factors K (the K_lsu analogue; fraction of peak HBM
    # bandwidth a pure stream of this class sustains):
    k_stream: float = 0.92              # refresh + arbitration losses
    k_strided: float = 0.92             # before the sub-row penalty below
    k_gather: float = 0.92              # before the per-row transaction waste

    @property
    def ridge_flops_per_byte(self) -> float:
        """Roofline ridge point: FLOP/byte where compute == memory time."""
        return self.peak_flops / self.hbm_bw
