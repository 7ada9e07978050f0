"""TPU memory-system parameters and the access-class taxonomy.

Port of ``repro.core.hbm``: the hardware adaptation of the paper's Table I
and Table III to a TPU target.  The LSU types become *access classes* of
HLO-level memory traffic; the DRAM datasheet becomes the TPU v5e datasheet
constants plus HBM transaction parameters.  These are model inputs, not
measurements of any card this package runs on.

Class mapping (paper -> TPU):

    BC_ALIGNED        -> STREAM      contiguous tile-aligned HBM traffic
    BC_NON_ALIGNED    -> STRIDED     layout-changing / sub-transaction rows
    BC_WRITE_ACK      -> GATHER      data-dependent row gather/scatter
    ATOMIC_PIPELINED  -> SERIALIZED  collision-prone scatter-accumulate
    PIPELINED (local) -> VMEM        on-chip, no HBM traffic

Each class has the same two-term structure as the paper's model: a bandwidth
term at class efficiency ``K`` (the `K_lsu` analogue) and a per-transaction
latency term ``T_row`` amortized by the memory-level parallelism the access
pattern allows (the bank-interleaving analogue of Eq. 4).

:func:`memory_time_batch` is the vectorized form on float64 tensors.
Nothing here imports :mod:`repro_torch.hw` or torch at module level:
``repro_torch.hw`` reads :class:`TpuParams` from here while it loads.
"""
from __future__ import annotations

import dataclasses
import enum


class AccessClass(enum.Enum):
    STREAM = "stream"
    STRIDED = "strided"
    GATHER = "gather"
    SERIALIZED = "serialized"
    VMEM = "vmem"


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


def _as_tpu_params(hw) -> TpuParams:
    """Normalize ``hw`` to a :class:`TpuParams` view.

    Accepts ``None`` (the registry's ``tpu_v5e`` preset), a ``TpuParams``,
    or anything with a ``tpu_params()`` view (a ``repro_torch.hw.Hardware`` spec)
    — the hook that threads the unified spec through every model path.
    """
    if hw is None:
        from repro_torch.hw import DEFAULT_CHIP, get as _get

        return _get(DEFAULT_CHIP).tpu_params()
    view = getattr(hw, "tpu_params", None)
    if callable(view):
        return view()
    return hw


@dataclasses.dataclass(frozen=True)
class Traffic:
    """One classified traffic component of a compiled step (the Lsu analogue).

    ``bytes`` counts *useful* bytes; ``row_bytes`` is the contiguous run
    length of the access pattern (minor-dim extent for strided ops, the
    gathered row size for gathers) — the paper's ``ls_width``/``delta``
    information collapsed to what HLO exposes.
    """

    access_class: AccessClass
    nbytes: float
    row_bytes: float = 512.0
    name: str = ""


def traffic_time(t: Traffic, hw=None) -> tuple[float, float]:
    """(T_ideal, T_ovh) for one traffic component — Eqs. 2 and 4 transplanted.

    ``hw`` may be a :class:`TpuParams`, a ``repro_torch.hw.Hardware`` spec, or
    ``None`` (the registry's ``tpu_v5e`` preset).

    * T_ideal = useful bytes / peak HBM bandwidth (identical for all classes,
      exactly like Eq. 2).
    * T_ovh   = wasted-transaction transfer time + per-transaction row
      latency amortized over the class's memory-level parallelism.
    """
    hw = _as_tpu_params(hw)
    t_ideal = t.nbytes / hw.hbm_bw
    if t.access_class is AccessClass.VMEM or t.nbytes <= 0:
        return t_ideal, 0.0

    if t.access_class is AccessClass.STREAM:
        # only the stream-efficiency loss (the 14.93 -> 14.2 GB/s analogue)
        t_ovh = t.nbytes / (hw.hbm_bw * hw.k_stream) - t_ideal
        return t_ideal, max(0.0, t_ovh)

    row = max(1.0, t.row_bytes)
    txns_per_row = max(1.0, -(-row // hw.txn_bytes))        # ceil
    fetched_per_row = txns_per_row * hw.txn_bytes
    waste = max(0.0, fetched_per_row / row - 1.0)           # Eq. 8 analogue
    n_rows = t.nbytes / row
    n_txn = n_rows * txns_per_row

    if t.access_class is AccessClass.STRIDED:
        t_ovh = (t.nbytes * waste) / (hw.hbm_bw * hw.k_strided)
        t_ovh += t.nbytes / (hw.hbm_bw * hw.k_strided) - t_ideal
        return t_ideal, max(0.0, t_ovh)

    if t.access_class is AccessClass.GATHER:
        # wasted transfer + one T_row per transaction, amortized over the
        # outstanding-transaction parallelism (bank interleaving analogue).
        t_ovh = (t.nbytes * waste) / (hw.hbm_bw * hw.k_gather)
        t_ovh += n_txn * hw.t_row / hw.mlp
        return t_ideal, t_ovh

    # SERIALIZED: Eq. 10 — a full read+write row cycle per transaction, no
    # amortization (collisions serialize).
    t_ovh = n_txn * (2.0 * hw.t_row)
    return t_ideal, t_ovh


def memory_time(components: list[Traffic], hw=None) -> float:
    """Eq. 1 transplanted: sum of per-class (T_ideal + T_ovh)."""
    hw = _as_tpu_params(hw)
    return sum(sum(traffic_time(c, hw)) for c in components)


def memory_time_batch(bytes_by_class, hw=None, *,
                      row_bytes: float = 512.0, device=None):
    """Vectorized ``memory_time`` over a batch of compiled steps.

    ``bytes_by_class`` maps an :class:`AccessClass` (or its value string) to
    an array of useful-byte totals, one entry per step; returns the per-step
    memory time as a float64 tensor on ``device`` (the CUDA card unless the
    caller passes ``"cpu"``).  The same operations in the same order as the
    scalar ``traffic_time`` sum for the same ``row_bytes``, so on the CPU it
    is bit-equal to the reference's NumPy version.
    """
    import torch

    from repro_torch import compat

    device = compat.resolve_device(device)
    hw = _as_tpu_params(hw)
    total = None
    for cls, nbytes in bytes_by_class.items():
        if isinstance(cls, str):
            cls = AccessClass(cls)
        b = torch.as_tensor(nbytes, dtype=torch.float64, device=device)
        t_ideal = b / hw.hbm_bw
        if cls is AccessClass.VMEM:
            t_ovh = torch.zeros_like(b)
        elif cls is AccessClass.STREAM:
            t_ovh = torch.clamp(b / (hw.hbm_bw * hw.k_stream) - t_ideal,
                                min=0.0)
        else:
            row = max(1.0, row_bytes)
            txns_per_row = max(1.0, -(-row // hw.txn_bytes))      # ceil
            fetched_per_row = txns_per_row * hw.txn_bytes
            waste = max(0.0, fetched_per_row / row - 1.0)
            n_txn = (b / row) * txns_per_row
            if cls is AccessClass.STRIDED:
                t_ovh = torch.clamp(
                    (b * waste) / (hw.hbm_bw * hw.k_strided)
                    + b / (hw.hbm_bw * hw.k_strided) - t_ideal, min=0.0)
            elif cls is AccessClass.GATHER:
                t_ovh = ((b * waste) / (hw.hbm_bw * hw.k_gather)
                         + n_txn * hw.t_row / hw.mlp)
            else:                                                 # SERIALIZED
                t_ovh = n_txn * (2.0 * hw.t_row)
        contrib = t_ideal + torch.where(b > 0, t_ovh, torch.zeros_like(t_ovh))
        total = contrib if total is None else total + contrib
    if total is None:
        return torch.zeros(0, dtype=torch.float64, device=device)
    return total
