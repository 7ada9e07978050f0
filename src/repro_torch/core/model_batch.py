"""Array core of the paper's analytical model (Eqs. 1-10) on torch tensors.

Port of ``repro.core.model_batch``: the same structure-of-arrays over *LSU
groups* (``count`` identical LSUs of one kernel per group; Eq. 1's sum over
LSUs becomes a segment sum weighted by ``count``), and the same
:func:`group_timing` body, run through an array-namespace shim: plain
Python scalars for the scalar reference (:data:`SCALAR_XP`) and float64
tensors on the session's device for the batched path (:data:`TORCH_XP`).

Two rules keep the torch path bit-equal to the reference's NumPy core:

* Every integer column except the type codes, the group->kernel map and
  ``burst_cnt`` is promoted to float64 before the math runs.  In PyTorch
  an int64 tensor divided by an int64 tensor, or multiplied by a Python
  float, gives float32 (the default dtype) where NumPy gives float64.  The
  promoted columns' products stay below 2**53, so every operation rounds
  exactly where NumPy's does.  The default dtype is never changed.
* Every per-kernel segment sum adds in a fixed order: the reference's
  ``np.bincount`` order, each kernel's groups left to right in batch order
  starting from 0.0.  The sweep path's two groups per kernel take the
  split add (``paired_kernel``); heterogeneous batches (``estimate_many``,
  the server) scatter the groups into a zero-padded ``(kernels, slots)``
  matrix and add its columns left to right (:func:`_fixed_order_segments`).
  Neither uses ``index_add_``, whose floating-point order on CUDA is not
  fixed, so a kernel's result does not depend on the device, the run or
  the rest of its batch.

:func:`estimate_columns` is the tensor core (tensors in, tensors out, on
the device and through autograd); :func:`estimate_batch` wraps it and
crosses back to NumPy at the :class:`BatchEstimate` boundary, one
device-to-host copy for the kernel columns and one for the group columns.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch import compat
from repro_torch.core.fpga import BspParams, DramParams
from repro_torch.core.lsu import Lsu, LsuType

# Integer codes for the GMI LSU types (the only ones that touch DRAM).
ALIGNED, NON_ALIGNED, CACHE, WRITE_ACK, ATOMIC = 0, 1, 2, 3, 4

TYPE_CODE = {
    LsuType.BC_ALIGNED: ALIGNED,
    LsuType.BC_NON_ALIGNED: NON_ALIGNED,
    LsuType.BC_CACHE: CACHE,
    LsuType.BC_WRITE_ACK: WRITE_ACK,
    LsuType.ATOMIC_PIPELINED: ATOMIC,
    # The high-end BSP compiles prefetching LSUs as burst-coalesced aligned.
    LsuType.PREFETCHING: ALIGNED,
}


class _ScalarNamespace:
    """Array-namespace shim over plain Python scalars (the scalar backend)."""

    @staticmethod
    def asarray(x):
        return x

    @staticmethod
    def where(cond, a, b):
        return a if cond else b

    @staticmethod
    def maximum(a, b):
        return a if a >= b else b


class _TorchNamespace:
    """Array-namespace shim over torch tensors (the torch backend)."""

    @staticmethod
    def asarray(x):
        return x

    @staticmethod
    def where(cond, a, b):
        return torch.where(cond, a, b)

    @staticmethod
    def maximum(a, b):
        return torch.clamp(a, min=b)


SCALAR_XP = _ScalarNamespace()
TORCH_XP = _TorchNamespace()


def group_timing(
    *,
    lsu_type,
    ls_width,
    ls_acc,
    ls_bytes,
    delta,
    val_constant,
    n_lsu,
    f,
    dq,
    bl,
    f_mem,
    t_rcd,
    t_rp,
    t_wr,
    burst_cnt,
    max_th,
    xp,
) -> dict[str, Any]:
    """Eqs. 2 and 4-10 for a batch of LSU groups.

    All arguments are tensors (or scalars) broadcastable to a common shape.
    Returns per-single-LSU terms: multiply ``t_total`` by the group
    ``count`` to get the group's Eq. 1 contribution.
    """
    lsu_type = xp.asarray(lsu_type)
    is_atomic = lsu_type == ATOMIC
    is_ack = lsu_type == WRITE_ACK
    is_nonaligned = lsu_type == NON_ALIGNED
    coalescing = (lsu_type == ALIGNED) | is_nonaligned | (lsu_type == CACHE)

    bw_mem = dq * 2.0 * f_mem                       # Eq. 2 denominator
    min_burst = dq * bl                              # dq * bl [B]
    max_txn = (2 ** xp.asarray(burst_cnt)) * min_burst  # Eq. 5 upper bound

    total_bytes = ls_acc * ls_bytes
    t_ideal = total_bytes / bw_mem                   # Eq. 2

    # Effective transaction size (Eq. 5 / Eqs. 7-8 / min-burst for atomics).
    max_reqs = max_th * ls_width / (delta + 1)       # Eq. 7
    bsz_nonaligned = xp.where(max_reqs <= max_txn,   # Eq. 8 knee
                              max_reqs / delta, ls_width / delta)
    bsz = xp.where(is_nonaligned, bsz_nonaligned, 1.0 * max_txn)
    bsz = xp.where(is_atomic, 1.0 * min_burst, bsz)

    n_bursts_bc = total_bytes / bsz
    t_row_bc = t_rcd + t_rp                          # Eq. 6
    t_row = xp.where(is_ack, t_row_bc + t_wr, t_row_bc)          # Eq. 9
    t_row = xp.where(is_atomic, 2.0 * t_row_bc + t_wr, t_row)    # Eq. 10

    # Atomic-pipelined (Eq. 10): per-operation overhead, merged across the
    # vectorization factor when the summed value is loop-constant.
    per_op = xp.where(xp.asarray(val_constant), t_row / f, t_row)
    t_ovh_atomic = ls_acc * per_op

    # Burst-coalesced family (Eq. 4): a single stream never thrashes rows.
    single = n_lsu < 2
    t_ovh_bc = xp.where(single, 0.0, n_bursts_bc * t_row)
    # Write-ACK wasted-burst transfer inflation (SIII-A3).
    waste = xp.maximum(min_burst - ls_bytes, 0)
    t_ovh_bc = t_ovh_bc + xp.where(is_ack, ls_acc * waste / bw_mem, 0.0)
    # The ACK round-trip itself is never hidden by bank interleaving.
    t_ovh_bc = t_ovh_bc + xp.where(is_ack & single, n_bursts_bc * t_row, 0.0)

    t_ovh = xp.where(is_atomic, t_ovh_atomic, t_ovh_bc)
    n_bursts = xp.where(is_atomic, 1.0 * ls_acc, n_bursts_bc)

    # Eq. 3 per-LSU term with K_lsu = delta for coalescing LSUs, 1 otherwise.
    k = xp.where(coalescing, 1.0 * delta, 1.0)
    ratio_term = ls_width / (min_burst * k)

    return {
        "burst_size": bsz,
        "n_bursts": n_bursts,
        "t_ideal": t_ideal,
        "t_ovh": t_ovh,
        "t_total": delta * (t_ideal + t_ovh),        # Eq. 1 summand
        "ratio_term": ratio_term,
        "total_bytes": total_bytes,
        "latency_bound": is_ack | is_atomic,
    }


@dataclasses.dataclass(frozen=True)
class GroupBatch:
    """Structure-of-arrays over LSU groups for ``n_kernels`` design points.

    Columns are NumPy arrays; :func:`estimate_batch` moves them to the
    device.
    """

    kernel: Any          # int [M] — kernel id per group
    n_kernels: int
    count: Any           # int [M] — identical LSUs this group represents
    lsu_type: Any        # int codes [M]
    ls_width: Any
    ls_acc: Any
    ls_bytes: Any
    delta: Any
    val_constant: Any    # bool [M]
    f: Any               # per-kernel vectorization factor, broadcast to [M]
    dq: Any
    bl: Any
    f_mem: Any
    t_rcd: Any
    t_rp: Any
    t_wr: Any
    burst_cnt: Any
    max_th: Any

    @classmethod
    def from_kernels(
        cls,
        kernels: Sequence[Sequence[Lsu]],
        dram: DramParams | Sequence[DramParams],
        bsp: BspParams | Sequence[BspParams] | None = None,
        *,
        f: int | Sequence[int] = 1,
    ) -> "GroupBatch":
        """Build a batch from per-kernel LSU lists (one group per global LSU).

        ``dram``/``bsp``/``f`` may be single values (shared by every kernel)
        or per-kernel sequences.  Non-global (on-chip) LSUs are ignored.
        """
        if bsp is None:
            from repro_torch.hw import DEFAULT_BOARD, get as _get

            bsp = _get(DEFAULT_BOARD).bsp_params()
        n = len(kernels)
        drams = list(dram) if isinstance(dram, (list, tuple)) else [dram] * n
        bsps = list(bsp) if isinstance(bsp, (list, tuple)) else [bsp] * n
        fs = list(f) if isinstance(f, (list, tuple)) else [f] * n
        if not (len(drams) == len(bsps) == len(fs) == n):
            raise ValueError("per-kernel dram/bsp/f lengths must match kernels")

        cols: dict[str, list] = {k: [] for k in (
            "kernel", "lsu_type", "ls_width", "ls_acc", "ls_bytes", "delta",
            "val_constant", "f", "dq", "bl", "f_mem", "t_rcd", "t_rp", "t_wr",
            "burst_cnt", "max_th")}
        for ki, lsus in enumerate(kernels):
            d, b, fk = drams[ki], bsps[ki], fs[ki]
            for lsu in lsus:
                if not lsu.lsu_type.is_global:
                    continue
                cols["kernel"].append(ki)
                cols["lsu_type"].append(TYPE_CODE[lsu.lsu_type])
                cols["ls_width"].append(lsu.ls_width)
                cols["ls_acc"].append(lsu.ls_acc)
                cols["ls_bytes"].append(lsu.ls_bytes)
                cols["delta"].append(lsu.delta)
                cols["val_constant"].append(lsu.val_constant)
                cols["f"].append(fk)
                cols["dq"].append(d.dq)
                cols["bl"].append(d.bl)
                cols["f_mem"].append(d.f_mem)
                cols["t_rcd"].append(d.t_rcd)
                cols["t_rp"].append(d.t_rp)
                cols["t_wr"].append(d.t_wr)
                cols["burst_cnt"].append(b.burst_cnt)
                cols["max_th"].append(b.max_th)

        m = len(cols["kernel"])
        floats = ("f_mem", "t_rcd", "t_rp", "t_wr")
        return cls(
            n_kernels=n,
            count=np.ones(m, dtype=np.int64),
            **{k: np.asarray(v, dtype=(bool if k == "val_constant"
                                       else np.float64 if k in floats
                                       else np.int64))
               for k, v in cols.items()})


@dataclasses.dataclass(frozen=True)
class BatchEstimate:
    """Model output for a batch of kernels (NumPy arrays, on the host)."""

    t_exe: Any           # [n_kernels] Eq. 1 [s]
    t_ideal: Any         # [n_kernels] sum of delta * T_ideal
    t_ovh: Any           # [n_kernels] sum of delta * T_ovh
    bound_ratio: Any     # [n_kernels] LHS of Eq. 3
    memory_bound: Any    # bool [n_kernels]
    total_bytes: Any     # [n_kernels] useful bytes moved
    n_lsu: Any           # [n_kernels] number of global LSUs
    groups: dict         # per-group timing arrays (group_timing output)

    @property
    def effective_bandwidth(self) -> Any:
        """Useful bytes / predicted time [B/s] (inf where t_exe == 0)."""
        with np.errstate(divide="ignore", invalid="ignore"):
            out = np.where(np.asarray(self.t_exe) > 0,
                           self.total_bytes / np.maximum(self.t_exe, 1e-300),
                           np.inf)
        return out


#: Columns that stay int64 on the device: the group->kernel map, the type
#: codes (compared, never divided) and the Eq. 5 exponent (``2 ** burst_cnt``
#: is exact in integers).  Everything else numeric is promoted to float64.
_INT_COLUMNS = ("kernel", "lsu_type", "burst_cnt")


def _device_columns(batch: GroupBatch, device) -> dict[str, torch.Tensor]:
    out = {}
    for field in dataclasses.fields(GroupBatch):
        if field.name == "n_kernels":
            continue
        col = torch.as_tensor(np.asarray(getattr(batch, field.name)),
                              device=device)
        dtype = (torch.int64 if field.name in _INT_COLUMNS
                 else torch.bool if field.name == "val_constant"
                 else torch.float64)
        out[field.name] = col.to(dtype)
    return out


def _to_host(cols: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """Same-length columns to NumPy in one device-to-host copy (bools and
    integer counts survive the float64 round trip exactly)."""
    names = list(cols)
    if not names:
        return {}
    stacked = torch.stack([cols[k].to(torch.float64) for k in names])
    host = stacked.cpu().numpy()
    return {k: (host[i].astype(bool) if cols[k].dtype == torch.bool
                else host[i]) for i, k in enumerate(names)}


def _fixed_order_segments(kernel: torch.Tensor, n: int):
    """Per-kernel segment sum in ``np.bincount``'s order, fixed on every
    device.

    Group ``i`` goes to row ``kernel[i]`` of a zero-padded ``(n, slots)``
    float64 matrix, at its rank among that kernel's groups in batch order;
    the sum adds the columns left to right starting from 0.0 — per kernel,
    ``((0 + w_1) + w_2) + ...``, exactly as ``np.bincount`` accumulates
    (a padding ``+ 0.0`` changes nothing).  The scatter writes each slot
    once, so nothing depends on thread order, and it stays differentiable.
    Returns ``seg(data) -> [n]``.
    """
    m = kernel.shape[0]
    dev = kernel.device
    counts = torch.bincount(kernel, minlength=n)
    slots = int(counts.max()) if m else 0
    order = torch.argsort(kernel, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(kernel)
    rank[order] = torch.arange(m, device=dev) - starts[kernel[order]]
    flat = kernel * slots + rank

    def seg(data: torch.Tensor) -> torch.Tensor:
        mat = torch.zeros(n * slots, dtype=torch.float64, device=dev).scatter(
            0, flat, data.to(torch.float64)).view(n, slots)
        acc = torch.zeros(n, dtype=torch.float64, device=dev)
        for j in range(slots):
            acc = acc + mat[:, j]
        return acc

    return seg


#: The per-kernel columns :func:`estimate_columns` can compute, in order.
KERNEL_COLUMNS = ("t_exe", "t_ideal", "t_ovh", "bound_ratio", "memory_bound",
                  "total_bytes", "n_lsu")


def estimate_columns(cols: dict[str, torch.Tensor], n: int, *,
                     paired_kernel: bool = False,
                     want: Sequence[str] = KERNEL_COLUMNS,
                     ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """The tensor core of :func:`estimate_batch`: Eq. 3 classification and
    Eq. 1 execution time from group columns already on the device.

    ``cols`` holds one tensor per :class:`GroupBatch` column (``kernel``,
    ``lsu_type`` and ``burst_cnt`` int64, ``val_constant`` bool, the rest
    float64, as :func:`_device_columns` makes them); ``n`` is the number of
    kernels.  Returns ``(kernel columns, group columns)``, tensors on the
    columns' device, with only the ``want`` kernel columns computed.  Nothing
    leaves the device and nothing cuts autograd, so the device fold scores
    chunks through it and the optimizer differentiates through it.
    """
    count = cols["count"]
    if paired_kernel:
        seg = lambda data: data[:n] + data[n:]  # noqa: E731
        n_lsu = torch.cat([seg(count)] * 2)
    else:
        kernel = cols["kernel"]
        seg = _fixed_order_segments(kernel, n)
        n_lsu = seg(count)[kernel]
    g = group_timing(
        lsu_type=cols["lsu_type"], ls_width=cols["ls_width"],
        ls_acc=cols["ls_acc"], ls_bytes=cols["ls_bytes"],
        delta=cols["delta"], val_constant=cols["val_constant"], n_lsu=n_lsu,
        f=cols["f"], dq=cols["dq"], bl=cols["bl"], f_mem=cols["f_mem"],
        t_rcd=cols["t_rcd"], t_rp=cols["t_rp"], t_wr=cols["t_wr"],
        burst_cnt=cols["burst_cnt"], max_th=cols["max_th"], xp=TORCH_XP)
    delta = cols["delta"]
    out: dict[str, torch.Tensor] = {}
    for name in want:
        if name == "t_exe":
            out[name] = seg(count * g["t_total"])
        elif name in ("t_ideal", "t_ovh"):
            out[name] = seg(count * delta * g[name])
        elif name in ("bound_ratio", "memory_bound"):
            if "bound_ratio" not in out:
                out["bound_ratio"] = seg(count * g["ratio_term"])
            if name == "memory_bound":
                out[name] = (out["bound_ratio"] >= 1.0) \
                    | (seg(count * g["latency_bound"]) > 0)
        elif name == "total_bytes":
            out[name] = seg(count * g["total_bytes"])
        elif name == "n_lsu":
            out[name] = seg(count)
        else:
            raise KeyError(f"unknown kernel column {name!r}")
    return {k: out[k] for k in want}, g
    return out, g


def estimate_batch(batch: GroupBatch, *, device=None,
                   paired_kernel: bool = False) -> BatchEstimate:
    """Eq. 3 classification + Eq. 1 execution time for every kernel at once.

    ``device`` is where the columns are scored: the CUDA card unless the
    caller passes ``"cpu"`` (see :func:`compat.resolve_device`).
    ``paired_kernel=True`` asserts ``batch.kernel`` is exactly
    ``concat([arange(n), arange(n)])`` (two groups per kernel, as the sweep
    scorer builds) and replaces every segment reduction with the split add
    ``data[:n] + data[n:]``: bit-equal to the reference's ``np.bincount``
    (two terms per segment, and ``0 + a == a`` exactly) and fixed in order
    on every device.  A wrapper of :func:`estimate_columns` that moves the
    batch to the device and the result back to NumPy.
    """
    device = compat.resolve_device(device)
    kernels, g = estimate_columns(_device_columns(batch, device),
                                  batch.n_kernels,
                                  paired_kernel=paired_kernel)
    kernels = _to_host(kernels)
    kernels["n_lsu"] = kernels["n_lsu"].astype(np.int64)
    return BatchEstimate(**kernels, groups=_to_host(g))
