"""Measured-vs-predicted kernel validation harness.

Port of ``repro.core.validate``, the paper's SIV methodology on the card:

1. **Characterize** — time the stream anchor (``membench_aligned``) and
   fit the effective bandwidth: ``calibrate_dram`` rescales ``f_mem`` so
   Eq. 2's ideal time matches it.
2. **Read the traffic** — each case's bytes per access class come from its
   kernel wrapper's ``*_traffic`` function, computed from the launch
   geometry (each input byte read once, each output byte written once).
   PyTorch has no HLO to count, and the reference's HLO counts in
   interpret mode are artifacts of the interpreter.
3. **Predict** — map the classed bytes onto LSU groups and score Eqs. 1-10
   for all kernels in one ``estimate_batch`` pass.
4. **Measure** — time each kernel: CUDA events after warmup on the card,
   ``perf_counter`` on the CPU; report |measured - predicted| errors.

A case that fails to build or run becomes a failure record, never an
exception: partial tables are still tables.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.fpga import DramParams
from repro_torch.core.lsu import Lsu, LsuType
from repro_torch.core.model_batch import GroupBatch, estimate_batch

#: Modeled bytes of one LSU access when mapping class traffic onto LSU
#: groups: the DDR4 minimum burst (dq * bl = 8 * 8) of the paper's parts.
ACCESS_BYTES = 64


def _default_dram() -> DramParams:
    from repro_torch.hw import DEFAULT_BOARD, get as _get

    return _get(DEFAULT_BOARD).dram_params()


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ValidationCase:
    """One kernel to validate: ``build(device)`` returns ``(fn, args,
    traffic)``, where ``traffic`` is the wrapper's classed byte count;
    ``plain(*args)``, where given, is the plain PyTorch version of ``fn``."""

    name: str
    build: Callable[[torch.device], tuple]
    calibration: bool = False    # stream anchor used to fit the bandwidth
    plain: Callable | None = None


def _normal(shape, seed: int, device, dtype=torch.float32) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def default_cases(*, small: bool = True) -> list[ValidationCase]:
    """The three membench access classes and GQA decode attention.

    ``small=True`` keeps the reference's small shapes (CPU runs in
    seconds).  ``small=False`` gives shapes sized for the H100: every
    working set is well past its 50 MB L2, so the kernels stream from
    device memory — n = 2**26 float32 membench arrays, and decode at
    qwen2-7b width (28 query heads over 4 KV heads of 128) with B = 8 and a
    32,768-position bfloat16 cache.
    """
    from repro_torch.kernels.decode_attention import ops as DA
    from repro_torch.kernels.membench import ops as MB

    n = 1 << (15 if small else 26)
    n_gather = 16 if small else 32768
    if small:
        B, S, Hq, Hkv, D, dtype, block_s = 2, 128, 8, 2, 32, torch.float32, 64
    else:
        B, S, Hq, Hkv, D, dtype, block_s = 8, 32768, 28, 4, 128, torch.bfloat16, 512

    def aligned(device):
        xs = tuple(_normal((n,), i, device) for i in range(3))
        return (lambda xs: MB.aligned_sum(xs, block=2048), (xs,),
                MB.aligned_sum_traffic(xs, block=2048))

    def strided(device):
        xs = tuple(_normal((n,), i, device) for i in range(2))
        return (lambda xs: MB.strided_sum(xs, delta=4, block=512), (xs,),
                MB.strided_sum_traffic(xs, delta=4, block=512))

    def gather(device):
        xs = tuple(_normal((n,), i, device) for i in range(2))
        ids = np.random.default_rng(9).integers(0, n // 512, n_gather)
        idx = torch.as_tensor(ids, dtype=torch.int32, device=device)
        return (lambda xs, idx: MB.gather_sum(xs, idx, block=512), (xs, idx),
                MB.gather_sum_traffic(xs, idx, block=512))

    def decode(device):
        q = _normal((B, 1, Hq, D), 11, device, dtype)
        kc = _normal((B, S, Hkv, D), 12, device, dtype)
        vc = _normal((B, S, Hkv, D), 13, device, dtype)
        kv_len = torch.tensor(S, dtype=torch.int32, device=device)
        return (lambda *a: DA.gqa_decode(*a, block_s=block_s),
                (q, kc, vc, kv_len), DA.gqa_decode_traffic(q, kc, vc, S))

    return [
        ValidationCase("membench_aligned", aligned, calibration=True,
                       plain=MB.aligned_sum_ref),
        ValidationCase("membench_strided", strided,
                       plain=lambda xs: MB.strided_sum_ref(xs, delta=4,
                                                           block=512)),
        ValidationCase("membench_gather", gather,
                       plain=lambda xs, idx: MB.gather_sum_ref(xs, idx,
                                                               block=512)),
        ValidationCase("decode_attention", decode, plain=DA.gqa_decode_ref),
    ]


# ---------------------------------------------------------------------------
# measure / predict
# ---------------------------------------------------------------------------

def time_callable(fn, args, *, device, iters: int = 3,
                  warmup: int = 1) -> float:
    """Seconds per call after ``warmup`` calls.

    On the card: CUDA events around ``iters`` back-to-back calls, divided
    by the count (one call's host overhead would otherwise sit between the
    start event and the kernel).  On the CPU: the median of ``iters``
    ``perf_counter`` readings.
    """
    device = torch.device(device)
    iters = max(1, iters)
    for _ in range(max(1, warmup)):
        fn(*args)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) * 1e-3 / iters
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


_CLASS_LSU = {"stream": LsuType.BC_ALIGNED,
              "strided": LsuType.BC_NON_ALIGNED,
              "gather": LsuType.BC_WRITE_ACK,
              "serialized": LsuType.BC_WRITE_ACK}


def lsus_from_classes(bytes_by_class: dict, *,
                      access_bytes: int = ACCESS_BYTES) -> list[Lsu]:
    """Map access-class byte totals onto LSU groups: each class becomes one
    LSU of the matching paper type issuing ``access_bytes``-wide accesses,
    total traffic preserved."""
    lsus = []
    for name, b in sorted(bytes_by_class.items()):
        if b <= 0:
            continue
        lsus.append(Lsu(_CLASS_LSU.get(name, LsuType.BC_ALIGNED),
                        ls_width=access_bytes,
                        ls_acc=max(1, int(round(b / access_bytes))),
                        ls_bytes=access_bytes, name=name))
    return lsus


def calibrate_dram(measured_bw: float, base: DramParams | None = None,
                   name: str = "host-calibrated") -> DramParams:
    """DRAM parameter set whose Eq. 2 peak bandwidth equals ``measured_bw``
    (only the I/O clock is rescaled; the timing overheads keep their
    datasheet values)."""
    base = base if base is not None else _default_dram()
    return dataclasses.replace(base, name=name,
                               f_mem=measured_bw / (2.0 * base.dq))


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KernelValidation:
    """One row of the measured-vs-predicted error table."""

    name: str
    backend: str                 # the device the kernel ran on
    measured_s: float
    predicted_s: float
    bytes_moved: float
    flops: float
    err_pct: float               # |predicted - measured| / measured * 100
    memory_bound: bool

    def row(self) -> dict:
        return {
            "kernel": self.name, "backend": self.backend,
            "measured_ms": round(self.measured_s * 1e3, 4),
            "predicted_ms": round(self.predicted_s * 1e3, 4),
            "bytes_mb": round(self.bytes_moved / 1e6, 3),
            "flops_m": round(self.flops / 1e6, 3),
            "memory_bound": bool(self.memory_bound),
            "err_pct": round(self.err_pct, 1),
        }


@dataclasses.dataclass(frozen=True)
class ValidationReport:
    results: list[KernelValidation]
    failures: list[dict]         # {"kernel": name, "error": msg}
    dram: DramParams             # the calibrated parameter set
    measured_bw: float           # stream bandwidth anchor [B/s]
    calibration_factor: float = 1.0   # measured/modeled on the stream anchor

    @property
    def max_err_pct(self) -> float:
        return max((r.err_pct for r in self.results), default=float("nan"))

    def rows(self) -> list[dict]:
        return [r.row() for r in self.results]


def _report(measured: Sequence[tuple[ValidationCase, float, dict]],
            failures: list[dict], *, backend: str,
            dram: DramParams | None, base: DramParams,
            fit_host_factor: bool, device) -> ValidationReport:
    """The prediction side: ``(case, measured seconds, traffic)`` triples ->
    calibrated Eqs. 1-10 predictions and errors (no clock is read here)."""
    if not measured:
        return ValidationReport([], failures, dram or base, float("nan"))

    anchor = next((m for m in measured if m[0].calibration), measured[0])
    measured_bw = anchor[2]["total_bytes"] / anchor[1]
    if dram is None:
        dram = calibrate_dram(measured_bw, base)

    kernels = [lsus_from_classes(tr["bytes_by_class"])
               for _, _, tr in measured]
    est = estimate_batch(GroupBatch.from_kernels(kernels, dram), device=device)
    t_raw = np.asarray(est.t_exe, dtype=float)

    anchor_idx = measured.index(anchor)
    factor = (anchor[1] / t_raw[anchor_idx]
              if fit_host_factor and np.isfinite(t_raw[anchor_idx])
              and t_raw[anchor_idx] > 0
              else 1.0)

    results = []
    for i, (case, t, tr) in enumerate(measured):
        pred = float(t_raw[i] * factor)
        results.append(KernelValidation(
            name=case.name, backend=backend,
            measured_s=t, predicted_s=pred,
            bytes_moved=float(tr["total_bytes"]), flops=float(tr["flops"]),
            err_pct=abs(pred - t) / t * 100.0,
            memory_bound=bool(np.asarray(est.memory_bound)[i]),
        ))
    return ValidationReport(results, failures, dram, measured_bw,
                            calibration_factor=float(factor))


def _validate(cases: Sequence[ValidationCase] | None = None, *,
              device, iters: int = 3, warmup: int = 1,
              dram: DramParams | None = None,
              base: DramParams | None = None,
              fit_host_factor: bool = True) -> ValidationReport:
    """Run the measured-vs-predicted loop over ``cases`` on ``device``.

    Pass ``dram`` to skip bandwidth calibration; otherwise the first
    ``calibration=True`` case (or the first case) anchors the effective
    bandwidth, and a host factor — measured/modeled time on the same
    anchor — absorbs device-global costs the DRAM-scale model cannot see,
    so per-kernel errors measure the model's relative fidelity.
    """
    device = torch.device(device)
    base = base if base is not None else _default_dram()
    cases = list(cases) if cases is not None else default_cases()
    backend = (torch.cuda.get_device_name(device) if device.type == "cuda"
               else "cpu")

    measured: list[tuple[ValidationCase, float, dict]] = []
    failures: list[dict] = []
    for case in cases:
        try:
            fn, args, traffic = case.build(device)
            t = time_callable(fn, args, device=device, iters=iters,
                              warmup=warmup)
            if not (np.isfinite(t) and t > 0):
                raise ValueError(f"non-finite measurement {t!r}")
            measured.append((case, t, traffic))
        except Exception as e:  # noqa: BLE001 — a failed kernel is a row
            failures.append({"kernel": case.name,
                             "error": f"{type(e).__name__}: {e}"})
    return _report(measured, failures, backend=backend, dram=dram, base=base,
                   fit_host_factor=fit_host_factor, device=device)
