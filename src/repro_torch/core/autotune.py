"""Model-guided configuration search over sharding candidates.

Port of ``repro.core.autotune``.  ``autotune`` enumerates candidate knob
settings (KV-cache sharding axis, gradient compression, remat policy,
attention tile sizes), captures each candidate's sharded step as one rank
runs it (``launch.dryrun.capture_step``: a fake process group of the
mesh's size under ``FakeTensorMode``, no launch: the counterpart of the
reference's lower + compile on CPU), then scores and ranks **all
candidates in one batched pass** of the analytical model
(``hbm.memory_time_batch``, on the session's device).

Captured analyses are cached on disk (``cache.HloAnalysisCache``), keyed
by a hash of the full candidate configuration, the mesh, the hardware,
the torch version, the analyzer version and the source that builds the
step, so re-ranking a design space skips the capture.

A mesh is a ``DeviceMesh`` or a layout ``(shape, axis names)``: a layout
is captured over a fake group of its size, which is how one card ranks
the reference's 16x16 and 2x16x16 meshes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Mapping

import numpy as np
import torch

from repro_torch import compat
from repro_torch.core import predictor as _pred
from repro_torch.core.cache import HloAnalysisCache, config_hash
from repro_torch.core.hbm import AccessClass, TpuParams, Traffic, _as_tpu_params
from repro_torch.core import hbm as _hbm


def _hw_fingerprint(hw) -> dict:
    """JSON-able description of the active hardware spec for cache keying
    (the :class:`TpuParams` view ``rank_records`` reads, plus the host
    factor), so records ranked under one memory system are never reused
    under another."""
    return {"tpu": dataclasses.asdict(_as_tpu_params(hw)),
            "host_factor": float(getattr(hw, "host_factor", 1.0))}


@dataclasses.dataclass(frozen=True)
class Candidate:
    name: str
    overrides: dict            # ModelConfig field overrides
    train_overrides: dict      # TrainConfig field overrides


@dataclasses.dataclass
class TrialResult:
    candidate: Candidate
    prediction: _pred.StepPrediction
    compile_s: float           # the capture's seconds
    #: the rank's argument + output + temp - alias bytes (the dry-run's
    #: ``memory_analysis["total_bytes"]``: the eager peak), as the
    #: reference's compiled ``memory_analysis`` totals them
    memory_bytes: float | None
    cached: bool = False

    @property
    def t_step(self) -> float:
        return self.prediction.t_step_overlapped

    def summary(self) -> dict:
        p = self.prediction
        return {
            "name": self.candidate.name,
            "t_step_ms": p.t_step_overlapped * 1e3,
            "bottleneck": p.bottleneck,
            "t_compute_ms": p.t_compute * 1e3,
            "t_memory_ms": p.t_memory * 1e3,
            "t_collective_ms": p.t_collective * 1e3,
            "mem_gb": (self.memory_bytes or 0) / 1e9,
            "compile_s": self.compile_s,
            "cached": self.cached,
        }


@dataclasses.dataclass(frozen=True)
class TrialFailure:
    """Structured record of one candidate that failed to capture/analyze."""

    candidate: Candidate
    error_type: str
    error_msg: str

    def summary(self) -> dict:
        return {"name": self.candidate.name, "error_type": self.error_type,
                "error_msg": self.error_msg}


class AutotuneResults(list):
    """Ranked ``TrialResult`` list carrying the per-candidate failures
    (``.failures``, one :class:`TrialFailure` each)."""

    def __init__(self, results=(), failures: list[TrialFailure] = ()):
        super().__init__(results)
        self.failures = list(failures)


def default_candidates(kind: str) -> list[Candidate]:
    out = [Candidate("baseline", {}, {})]
    if kind in ("decode", "long_decode"):
        out += [
            Candidate("kv-heads", {}, {"kv_shard": "heads"}),
            Candidate("kv-seq", {}, {"kv_shard": "seq"}),
        ]
    if kind == "train":
        out += [
            Candidate("grad-bf16", {}, {"grad_compression": "bf16"}),
            Candidate("no-remat", {"remat": False}, {}),
            Candidate("attn-big-tiles", {"attn_block_q": 1024,
                                         "attn_block_kv": 2048}, {}),
        ]
    return out


_CODE_FPR: str | None = None


def _code_fingerprint() -> str:
    """Content hash of the source that determines the captured step:
    ``repro_torch``'s ``launch``, ``models``, ``configs``, ``kernels``,
    ``csrc`` and ``compat.py`` (a few dozen files, hashed once a process)."""
    global _CODE_FPR
    if _CODE_FPR is None:
        import hashlib
        import pathlib

        import repro_torch

        h = hashlib.sha256()
        root = pathlib.Path(next(iter(repro_torch.__path__)))
        for sub in ("launch", "models", "configs", "kernels", "csrc"):
            for p in sorted((root / sub).rglob("*")):
                if p.is_file() and p.suffix in (".py", ".cu", ".cuh", ".h"):
                    h.update(str(p.relative_to(root)).encode())
                    h.update(p.read_bytes())
        h.update((root / "compat.py").read_bytes())
        _CODE_FPR = h.hexdigest()[:16]
    return _CODE_FPR


def mesh_layout(mesh) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """(shape, axis names) of a ``DeviceMesh`` or of a layout."""
    if hasattr(mesh, "mesh_dim_names"):
        return tuple(mesh.shape), tuple(mesh.mesh_dim_names)
    shape, axes = mesh
    return tuple(shape), tuple(axes)


def candidate_key(cfg, shape, mesh, candidate: Candidate, hw=None) -> str:
    """Config hash identifying one (model, shape, mesh, candidate, hw)
    record, salted with the torch version, the analyzer version and a
    content hash of the step-building source."""
    from repro_torch.core.hlo_counter import ANALYZER_VERSION

    dims, axes = mesh_layout(mesh)
    n = int(np.prod(dims))
    return config_hash({
        "cfg": dataclasses.asdict(cfg),
        "shape": dataclasses.asdict(shape),
        "mesh": {"shape": dict(zip(axes, dims)), "n_devices": n},
        "candidate": {"overrides": candidate.overrides,
                      "train_overrides": candidate.train_overrides},
        "hw": _hw_fingerprint(hw),
    }, salt=f"torch-{torch.__version__}-analyzer-{ANALYZER_VERSION}"
            f"-src-{_code_fingerprint()}")


def _capture(cfg, shape, mesh, tcfg):
    """(records, memory) of the candidate's step on ``mesh``: a
    ``DeviceMesh`` of the process group in force, or a layout captured
    over a fake group of its size."""
    from repro_torch.launch.dryrun import capture_step
    from repro_torch.launch.mesh import fake_world, init_mesh

    if hasattr(mesh, "mesh_dim_names"):
        return capture_step(cfg, shape, tcfg, mesh)
    dims, axes = mesh_layout(mesh)
    with fake_world(int(np.prod(dims))):
        return capture_step(cfg, shape, tcfg,
                            init_mesh(dims, axes, device_type="cpu"))


def analyze_candidate(cfg, shape, mesh, candidate: Candidate,
                      cache: HloAnalysisCache | None = None,
                      hw=None) -> dict:
    """The captured analysis record of one candidate (cache-aware): the
    per-rank counts the model needs.  ``hw`` enters the cache key only."""
    from repro_torch.launch.dryrun import summarize
    from repro_torch.launch.steps import TrainConfig

    key = candidate_key(cfg, shape, mesh, candidate, hw)
    if cache is not None:
        rec = cache.get(key)
        if rec is not None:
            return {**rec, "cached": True}

    cfg_c = dataclasses.replace(cfg, **candidate.overrides)
    tcfg = TrainConfig(**candidate.train_overrides) \
        if candidate.train_overrides else TrainConfig()
    t0 = time.time()
    records, mem = _capture(cfg_c, shape, mesh, tcfg)
    dt = time.time() - t0
    hc = summarize(records)
    rec = {
        "flops": hc["flops"],
        "bytes_by_class": hc["bytes_by_class"],
        "collective_wire_bytes": hc["collective_wire_bytes"],
        "collective_operand_bytes": hc["collective_operand_bytes"],
        "collective_by_kind": hc["collective_by_kind"],
        "n_collectives": hc["n_collectives"],
        "memory_bytes": mem["total_bytes"],
        "xla_cost": {},
        "compile_s": dt,
        "cached": False,
    }
    if cache is not None:
        cache.put(key, rec)
    return rec


def rank_records(records: list[Mapping], hw: TpuParams | None = None, *,
                 gather_row_bytes: float = 512.0,
                 device=None) -> dict[str, np.ndarray]:
    """Score N analysis records in one vectorized pass (float64 on
    ``device``: the card unless the caller passes ``device="cpu"``; the
    reference's NumPy operations in its order, so the CPU result is
    bit-equal).  ``hw`` may be a :class:`TpuParams`, a
    ``repro_torch.hw.Hardware`` or None (the registry's ``tpu_v5e``).
    Returns per-candidate NumPy arrays ``t_compute``, ``t_memory``,
    ``t_collective``, ``t_step`` and ``order`` (stable argsort of
    ``t_step``: the ranking)."""
    hw = _as_tpu_params(hw)
    dev = compat.resolve_device(device)
    n = len(records)

    def col(values) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values, dtype=np.float64),
                               device=dev)
    class_names = sorted({k for r in records for k in r["bytes_by_class"]})
    by_class = {}
    for name in class_names:
        cls = _pred._CLASS_BY_NAME.get(name, AccessClass.STREAM)
        by_class[name] = (cls, col([float(r["bytes_by_class"].get(name, 0.0))
                                    for r in records]))

    # stream and non-stream classes are scored apart (row granularity),
    # as predictor.components_from_cost does
    t_memory = torch.zeros(n, dtype=torch.float64, device=dev)
    stream = {nm: a for nm, (c, a) in by_class.items()
              if c is AccessClass.STREAM}
    other = {nm: (c, a) for nm, (c, a) in by_class.items()
             if c is not AccessClass.STREAM}
    if stream:
        total = None
        for a in stream.values():       # Python's sum: 0 + a + b ...
            total = 0 + a if total is None else total + a
        t_memory = t_memory + _hbm.memory_time_batch(
            {AccessClass.STREAM: total}, hw, row_bytes=512.0, device=dev)
    for _, (cls, arr) in sorted(other.items()):
        t_memory = t_memory + _hbm.memory_time_batch(
            {cls: arr}, hw, row_bytes=gather_row_bytes, device=dev)

    flops = col([float(r["flops"]) for r in records])
    wire = col([float(r["collective_wire_bytes"]) for r in records])
    n_coll = col([float(r["n_collectives"]) for r in records])
    t_compute = flops / hw.peak_flops
    t_collective = wire / (hw.ici_bw * hw.ici_links) + n_coll * hw.ici_hop_latency
    t_step = torch.maximum(torch.maximum(t_compute, t_memory), t_collective)
    out = {k: v.cpu().numpy() for k, v in (
        ("t_compute", t_compute), ("t_memory", t_memory),
        ("t_collective", t_collective), ("t_step", t_step))}
    out["order"] = np.argsort(out["t_step"], kind="stable")
    return out


def _prediction_from(rec: Mapping, scores: dict, i: int,
                     gather_row_bytes: float) -> _pred.StepPrediction:
    comps = []
    for name, b in sorted(rec["bytes_by_class"].items()):
        cls = _pred._CLASS_BY_NAME.get(name, AccessClass.STREAM)
        row = gather_row_bytes if cls is not AccessClass.STREAM else 512.0
        comps.append(Traffic(cls, float(b), row_bytes=row, name=name))
    return _pred.StepPrediction(
        t_compute=float(scores["t_compute"][i]),
        t_memory=float(scores["t_memory"][i]),
        t_collective=float(scores["t_collective"][i]),
        memory_components=tuple(comps),
        flops=float(rec["flops"]),
        hbm_bytes=float(sum(rec["bytes_by_class"].values())),
        collective_wire_bytes=float(rec["collective_wire_bytes"]),
        collective_operand_bytes=float(rec["collective_operand_bytes"]),
        n_collectives=float(rec["n_collectives"]),
        collective_by_kind=dict(rec["collective_by_kind"]),
        xla_cost=dict(rec.get("xla_cost") or {}),
    )


def predict_record(rec: Mapping, hw=None, *,
                   device=None) -> _pred.StepPrediction:
    """The step prediction of one analysis record (``analyze_candidate``'s,
    or ``launch.dryrun.summarize`` of captured records: the collective
    keys default to none), scored by :func:`rank_records` on ``device``."""
    rec = {"collective_wire_bytes": 0.0, "collective_operand_bytes": 0.0,
           "n_collectives": 0.0, "collective_by_kind": {}, **rec}
    scores = rank_records([rec], hw, device=device)
    return _prediction_from(rec, scores, 0, 512.0)


def run_trial(cfg, shape, mesh, candidate: Candidate,
              hw: TpuParams | None = None,
              cache: HloAnalysisCache | None = None,
              device=None) -> TrialResult:
    """Capture one candidate and predict its step time (no execution)."""
    device = compat.resolve_device(device)
    rec = analyze_candidate(cfg, shape, mesh, candidate, cache, hw)
    return TrialResult(candidate=candidate,
                       prediction=predict_record(rec, hw, device=device),
                       compile_s=float(rec["compile_s"]),
                       memory_bytes=rec.get("memory_bytes"),
                       cached=bool(rec.get("cached")))


def _autotune(cfg, shape, mesh, candidates: Iterable[Candidate] | None = None,
              hw: TpuParams | None = None, *,
              cache: HloAnalysisCache | bool | None = True,
              gather_row_bytes: float = 512.0,
              device=None) -> AutotuneResults:
    """Rank candidates by predicted step time (ascending).

    Captures go through the on-disk analysis cache (``cache=False``
    disables it; an ``HloAnalysisCache`` sets its place); the scoring is
    one batched pass over all candidates on ``device`` (the card unless
    the caller passes ``device="cpu"``).  A candidate whose
    capture raises is a :class:`TrialFailure` on ``.failures``; if every
    candidate fails with the same error the failure is environmental and
    a ``RuntimeError`` is raised."""
    device = compat.resolve_device(device)
    if cache is True:
        cache = HloAnalysisCache()
    elif cache is False:
        cache = None
    cands = list(candidates) if candidates is not None \
        else default_candidates(shape.kind)
    kept, records, failures = [], [], []
    last_exc: Exception | None = None
    for c in cands:
        try:
            records.append(analyze_candidate(cfg, shape, mesh, c, cache, hw))
            kept.append(c)
        except Exception as e:  # noqa: BLE001 — a failed candidate is data
            failures.append(TrialFailure(c, type(e).__name__, str(e)))
            last_exc = e
            print(f"[autotune] {c.name} failed: {type(e).__name__}: {e}")
    if not records:
        distinct = {(f.error_type, f.error_msg) for f in failures}
        # one failing candidate proves nothing about the toolchain; only
        # an identical error across several is environmental
        if len(failures) > 1 and len(distinct) == 1:
            raise RuntimeError(
                f"autotune: all {len(failures)} candidates failed with the "
                f"same error (not candidate-specific): "
                f"{failures[0].error_type}: {failures[0].error_msg}"
            ) from last_exc
        return AutotuneResults([], failures)
    scores = rank_records(records, hw, gather_row_bytes=gather_row_bytes,
                          device=device)
    return AutotuneResults([
        TrialResult(candidate=kept[i],
                    prediction=_prediction_from(records[i], scores, int(i),
                                                gather_row_bytes),
                    compile_s=float(records[i]["compile_s"]),
                    memory_bytes=records[i].get("memory_bytes"),
                    cached=bool(records[i].get("cached")))
        for i in scores["order"]
    ], failures)
