"""``repro_torch.workload`` — whole-model estimation (port of
``repro.workload``).

The paper predicts one memory-bound kernel from its early-known memory
architecture; this package composes that prediction over an *entire
model step*:

* :mod:`~repro_torch.workload.walker` decomposes compiled HLO text into
  per-op :class:`OpRecord` s (the reference's records, field for field);
* :mod:`~repro_torch.workload.capture` records the port's own eager steps
  op by op under ``FakeTensorMode`` into the same records
  (:func:`walk_callable`, the port's counterpart of lowering to HLO);
* :mod:`~repro_torch.workload.compose` turns each op into a
  :class:`~repro_torch.api.Design` (the validation harness's class ->
  LSU-group mapping), scores all ops in one batched Eqs. 1-10 pass, and
  sums — phase totals equal the sum of per-op estimates by construction;
* :mod:`~repro_torch.workload.report` is the result family
  (:class:`ModelReport` / :class:`PhaseReport` / :class:`OpEstimate`);
* :mod:`~repro_torch.workload.steps` captures the shipped transformer
  stack's train / prefill / decode phases from fake tensors (loaded
  lazily);
* :mod:`~repro_torch.workload.sweep` makes model shape x sharding x
  hardware a streaming grid (:class:`ModelSweepPlan`, picklable + JSON).

The entry points live on :class:`repro_torch.Session` (``estimate_model``
/ ``plan_model`` / ``sweep_model``); this package is the implementation.
"""
from repro_torch.workload.capture import walk_callable
from repro_torch.workload.compose import (
    compose_model,
    compose_phase,
    designs_from_records,
)
from repro_torch.workload.report import ModelReport, OpEstimate, PhaseReport
from repro_torch.workload.sweep import (
    MODEL_AXES,
    MODEL_COLUMNS,
    ModelSweepPlan,
    ModelSweepReport,
)
from repro_torch.workload.walker import OP_CLASSES, OpRecord, walk_module

__all__ = [
    "OpRecord", "walk_module", "walk_callable", "OP_CLASSES",
    "OpEstimate", "PhaseReport", "ModelReport",
    "designs_from_records", "compose_phase", "compose_model",
    "MODEL_AXES", "MODEL_COLUMNS", "ModelSweepPlan", "ModelSweepReport",
    "PHASES", "phase_callable", "phase_records", "param_bytes",
]


def __getattr__(name):
    # steps needs the model zoo; load it only when one of its names is
    # actually requested.
    if name in ("PHASES", "phase_callable", "phase_records", "param_bytes"):
        from repro_torch.workload import steps

        return getattr(steps, name)
    raise AttributeError(
        f"module 'repro_torch.workload' has no attribute {name!r}")
