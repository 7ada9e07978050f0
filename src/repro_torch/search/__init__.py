"""``repro_torch.search`` — constrained and gradient-based design-space
exploration (port of ``repro.search``):

* :mod:`~repro_torch.search.envelope` — :class:`ResourceEnvelope` and the
  per-design resource-usage model compared against it;
* :mod:`~repro_torch.search.constraints` — the :class:`Constraint` algebra
  and the feasibility mask the streaming sweep applies before scoring;
* :mod:`~repro_torch.search.optimize` — ``Session.optimize``: screen,
  AdamW descent through ``torch.autograd`` on the relaxed estimator,
  discrete refinement and Pareto local search.

:mod:`repro_torch.hw.spec` imports the envelope module while
:mod:`repro_torch.hw` is still loading, so this ``__init__`` imports
nothing itself: every public name resolves lazily (PEP 562).
"""
import importlib

#: public name -> submodule that defines it (all served lazily).
_EXPORTS = {
    "ResourceEnvelope": "envelope",
    "USAGE_COLUMNS": "envelope",
    "usage_from_axes": "envelope",
    "usage_of_design": "envelope",
    "Constraint": "constraints",
    "EnvelopeConstraint": "constraints",
    "BoundConstraint": "constraints",
    "LambdaConstraint": "constraints",
    "AllOf": "constraints",
    "within": "constraints",
    "as_constraint": "constraints",
    "normalize_constraints": "constraints",
    "feasibility_mask": "constraints",
    "OptimizeReport": "optimize",
    "run_optimize": "optimize",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is not None:
        return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
