"""Elastic rescale: resume a run on a different rank count.

Port of ``repro.runtime.elastic``.  Checkpoints are mesh-independent
(``checkpoint/manager.py`` gathers every DTensor leaf before it writes)
and data is step-addressable (``data/pipeline.py``), so resuming on
another mesh needs only the planner that maps an available rank count to
a mesh, and the restore that places each leaf by the new mesh's
placements.
"""
from __future__ import annotations

from repro_torch.checkpoint.manager import CheckpointManager


def plan_mesh_shape(n_chips: int, *, model_parallel: int = 16,
                    pod_size: int = 256) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """Largest usable (pod, data, model) mesh for ``n_chips`` available chips.

    Keeps the model axis fixed (sharding-rule compatibility) and scales the
    data axis; spills to a pod axis above ``pod_size`` chips.  Chips that do
    not fill a complete data row are left idle (returned shape may use fewer
    than ``n_chips``)."""
    model = min(model_parallel, n_chips)
    usable = (n_chips // model) * model
    if usable == 0:
        raise ValueError(f"need at least {model_parallel} chips")
    data_total = usable // model
    if usable <= pod_size:
        return (data_total, model), ("data", "model")
    pods = usable // pod_size
    data = pod_size // model
    return (pods, data, model), ("pod", "data", "model")


def resume_on_mesh(ckpt: CheckpointManager, like, mesh, shardings,
                   *, step: int | None = None):
    """Restore a checkpoint written on any mesh onto ``mesh``.

    ``shardings`` holds the placements of ``like``'s leaves on the new mesh
    (from ``launch/sharding.py``); each leaf is placed shard by shard."""
    return ckpt.restore(like, step=step, shardings=shardings, mesh=mesh)
