"""Mesh construction over ``torch.distributed``.

Port of ``repro.launch.mesh``.  Meshes are made by functions (never at
import), over the process group in force:

* :func:`make_production_mesh`: 16x16 ``("data","model")`` (one pod of 256
  ranks) or 2x16x16 ``("pod","data","model")`` (512).  Under ``torchrun``
  on real cards that is the NCCL group ``init_process_group("nccl")``
  makes; :func:`fake_world` gives the dry-run a fake group of any size on
  one host, the counterpart of the reference's 512 forced host devices.
* :func:`make_host_mesh`: the ranks that exist.
* :func:`threaded_ranks`: ``n`` ranks as threads of this process over one
  device (the CPU, or one card), each with its own rank, joined by an
  in-process group.  Tests and the card's smoke run execute sharded steps
  so; autograd's device threads are off while it runs, so each rank's
  backward runs on its own thread.

Every mesh has its runs of consecutive dims flattened (``init_mesh``), so
DTensor issues one collective over several dims where it would issue one
a dim.

A process group is process-global: :func:`fake_world` and
:func:`threaded_ranks` destroy the group they make before they return.
:func:`make_production_mesh` and :func:`make_host_mesh` leave the group
they are given to its owner.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

from repro_torch import compat

POD = (16, 16)
POD_AXES = ("data", "model")
MULTI_POD = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


def _device_type(device_type: str | None) -> str:
    """``None`` -> ``"cuda"``, raising without a card (as every entry point
    of the port does); a mesh on the CPU is asked for by name."""
    if device_type is not None:
        return device_type
    return compat.resolve_device(None).type


def init_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    group, which must hold exactly ``prod(shape)`` ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs a process group of "
            f"{n} ranks; none is initialized (torchrun, or fake_world for "
            f"a dry-run)")
    world = dist.get_world_size()
    if world != n:
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh needs {n} "
                           f"ranks; the process group has {world}")
    mesh = init_device_mesh(_device_type(device_type), shape,
                            mesh_dim_names=axes)
    # every run of two or more consecutive dims flattened, so a reduction
    # over several dims (a replicated leaf's gradient, a partial sum over
    # data and model) is one collective over their ranks, as the
    # reference's, where DTensor would issue one a dim
    for i in range(len(axes)):
        for j in range(i + 2, len(axes) + 1):
            mesh[tuple(axes[i:j])]._flatten()
    return mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    """16x16 = 256 ranks a pod; 2 pods = 512 ranks multi-pod."""
    if multi_pod:
        return init_mesh(MULTI_POD, MULTI_POD_AXES, device_type=device_type)
    return init_mesh(POD, POD_AXES, device_type=device_type)


def make_host_mesh(*, model_parallel: int | None = None,
                   device_type: str | None = None):
    """A ``("data","model")`` mesh over the ranks of the group in force."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    model = model_parallel or (2 if n % 2 == 0 and n > 1 else 1)
    return init_mesh((n // model, model), POD_AXES, device_type=device_type)


@contextlib.contextmanager
def fake_world(world_size: int):
    """A fake process group of ``world_size`` ranks (this process is rank
    0; every collective returns at once), destroyed on exit.  Under
    ``FakeTensorMode`` a mesh over it runs one rank's program at local
    shapes, launching nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", rank=0, world_size=world_size,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def threaded_ranks(world_size: int, fn, *args):
    """Run ``fn(rank, *args)`` on ``world_size`` threads, each a rank of an
    in-process group; returns the results by rank.  The first rank's
    exception to occur is raised after every thread has ended (a failing
    rank wakes the others' pending collectives, which then fail too)."""
    from torch.testing._internal.distributed.multi_threaded_pg import (
        ProcessLocalGroup, _install_threaded_pg, _uninstall_threaded_pg)
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    world = _install_threaded_pg()
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    store = dist.HashStore()
    results: list = [None] * world_size
    errors: list = []       # in the order they occurred

    def worker(rank):
        dist.init_process_group("threaded", rank=rank,
                                world_size=world_size, store=store)
        try:
            results[rank] = fn(rank, *args)
        except BaseException as exc:   # noqa: BLE001 — re-raised below
            errors.append(exc)
            ProcessLocalGroup.exception_handle(exc)
        finally:
            if dist.distributed_c10d._world is world:
                try:
                    dist.destroy_process_group()
                except AttributeError:
                    # some torch versions' destroy reads a field (``comms``)
                    # the threaded world lacks; the world is dropped whole
                    # below
                    pass

    try:
        threads = [threading.Thread(target=worker, args=(r,))
                   for r in range(world_size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
        ProcessLocalGroup.reset()
        _uninstall_threaded_pg()
    if errors:
        raise errors[0]
    return results
