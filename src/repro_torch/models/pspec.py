"""Logical-axis sharding annotations for model code.

Port of ``repro.models.pspec``.  Model code tags activations with
*logical* axis names; the launcher installs a rules table mapping logical
names to mesh axes (``axis_rules``).  Outside a mesh the helpers are
no-ops, so the same model code runs on one card and on a mesh unchanged.

The counterpart of a ``PartitionSpec`` is a tuple with one entry per
tensor dimension: ``None``, a mesh-axis name, or a tuple of names.
:func:`placements` turns it into DTensor placements on a
``DeviceMesh``: a dimension over ``("pod", "data")`` is ``Shard(d)`` on
both mesh dimensions, split in mesh order (pod-major), as the reference's
``PartitionSpec`` splits it.

``shard(x, *names)`` redistributes a DTensor to the placements its
logical names give (the counterpart of ``with_sharding_constraint``).
With no mesh installed, or on a plain tensor, it returns ``x`` itself
after one thread-local lookup.
"""
from __future__ import annotations

import contextlib
import sys
import threading
from typing import Any, Sequence

import torch

_STATE = threading.local()

Spec = tuple   # one entry a tensor dimension: None | axis name | names


def _rules() -> dict[str, Any]:
    return getattr(_STATE, "rules", None) or {}


@contextlib.contextmanager
def axis_rules(mesh, rules: dict[str, Any]):
    """Install logical->mesh axis rules for the enclosed region (in this
    thread: each rank of a threaded mesh installs its own); ``mesh`` None
    installs none."""
    prev = (getattr(_STATE, "mesh", None), getattr(_STATE, "rules", None))
    _STATE.mesh, _STATE.rules = mesh, dict(rules)
    # under a mesh, a plain tensor met beside a DTensor (a mask, the RoPE
    # tables, a position) is whole on every rank: DTensor reads it as
    # replicated (a thread-local flag, restored on exit)
    flag = torch._C._get_dtensor_allow_implicit_replication()
    if mesh is not None:
        torch._C._set_dtensor_allow_implicit_replication(True)
    try:
        yield
    finally:
        _STATE.mesh, _STATE.rules = prev
        torch._C._set_dtensor_allow_implicit_replication(flag)


def mesh_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or any stand-in with
    ``mesh_dim_names`` and ``shape``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def axes_of(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axis_product(entry, sizes: dict[str, int]) -> int:
    n = 1
    for a in axes_of(entry):
        n *= sizes.get(a, 1)
    return n


def logical_to_spec(names: Sequence[str | None]) -> Spec:
    rules = _rules()
    return tuple(None if n is None else rules.get(n) for n in names)


def placements(mesh, spec: Sequence) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dimension that tensor dimension ``d`` names, ``Replicate()`` on
    the others.  A dimension over several axes is split in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = [a for a in axes_of(entry) if a in names]
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} shards two "
                                 f"dimensions in {tuple(spec)!r}")
            out[i] = Shard(d)
    return tuple(out)


def shard(x: torch.Tensor, *names: str | None) -> torch.Tensor:
    """Constrain ``x``'s sharding by logical axis names (no-op without a
    mesh or on a plain tensor)."""
    mesh = getattr(_STATE, "mesh", None)
    if mesh is None or not is_dtensor(x):
        return x
    if x.ndim != len(names):
        raise ValueError(f"rank {x.ndim} vs {len(names)} logical names")
    spec = logical_to_spec(names)
    # Keep the assignment when the dim is at least the axis size (sharded
    # unevenly, as GSPMD pads: a 92553 vocab over 16 ranks); drop it only
    # when the dim is smaller than the axis.
    sizes = mesh_sizes(mesh)
    fixed = tuple(s if s is None or dim >= axis_product(s, sizes) else None
                  for dim, s in zip(x.shape, spec))
    want = placements(mesh, fixed)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


_DTENSOR = None


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor: False at once while
    ``torch.distributed.tensor`` was never imported (no DTensor exists)."""
    global _DTENSOR
    if _DTENSOR is None:
        if "torch.distributed.tensor" not in sys.modules:
            return False
        from torch.distributed.tensor import DTensor
        _DTENSOR = DTensor
    return isinstance(x, _DTENSOR)


def local_extent(shape: Sequence[int], mesh, place: Sequence
                 ) -> tuple[list[int], list[int]]:
    """(this rank's extent, the global index of its first element) along
    each dim of a tensor of ``shape`` split by ``place`` (DTensor's
    chunking: each split cuts the current extent into chunks of
    ceil(extent / ranks)).  Plain integers from the mesh's coordinate, so
    it runs under a fake mode."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    size, offset = list(shape), [0] * len(shape)
    for i, p in enumerate(place):
        if isinstance(p, Shard):
            d = p.dim % len(shape)
            chunk = -(-size[d] // mesh.size(i))
            start = min(chunk * coord[i], size[d])
            offset[d] += start
            size[d] = min(chunk, size[d] - start)
    return size, offset


def settled(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with its partial placements reduced by an all-reduce
    (a partial max left for a later split would need a reduce-scatter of
    a max, which the threaded group lacks); anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Partial, Replicate
    if not any(isinstance(p, Partial) for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if isinstance(p, Partial) else p for p in x.placements))


def gathered_for(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A weight DTensor ``w`` taken whole on every mesh dim on which the
    activation ``x`` splits its batch (dim 0) and ``w`` is split too: the
    weight's FSDP shards are gathered before the product, as XLA gathers
    an FSDP weight.  DTensor's cheapest move would instead carry a small
    activation (a decode step's one row a rank) onto the weight's split:
    every rank then holds the whole batch's rows, and a product over the
    weight's split rows is a partial sum to all-reduce.  A weight whose
    gradient is taken is left as it is: the product's own rule gathers it
    for a training step's many rows, and its backward leaves the gradient
    partial for the train step's one f32 reduction, where the gather's
    backward would reduce-scatter it at once in the activation dtype.
    Anything else as it is."""
    if not (is_dtensor(w) and is_dtensor(x)) or (
            w.requires_grad and torch.is_grad_enabled()):
        return w
    from torch.distributed.tensor import Replicate, Shard
    want = tuple(Replicate() if px == Shard(0) and isinstance(pw, Shard)
                 else pw for px, pw in zip(x.placements, w.placements))
    return w if want == tuple(w.placements) else \
        w.redistribute(w.device_mesh, want)


def whole_last_dim(x: torch.Tensor) -> torch.Tensor:
    """A DTensor taken whole on its last dim and reduced where partial
    (a norm over it, an argmax along it: DTensor's decomposed norm fails
    on a split or partial dim, and its argmax over a split one reads each
    rank's offset from the device); anything else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    last = x.ndim - 1
    want = tuple(p if isinstance(p, Shard) and p.dim % x.ndim != last
                 else Replicate() for p in x.placements)
    return x if want == tuple(x.placements) else \
        x.redistribute(x.device_mesh, want)


def even_placements(x, place: Sequence) -> tuple:
    """``place`` with every ``Shard`` that does not split ``x``'s
    dimension evenly replaced by ``Replicate`` (a local region needs even
    shards: its outputs' global shapes are inferred from them)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = x.device_mesh
    out, counts = [], {}
    for i, p in enumerate(place):
        if isinstance(p, Shard):
            n = counts.get(p.dim, 1) * mesh.size(i)
            if x.shape[p.dim] % n:
                p = Replicate()
            else:
                counts[p.dim] = n
        out.append(p)
    return tuple(out)


def even(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with every uneven split taken whole (``even_placements``;
    DTensor cannot merge an unevenly split dim into another, as a head dim
    of 28 over 16 ranks into the model width); anything else as it is."""
    if not is_dtensor(x):
        return x
    want = even_placements(x, x.placements)
    return x if want == tuple(x.placements) else \
        x.redistribute(x.device_mesh, want)


def local_call(fn, args: Sequence, place: Sequence, out_place=None, *,
               n_out: int = 1):
    """``fn`` run on this rank's shards through DTensor's ``local_map``:
    every DTensor of ``args`` is redistributed to ``place`` (one placement
    tuple for all, or a list with one entry an argument) and read
    locally; each of the ``n_out`` tensors ``fn`` returns becomes a
    DTensor of ``out_place`` (default: ``place``; a list: one placement
    tuple an output), its shards even.  An input whole on a mesh dim
    where an output is split gets a part of its gradient on each rank: its
    gradient placement there is a partial sum.  The sites that use it name
    why DTensor cannot run the op itself; with no DTensor among ``args``
    it is ``fn(*args)``."""
    from torch.distributed.tensor import DTensor
    first = next((a for a in args if isinstance(a, DTensor)), None)
    if first is None:
        return fn(*args)
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    per_arg = isinstance(place, list)
    if isinstance(out_place, list):
        outs = [tuple(o) for o in out_place]
        n_out = len(outs)
    else:
        outs = [tuple(out_place if out_place is not None else place)] * n_out
    split = [any(isinstance(o[i], Shard) for o in outs)
             for i in range(len(outs[0]))]
    ins, grads = [], []
    for i, a in enumerate(args):
        p = tuple(place[i] if per_arg else place) \
            if isinstance(a, DTensor) else None
        ins.append(p)
        grads.append(p and tuple(
            Partial() if isinstance(pi, Replicate) and cut else pi
            for pi, cut in zip(p, split)))
    # one output's placements are a list (a tuple holds one an output)
    return local_map(fn, out_placements=tuple(outs) if n_out > 1
                     else list(outs[0]),
                     in_placements=tuple(ins),
                     in_grad_placements=tuple(grads),
                     device_mesh=first.device_mesh,
                     redistribute_inputs=True)(*args)


def vocab_pick(table: torch.Tensor, ids: torch.Tensor, dim: int, fn):
    """``fn(table, ids, inside)`` on this rank's shards, where ``table``'s
    dim ``dim`` (a vocabulary) may be split: each rank looks up the ids
    that fall in its rows (``fn`` gets them shifted to its rows and
    clamped, and ``inside``, the mask of those that fall there; it zeroes
    the others) and the lookups add up across the split (``Partial``).
    The hand-written counterpart of DTensor's vocabulary-parallel lookup,
    whose per-call mask lives on a placement object that ranks running as
    threads share.  A table indexed on its first dim (an embedding) keeps
    an even split of its columns: each rank looks up every id (the ids
    gathered) at its own columns, as XLA's partitioned lookup does, and the
    rows come out split over the columns, for the caller's batch tag to
    move (an all-to-all), where taking the table whole would gather a
    vocabulary shard's every column on each rank (3 x 136 MB at qwen2-7b's
    full width, the decode's peak); its other dims are taken whole, and
    there the ids keep their batch split.  A table whose rows match the
    ids' (logits, ``dim`` last) keeps the batch split both share."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, (Replicate(),) * mesh.ndim,
                                 run_check=False)
    columns = 1
    for i, pt in enumerate(table.placements):
        if pt == Shard(1):
            columns *= mesh.size(i)
    by_columns = not dim and table.ndim == 2 \
        and table.shape[1] % columns == 0
    tp, ip, op = [], [], []
    for pt, pi in zip(table.placements, ids.placements):
        batch_ids = isinstance(pi, Shard) and pi.dim == 0
        if isinstance(pt, Shard) and pt.dim == dim:
            tp.append(pt)
            ip.append(Replicate())
            op.append(Partial())
        elif by_columns and pt == Shard(1):
            tp.append(pt)            # this rank's columns of every id's row
            ip.append(Replicate())
            op.append(Shard(ids.ndim))
        elif dim and pt == Shard(0) and batch_ids:
            tp.append(pt)            # rows of the table and of the ids
            ip.append(pi)
            op.append(pi)
        else:
            tp.append(Replicate())
            keep = batch_ids and not dim      # the lookup's rows are the ids'
            ip.append(pi if keep else Replicate())
            op.append(pi if keep else Replicate())
    tp, ip, op = tuple(tp), tuple(ip), tuple(op)
    _, offset = local_extent(table.shape, mesh, tp)

    def local(t, i):
        n = t.shape[dim]
        at = i.long() - offset[dim]
        inside = (at >= 0) & (at < n)
        return fn(t, at.clamp(0, max(n - 1, 0)), inside)
    return local_call(local, (table, ids), [tp, ip], op)


def rule_axis_size(name: str) -> int:
    """Product of mesh-axis sizes a logical axis maps to (1 without mesh)."""
    mesh = getattr(_STATE, "mesh", None)
    if mesh is None:
        return 1
    r = _rules().get(name)
    if r is None:
        return 1
    return axis_product(r, mesh_sizes(mesh))
