"""Atomic, optionally asynchronous checkpointing of tensor trees.

Port of ``repro.checkpoint.manager``, with the same layout::

    <dir>/step_<N:08d>/{manifest.json, arr_<k>.npy}

* **Atomic**: written to ``step_<N>.tmp``, then renamed; ``all_steps`` and
  ``latest_step`` scan only finished directories, so a crash mid-save never
  corrupts the latest checkpoint.
* **Async**: ``save(..., blocking=False)`` copies every leaf to the host
  first, then writes on a background thread, so the loop keeps stepping
  (and may update its tensors in place) while the files are written.
* ``keep_last`` finished checkpoints are kept.

A tree is the port's own nesting of dicts with tensor leaves (a model's
state dict beside the optimizer state); a leaf's name is its keys joined
by ``/``.

On a mesh the checkpoint stays mesh-independent: ``save`` gathers every
DTensor leaf to the whole tensor (a collective: every rank calls it) and
rank 0 alone writes; ``restore(..., shardings=, mesh=)`` places each
leaf by the new mesh's placements (``launch/sharding.py``), which is how
a run resumes on another mesh (``runtime/elastic.py``).  The manifest lists every leaf's name, dtype and shape.  numpy
has no bfloat16, so a bf16 leaf is stored as its ``uint16`` view with
``"bfloat16"`` in the manifest, and restored bit for bit.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

#: dtypes stored as the bits of an unsigned integer view.
_VIEWS = {torch.bfloat16: torch.uint16}


def _flatten(tree: Any, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if not isinstance(tree, dict):
        raise TypeError(f"checkpoint trees hold dicts and tensors, not "
                        f"{type(tree).__name__} (at {prefix!r})")
    out = []
    for key, val in tree.items():
        out += _flatten(val, f"{prefix}/{key}" if prefix else str(key))
    return out


def _unflatten(like: Any, leaves: dict[str, torch.Tensor], prefix: str = ""):
    if isinstance(like, torch.Tensor):
        return leaves[prefix]
    return {key: _unflatten(val, leaves,
                            f"{prefix}/{key}" if prefix else str(key))
            for key, val in like.items()}


def _writer() -> bool:
    """Whether this process (or thread rank) writes: rank 0 of the group in
    force, or the only one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` (a copy even of a CPU tensor: the caller may
    write into ``t`` while a thread writes the file); a DTensor gathered
    whole first."""
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    t = t.detach().to("cpu", copy=True)
    if t.dtype in _VIEWS:
        t = t.view(_VIEWS[t.dtype])
    return t.numpy()


class CheckpointManager:
    def __init__(self, directory: str, *, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: Any, *, blocking: bool = True) -> None:
        """Write ``tree`` as step ``step``; with ``blocking=False`` the leaves
        are copied to the host here and written on a thread (``wait``).  On
        a group of several ranks, rank 0 writes and a blocking save returns
        on every rank once the write is done."""
        self.wait()
        leaves = [(name, _dtype_name(t.dtype), _to_host(t))
                  for name, t in _flatten(tree)]
        if not _writer():
            pass
        elif blocking:
            self._write(step, leaves)
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, leaves), daemon=True)
            self._thread.start()
        if blocking:
            self.barrier()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def barrier(self) -> None:
        """Wait for rank 0's write to finish on every rank of the group in
        force (nothing without one)."""
        self.wait()
        if dist.is_initialized() and dist.get_world_size() > 1:
            dist.barrier()

    def _write(self, step: int, leaves: list) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for i, (_, _, arr) in enumerate(leaves):
            np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)
        manifest = {
            "step": step,
            "n_leaves": len(leaves),
            "leaves": [{"name": name, "dtype": dtype, "shape": list(arr.shape)}
                       for name, dtype, arr in leaves],
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._cleanup()

    def _cleanup(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, *, step: int | None = None,
                device=None, shardings: Any = None,
                mesh=None) -> tuple[Any, int]:
        """Restore step ``step`` (default: the latest) into the structure of
        ``like``: each leaf at the ``like`` leaf's dtype, on its device (or
        on ``device`` where given).  With ``shardings`` (placements in
        ``like``'s structure) and ``mesh``, each leaf becomes a DTensor of
        its placements on ``mesh`` (every rank reads the whole leaf and
        keeps its shard).  Returns ``(tree, step)``."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            stored = {leaf["name"]: (i, leaf) for i, leaf in
                      enumerate(json.load(f)["leaves"])}
        out = {}
        for name, ref in _flatten(like):
            if name not in stored:
                raise KeyError(f"checkpoint step {step} has no leaf {name!r}")
            i, leaf = stored[name]
            t = torch.from_numpy(np.load(os.path.join(d, f"arr_{i}.npy")))
            dtype = getattr(torch, leaf["dtype"])
            if dtype in _VIEWS:
                t = t.view(dtype)
            if list(t.shape) != list(ref.shape):
                raise ValueError(f"{name}: stored shape {list(t.shape)}, "
                                 f"expected {list(ref.shape)}")
            out[name] = t.to(device=ref.device if device is None else device,
                             dtype=ref.dtype)
        tree = _unflatten(like, out)
        if shardings is not None:
            from repro_torch.launch.sharding import distribute_tree
            tree = distribute_tree(tree, shardings, mesh)
        return tree, step
