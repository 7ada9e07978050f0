"""Capture the port's own eager steps into per-op traffic records.

The reference compiles each model phase to XLA HLO and walks it
(:mod:`repro_torch.workload.walker`).  The port has no XLA, so it records
what its own eager step runs: :func:`walk_callable` runs a callable under
``FakeTensorMode`` (shapes and dtypes only: no parameter or activation is
allocated and nothing is launched) inside a ``TorchDispatchMode`` that
makes one :class:`OpRecord` per ATen op from the op's input and output
shapes and dtypes.  Autograd's backward ops pass through the same
dispatch, so a callable that takes ``torch.autograd.grad`` records its
backward (and a ``torch.utils.checkpoint`` recompute) with no separate
tracer.

Each op is charged by the rules of ``core/hlo_counter.py``
(``Analyzer._instr_cost``), so the access classes mean the same thing:

======================================  =======  ===============  =======
ATen op                                 class    bytes            FLOPs
======================================  =======  ===============  =======
``mm``/``bmm``/``addmm``/``baddbmm``    stream   reads + result   2·M·N·K
``embedding``/``index_select``/         gather   2 × result       —
``gather``/``index``
``scatter*``/``index_put``/             gather   3 × update       —
``index_add``, ``embedding`` backward
a slice written in place (``copy_``     stream   2 × update, as   —
into a view, ``index_copy``,                     dynamic-update-
``*_scatter``)                                   slice
``clone``/``_to_copy``/``copy_`` of a   strided  reads + result   —
non-contiguous input, ``cat``,
``stack``, ``constant_pad_nd``,
``flip``, ``sort``, ``topk``,
``slice``/``select_backward``
views (``view``, ``permute``,           free     —                —
``expand``, ``slice``, ``t``, ...)
fills (``zeros_like``, ``fill_``, ...)  stream   result           —
elementwise ops, reductions and every   stream   reads + result   one an
other op                                                          element
======================================  =======  ===============  =======

"reads" are the bytes of every tensor argument; the FLOPs of an elementwise
op count its result's elements, of a reduction its input's, and the ops
that ``hlo_counter`` counts as transcendental (exp, log, tanh, pow,
sigmoid, expm1, log1p, erf, and the silu/gelu/softmax ops built on them)
count their elements as ``transcendentals`` too.

Where a captured phase differs from the reference's walk of fused HLO:

* eager PyTorch runs every op, so a captured phase is charged op by op:
  each elementwise op reads its inputs and writes its result where XLA
  fuses a chain into one pass (``fused`` applies to HLO text only), while
  a view is free where XLA may materialize a transpose or copy.  The
  totals differ either way (``tools/workload_bytes.py`` prints both by
  class for a toy config);
* the port unrolls its layers, so every record has ``trips`` 1 and
  ``by_layer`` has one row per module, where the reference has one scan
  scope with ``trips`` = L.

Every record gets a scope: the module path (``layers.3.attn``,
``layers.3.mlp.wo``) of the innermost frame on the Python call stack whose
first argument is a module among the callable's arguments (the model
functions take ``(p, ...)``).  An op of the backward takes the scope of
the forward op that made the autograd node it runs in; a recompute runs
the forward's functions again and takes their scope.  Ops outside every
module take the callable's ``__name__``.

A kernel wrapper reached under capture raises (``compat.check_real``):
the phases of :mod:`repro_torch.workload.steps` run with
``use_kernels=False``.

On a mesh (a step whose tensors are DTensors, ``launch/dryrun.py``) the
recorder sits beneath DTensor: an op on DTensors passes through to
DTensor's dispatch, which runs it on this rank's shards, and those local
ops are recorded at their local shapes.  The collectives DTensor issues
(``_c10d_functional``, and ``_dtensor.shard_dim_alltoall`` on a card's
mesh) are charged by ``core/hlo.py``'s rules (``_collective_from``):
all-gather, reduce-scatter, all-reduce and all-to-all, the group size
from the op's group, operand and wire bytes from the result;
``wait_tensor`` is free.  On a CPU mesh DTensor runs an all-to-all as an
all-gather and a chunk (``shard_dim_alltoall``'s fallback): inside that
frame the all-gather is recorded as the all-to-all it stands for, at the
chunk's bytes, and the chunk's copy is not recorded, so both meshes
record one all-to-all.  DTensor's own shape propagation (global-shape
fakes, on a cache miss) is not recorded.  Captures with no DTensor are
unchanged.

:func:`capture_call` also follows memory (:class:`CallMemory`): every
storage a recorded op creates (at local shapes on a mesh) is live from
its birth to its last reference (a weak reference's callback: views
share their storage and count once; autograd's saved tensors and a
remat's recompute live as long as eager execution keeps them), and the
peak of the live bytes over the call is kept beside the argument,
output and alias bytes.  The frames the scopes are read from keep no
reference to a local (Python 3.12 keeps a frame's ``f_locals`` snapshot
until the frame is read again; the snapshot is emptied after each read).
"""
from __future__ import annotations

import dataclasses
import functools
import os
import sys
import weakref

import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode, is_fake
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch.core.hlo import _collective_from
from repro_torch.workload.walker import OpRecord

__all__ = ["walk_callable", "capture_call", "CallMemory"]

_MATMUL = {"mm", "bmm", "addmm", "baddbmm"}
_GATHER = {"embedding", "index_select", "gather", "index"}
#: scatters and their update argument's position
_SCATTER = {"scatter": 3, "scatter_": 3, "scatter_add": 3, "scatter_add_": 3,
            "scatter_reduce": 3, "scatter_reduce_": 3, "index_put": 2,
            "index_put_": 2, "_index_put_impl_": 2, "index_add": 3,
            "index_add_": 3, "embedding_dense_backward": 0}
#: slice writes and their update argument's position
_SLICE_WRITE = {"index_copy": 3, "index_copy_": 3, "slice_scatter": 1,
                "select_scatter": 1, "as_strided_scatter": 1}
_STRIDED = {"cat", "stack", "constant_pad_nd", "flip", "roll", "sort",
            "topk", "slice_backward", "select_backward"}
_COPIES = {"clone", "_to_copy", "copy_"}
_FILLS = {"zeros", "ones", "full", "arange", "scalar_tensor", "zeros_like",
          "ones_like", "full_like", "new_zeros", "new_ones", "new_full",
          "fill", "fill_", "zero_"}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "prod", "var", "std",
           "var_mean", "std_mean", "logsumexp", "norm", "linalg_vector_norm",
           "argmax", "argmin", "all", "any", "cumsum", "cumprod",
           "_softmax", "_log_softmax", "_softmax_backward_data",
           "_log_softmax_backward_data", "_fused_rms_norm",
           "native_layer_norm", "native_layer_norm_backward"}
_TRANSCENDENTAL = {"exp", "log", "tanh", "pow", "sigmoid", "expm1", "log1p",
                   "erf", "silu", "gelu", "silu_backward", "gelu_backward",
                   "_softmax", "_log_softmax"}

#: ``_c10d_functional`` collectives: (HLO kind, the group argument's index)
_COLLECTIVES = {"all_gather_into_tensor": ("all-gather", 2),
                "reduce_scatter_tensor": ("reduce-scatter", 3),
                "all_reduce": ("all-reduce", 2),
                "all_to_all_single": ("all-to-all", 3),
                "broadcast": ("collective-broadcast", 2)}
#: DTensor's all-to-all on a card's mesh: (kind, the group argument's index)
_DTENSOR_ALLTOALL = ("all-to-all", 3)
_FREE_COLLECTIVE = {"wait_tensor"}
#: DTensor's sharding propagation: its fakes at global shapes.
_SHARDING_PROP = os.path.join("distributed", "tensor", "_sharding_prop.py")
#: DTensor's all-to-all, which a CPU mesh runs as an all-gather and a chunk
_COLLECTIVE_UTILS = os.path.join("distributed", "tensor",
                                 "_collective_utils.py")
_ALLTOALL = "shard_dim_alltoall"

#: Frames of the autograd engine: the backward's Python stack ends here.
_AUTOGRAD_DIR = os.path.dirname(torch.autograd.__file__) + os.sep
#: Where a forward op leaves its scope for the backward.
_SCOPE_KEY = "repro_torch.scope"


@functools.lru_cache(maxsize=None)
def _is_view(func) -> bool:
    """An ATen op whose result aliases an input without writing it."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _nbytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _charge(name: str, func, args, kwargs, outs: list[torch.Tensor]
            ) -> tuple[str, str, float, float, float] | None:
    """(op class, access class, bytes, flops, transcendentals) of one op
    with tensor results ``outs``, or None where it moves nothing."""
    if _is_view(func) or name.startswith("empty") \
            or name in ("new_empty", "new_empty_strided", "lift_fresh"):
        return None
    result = sum(map(_nbytes, outs))
    n_out = float(sum(t.numel() for t in outs))
    ins = _tensors((args, kwargs))
    reads = sum(map(_nbytes, ins))
    if name in _MATMUL:
        a = args[1] if name in ("addmm", "baddbmm") else args[0]
        return "matmul", "stream", reads + result, \
            2.0 * outs[0].numel() * a.shape[-1], 0.0
    if name in _GATHER:
        return "gather", "gather", 2.0 * result, 0.0, 0.0
    if name in _SCATTER:
        upd = args[_SCATTER[name]] if len(args) > _SCATTER[name] else None
        if isinstance(upd, (list, tuple)):      # index_put's values
            upd = None
        b = _nbytes(upd) if isinstance(upd, torch.Tensor) else result
        return "gather", "gather", 3.0 * b, 0.0, 0.0
    if name in _SLICE_WRITE:
        upd = args[_SLICE_WRITE[name]]
        return "dynamic", "stream", 2.0 * _nbytes(upd), 0.0, 0.0
    if name == "copy_" and args[0]._base is not None:
        # a slice of a larger tensor written in place (decode caches)
        return "dynamic", "stream", 2.0 * _nbytes(args[0]), 0.0, 0.0
    if name in _COPIES:
        src = args[1] if name == "copy_" else args[0]
        if not src.is_contiguous():
            return "layout", "strided", reads + result, 0.0, 0.0
        return "elementwise", "stream", reads + result, 0.0, 0.0
    if name in _STRIDED:
        return "layout", "strided", reads + result, 0.0, 0.0
    if name in _FILLS:
        return "other", "stream", result, 0.0, 0.0
    trans = n_out if name in _TRANSCENDENTAL else 0.0
    if name in _REDUCE:
        return "reduce", "stream", reads + result, \
            float(ins[0].numel()) if ins else n_out, trans
    if torch.Tag.pointwise in func.tags:
        return "elementwise", "stream", reads + result, n_out, trans
    return "other", "stream", reads + result, 0.0, trans


class _LiveBytes:
    """Bytes of the live storages a call created: each is counted from
    the op that made it to the callback of a weak reference to it (views
    share their storage and count once).  The arguments' storages are
    known from the start and not counted."""

    def __init__(self):
        self.args: dict[int, torch.UntypedStorage] = {}
        self._born: dict[int, weakref.ref] = {}
        self.live = 0.0
        self.peak = 0.0

    def argument(self, t: torch.Tensor) -> None:
        st = _local(t).untyped_storage()
        self.args[id(st)] = st        # held: alive for the call anyway

    def born(self, t: torch.Tensor, cap: float | None = None) -> None:
        """Count ``t``'s storage from now if it is new (at most ``cap``
        bytes)."""
        st = t.untyped_storage()
        key = id(st)
        if key in self.args or key in self._born:
            return
        n = float(st.nbytes())
        if cap is not None:
            n = min(n, cap)
        self._born[key] = weakref.ref(
            st, lambda _, key=key, n=n: self._died(key, n))
        self.live += n
        if self.live > self.peak:
            self.peak = self.live

    def _died(self, key: int, n: float) -> None:
        self._born.pop(key, None)
        self.live -= n


@dataclasses.dataclass(frozen=True)
class CallMemory:
    """One call's memory at local shapes, in the reference's
    ``memory_analysis`` terms: the arguments' storages, the storages of
    what it returns (a returned module: its parameters and buffers), the
    part of those that are arguments (updated in place and returned: the
    reference's donated buffers), and the peak of the live bytes of the
    storages the call created."""
    argument_bytes: float
    output_bytes: float
    alias_bytes: float
    created_peak_bytes: float

    @property
    def temp_bytes(self) -> float:
        """The created peak above the outputs the call created."""
        return self.created_peak_bytes - (self.output_bytes
                                          - self.alias_bytes)

    @property
    def total_bytes(self) -> float:
        """argument + output + temp - alias: the arguments and the created
        peak, the eager peak of the call."""
        return (self.argument_bytes + self.output_bytes + self.temp_bytes
                - self.alias_bytes)


def _storage_bytes(tensors) -> dict[int, float]:
    """{storage id: bytes} of ``tensors`` (DTensors by their local shard),
    each storage once."""
    out: dict[int, float] = {}
    for t in tensors:
        st = _local(t).untyped_storage()
        out.setdefault(id(st), float(st.nbytes()))
    return out


def _leaf_tensors(tree) -> list[torch.Tensor]:
    """The tensors of a tree whose leaves may be modules (their
    parameters and buffers)."""
    out = []
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, torch.Tensor):
            out.append(leaf)
        elif isinstance(leaf, nn.Module):
            out += list(leaf.parameters()) + list(leaf.buffers())
    return out


class _Recorder(TorchDispatchMode):
    """One :class:`OpRecord` per ATen op, scoped by the module stack (and
    with ``memory`` the live bytes of the storages the ops create)."""

    def __init__(self, names: dict[int, str], root: str,
                 beneath_dtensor: bool = False, memory: bool = False):
        super().__init__()
        self.names = names
        self.root = root
        self.beneath_dtensor = beneath_dtensor
        if beneath_dtensor:
            from torch.distributed.tensor import DTensor
            self._dtensor = DTensor
        self.memory = _LiveBytes() if memory else None
        self._chunk: float | None = None     # an all-to-all's result bytes
        self.records: list[OpRecord] = []
        self._pending: list[tuple[list, str]] = []
        self._last_backward = root

    def _frame_scope(self, in_backward: bool) -> str | None:
        """The module path of the innermost frame whose first argument is
        a known module; None when the stack holds none (in the backward,
        none before the autograd engine's frames)."""
        frame = sys._getframe(1).f_back
        while frame is not None:
            code = frame.f_code
            if in_backward and code.co_filename.startswith(_AUTOGRAD_DIR):
                return None
            if code.co_argcount:
                local = frame.f_locals
                hit = self.names.get(id(local.get(code.co_varnames[0])))
                if type(local) is dict:
                    # a snapshot the frame keeps until it is read again:
                    # emptied, so it holds no local past its last use
                    local.clear()
                if hit is not None and hit != self.root:
                    return hit
            frame = frame.f_back
        return None

    def _tag_pending(self) -> None:
        """Leave each forward op's scope on the autograd node that autograd
        attached to its outputs once the op returned.  The list is taken
        first: reading a view's ``grad_fn`` may dispatch again.  The
        outputs are held weakly (a strong hold would keep a temporary past
        its last use) and a dead one is skipped."""
        pending, self._pending = self._pending, []
        for outs, scope in pending:
            for ref in outs:
                t = ref()
                if t is None:
                    continue
                node = t.grad_fn
                if node is not None and _SCOPE_KEY not in node.metadata:
                    node.metadata[_SCOPE_KEY] = scope

    def _dtensor_frame(self) -> str | None:
        """``"prop"`` inside DTensor's sharding propagation, ``"alltoall"``
        inside its all-to-all (a CPU mesh's all-gather and chunk), else
        None."""
        frame = sys._getframe(2)
        while frame is not None:
            code = frame.f_code
            if code.co_filename.endswith(_SHARDING_PROP):
                return "prop"
            if code.co_name == _ALLTOALL and \
                    code.co_filename.endswith(_COLLECTIVE_UTILS):
                return "alltoall"
            frame = frame.f_back
        return None

    def _collective(self, kind: str, group, result: float) -> None:
        from torch.distributed.distributed_c10d import _resolve_process_group
        g = _resolve_process_group(group).size()
        operand, wire = _collective_from(kind, result, g)
        scope = self._frame_scope(
            in_backward=torch._C._current_autograd_node() is not None) \
            or self.root
        self.records.append(OpRecord(
            path=f"{scope}/{kind}.{len(self.records)}", opcode=kind,
            op_class="collective", scope=scope, trips=1.0, flops=0.0,
            bytes_by_class={}, collective_operand_bytes=operand,
            collective_wire_bytes=wire, n_collectives=1.0))

    def _born(self, outs, cap: float | None = None) -> None:
        if self.memory is not None:
            for t in outs:
                self.memory.born(t, cap)

    def _beneath_dtensor(self, func, args, outs) -> bool:
        """Record a collective, or pass over DTensor's propagation and
        the chunk of a CPU mesh's all-to-all; True where the op is done
        with."""
        ns = func.namespace
        name = func.overloadpacket.__name__
        where = self._dtensor_frame()
        if where == "prop":
            return True
        if where != "alltoall":
            self._chunk = None
        result = sum(map(_nbytes, outs))
        if ns == "_c10d_functional":
            if name in _COLLECTIVES:
                kind, at = _COLLECTIVES[name]
                if where == "alltoall" and kind == "all-gather":
                    # the fallback's gather stands for the all-to-all:
                    # its result is the chunk the rank keeps
                    from torch.distributed.distributed_c10d import \
                        _resolve_process_group
                    result /= _resolve_process_group(args[at]).size()
                    kind, self._chunk = "all-to-all", result
                self._born(outs, self._chunk)
                self._collective(kind, args[at], result)
            return True
        if ns == "_dtensor" and name == _ALLTOALL:
            self._born(outs)
            self._collective(_DTENSOR_ALLTOALL[0],
                             args[_DTENSOR_ALLTOALL[1]], result)
            return True
        if where == "alltoall":
            # the fallback's chunk, not recorded; its buffers are held to
            # the chunk's bytes, as the card's all-to-all (chunk copies,
            # outputs, their concatenation) holds three of them
            self._born(outs, self._chunk)
            return True
        return False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.beneath_dtensor and any(issubclass(t, self._dtensor)
                                        for t in types):
            return NotImplemented       # DTensor runs it on local shards
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if not outs:        # metadata queries (a fake tensor's device, ...)
            return out
        if self.beneath_dtensor and self._beneath_dtensor(func, args, outs):
            return out
        self._born(outs)
        if self._pending:
            self._tag_pending()
        name = func.overloadpacket.__name__
        charged = _charge(name, func, args, kwargs, outs)
        node = torch._C._current_autograd_node()
        scope = self._frame_scope(in_backward=node is not None)
        if node is None:
            scope = scope or self.root
            if torch.is_grad_enabled():
                self._pending.append(([weakref.ref(t) for t in outs],
                                      scope))
        elif scope is None:
            scope = node.metadata.get(_SCOPE_KEY, self._last_backward)
            self._last_backward = scope
        if charged is not None:
            op_class, cls, nbytes, flops, trans = charged
            self.records.append(OpRecord(
                path=f"{scope}/{name}.{len(self.records)}", opcode=name,
                op_class=op_class, scope=scope, trips=1.0,
                flops=float(flops),
                bytes_by_class={cls: float(nbytes)} if nbytes else {},
                transcendentals=float(trans)))
        return out


def fake_mode() -> FakeTensorMode:
    """The capture's fake mode: real tensors met inside become fakes, and
    an op without a fake implementation raises rather than running its
    real kernel on zero-filled inputs (which would allocate them)."""
    return FakeTensorMode(allow_non_fake_inputs=True,
                          allow_fallback_kernels=False)


def _module_names(modules, root: str) -> dict[int, str]:
    """id -> module path of every module under ``modules`` (alive for the
    capture, so no other object shares an id); a root is ``root``."""
    names: dict[int, str] = {}
    for module in modules:
        for path, mod in module.named_modules():
            names.setdefault(id(mod), path or root)
    return names


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard; any other tensor itself."""
    return getattr(t, "_local_tensor", t)


def _has_dtensor(leaves) -> bool:
    if "torch.distributed.tensor" not in sys.modules:
        return False
    from torch.distributed.tensor import DTensor
    return any(isinstance(t, DTensor) for t in leaves)


def _capture(fn, args, memory: bool):
    modules = [a for a in args if isinstance(a, nn.Module)]
    leaves = _tensors(args) + [p for m in modules for p in m.parameters()]
    mode = next((_local(t).fake_mode for t in leaves
                 if is_fake(_local(t))), None) or fake_mode()
    fake_args = tree_map(
        lambda t: t if not isinstance(t, torch.Tensor) or is_fake(t)
        else mode.from_tensor(t), args)
    root = getattr(fn, "__name__", "step")
    recorder = _Recorder(_module_names(modules, root), root,
                         beneath_dtensor=_has_dtensor(leaves), memory=memory)
    if not memory:
        with mode, recorder:
            fn(*fake_args)
        return recorder.records, None
    with mode:
        # a real tensor among the arguments becomes its (memoized) fake
        inputs = [t if is_fake(_local(t)) else mode.from_tensor(t)
                  for t in _leaf_tensors(fake_args)]
    for t in inputs:
        recorder.memory.argument(t)
    arg_bytes = _storage_bytes(inputs)
    with mode, recorder:
        out = fn(*fake_args)
        out_bytes = _storage_bytes(
            t if is_fake(_local(t)) else mode.from_tensor(t)
            for t in _leaf_tensors(out))
    del out
    mem = CallMemory(
        argument_bytes=sum(arg_bytes.values()),
        output_bytes=sum(out_bytes.values()),
        alias_bytes=float(sum(n for k, n in out_bytes.items()
                              if k in arg_bytes)),
        created_peak_bytes=recorder.memory.peak)
    return recorder.records, mem


def walk_callable(fn, *args) -> list[OpRecord]:
    """Per-op records of one call of ``fn(*args)``, captured under
    ``FakeTensorMode``: no parameter or activation is allocated and no
    kernel is launched.

    ``args`` may hold DTensors on a mesh (recorded per rank, beneath
    DTensor, with their collectives), fake tensors (a phase of
    :mod:`repro_torch.workload.steps` builds its model and inputs in a
    fake mode, which the capture joins), real tensors (read as fakes of
    their shapes, dtypes and devices), modules (whose module paths scope
    the records) and any other values, passed as they are.
    """
    return _capture(fn, args, memory=False)[0]


def capture_call(fn, *args) -> tuple[list[OpRecord], CallMemory]:
    """:func:`walk_callable`'s records of one call of ``fn(*args)`` and its
    :class:`CallMemory`: the arguments' storages (a module's parameters
    and buffers among them), what the call returns, the part of it that
    is an argument, and the peak of the live bytes of the storages its
    ops create."""
    return _capture(fn, args, memory=True)
