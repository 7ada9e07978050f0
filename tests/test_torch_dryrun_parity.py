"""The port's dry-run record held to the reference's compiled program,
field by field, on five small cells (``reduced_config``, S 16, B 8 but
where a cell says): qwen2-7b decode with 6 query heads over a model axis
of 4 (2x4: the heads do not divide the axis), stablelm-3b train on 4x2,
qwen3-moe prefill on 4x2, ``pod-heads`` (qwen2-7b decode with the pod
cell's 28 query and 4 kv heads on the 16x16 mesh, B 16: the pod's uneven
head split) and qwen3-moe decode on 4x2 (the sort semantics on a mesh).

The reference's side is its SPMD-partitioned program for the mesh's
count of forced host devices, compiled in a subprocess (one for every
count), its dots and collectives read with the port's
``core/hlo_counter`` and ``core/hlo`` and its ``memory_analysis`` taken
as ``hlo.memory_analysis_stats`` takes it.  The port's side is rank 0 of
``launch/dryrun.capture_step`` under a fake group of as many ranks.
Where the two differ by design the difference is named here with its
cause; every other field is held equal.
"""
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys
import weakref

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import ARCHS, reduced_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.core import autotune as AT
from repro_torch.core import hlo as H
from repro_torch.launch import dryrun as DR
from repro_torch.launch.mesh import fake_world, init_mesh
from repro_torch.models import moe as MOE

from test_torch_workload import _hlo_dots

ROOT = pathlib.Path(__file__).resolve().parents[1]
S = 16
AXES = ("data", "model")
#: cell -> (arch, kind, mesh shape, config overrides, B)
CELLS = {
    "qwen2-7b/decode/2x4": ("qwen2-7b", "decode", (2, 4), {"n_heads": 6},
                            8),
    "stablelm-3b/train/4x2": ("stablelm-3b", "train", (4, 2), {}, 8),
    "qwen3-moe/prefill/4x2": ("qwen3-moe-235b-a22b", "prefill", (4, 2), {},
                              8),
    "pod-heads": ("qwen2-7b", "decode", (16, 16),
                  {"n_heads": 28, "n_kv_heads": 4}, 16),
    "qwen3-moe/decode/4x2": ("qwen3-moe-235b-a22b", "decode", (4, 2), {}, 8),
}
#: The port's ``total_bytes`` over the reference's, as found: the eager
#: peak (every op's result materialized, a storage freed at its last
#: reference) against XLA's buffer assignment of its fused program.
TOTAL_RATIO = {
    "qwen2-7b/decode/2x4": 0.5714,
    "stablelm-3b/train/4x2": 0.8693,
    "qwen3-moe/prefill/4x2": 0.5398,
    "pod-heads": 0.4121,
    "qwen3-moe/decode/4x2": 0.2606,
}

#: Collective kinds the reference charges and the port does not, by
#: design, with their cause.
ABSENT_BY_DESIGN = {
    "collective-permute": "XLA's partitioner moves shards between devices "
                          "point to point where it reshards (a weight's "
                          "FSDP rows onto a split of its columns, a slice "
                          "of the cache); DTensor reshards by all-gather "
                          "and all-to-all only",
}

#: The all-gathers differ in every cell: the port casts each rank's shard
#: of a weight to the activation dtype (``L.dense``'s ``w.to(x.dtype)``)
#: and gathers bf16, where XLA gathers the f32 weight and converts it
#: after: half the bytes a weight.
_CAST_FIRST = ("each weight's shard is cast to bf16 before its gather; "
               "XLA gathers the f32 weight")

#: Every kind whose wire bytes differ from the reference's by more than 5 %
#: of the reference's wire bytes in all, with its cause.
NAMED = {
    "qwen2-7b/decode/2x4": {
        "all-gather": _CAST_FIRST,
        "all-reduce": "XLA splits the q, k and v products' contraction "
                      "over model and all-reduces their partial products; "
                      "the port splits their columns "
                      "(``attention._project``) and gathers the heads",
        "collective-permute": ABSENT_BY_DESIGN["collective-permute"],
    },
    "stablelm-3b/train/4x2": {
        "all-gather": _CAST_FIRST + "; and XLA gathers each FSDP weight "
                      "again for the backward, where autograd keeps the "
                      "gathered weight the forward used",
        "all-reduce": "XLA's CPU partitioner reduces each FSDP weight's "
                      "gradient whole (an all-reduce, then a slice): the "
                      "port reduce-scatters it, half the wire bytes",
        "reduce-scatter": "the gradients' reduce-scatters, the same cause",
    },
    "qwen3-moe/prefill/4x2": {
        "all-gather": _CAST_FIRST + ", the experts' weights included",
        "all-to-all": "the port's three are the embedding lookup's "
                      "(``pspec.vocab_pick``) and the experts' dispatch "
                      "and its return (``moe._forward_einsum_split``); "
                      "XLA's partitioner adds eight around RoPE, the "
                      "router and the combine",
    },
    "pod-heads": {
        "all-gather": _CAST_FIRST + "; and XLA gathers the q weight's FSDP "
                      "rows for 7 whole heads, a quarter of its columns "
                      "(the port gathers its sixteenth, "
                      "``attention._project``)",
        "all-reduce": "XLA's attention core splits the cache's rows and "
                      "the heads 4 ways each (7 heads a rank) and merges "
                      "the softmax states over groups of 4 in two "
                      "all-reduces of every head's accumulator; the port's "
                      "core takes every head over its sixteenth of the "
                      "rows and merges once over the 16 ranks of model "
                      "(``attention._partial_decode``): the same products",
    },
    "qwen3-moe/decode/4x2": {
        "all-gather": _CAST_FIRST + "; and XLA gathers every expert's "
                      "FSDP-split weights (f32, 3 x 49,152 B), where the "
                      "port's expert products contract over that split "
                      "and reduce-scatter their partial sums (a decode "
                      "step dispatches few rows).  By design both gather "
                      "the dispatch's rows whole on every rank (the port "
                      "the layer's input, ``moe._forward_sort_split``)",
        "all-reduce": "the reference's combine picks each slot's row on "
                      "the rank of its expert and all-reduces the rows of "
                      "all T tokens (two f32 (T, d) all-reduces); the port "
                      "gathers the experts' outputs whole and each rank "
                      "combines its own tokens (``moe._forward_sort_split``)",
    },
}

#: Products only one side has, by design, with their cause:
#: cell -> (cause, function of the cell's config -> (the reference's
#: extra products, the port's)).
PRODUCTS_BY_DESIGN = {
    "pod-heads": (
        "the reference computes the q product on whole heads, 7 of 28 on "
        "each quarter of model's ranks; the port computes this rank's "
        "sixteenth of q's columns and gathers the heads "
        "(``attention._project``, ``attention._heads``), a quarter of the "
        "reference's FLOPs",
        lambda cfg, rows: (
            [2.0 * rows * cfg.d_model * 7 * cfg.head_dim] * cfg.n_layers,
            [2.0 * rows * cfg.d_model * cfg.q_dim / 16] * cfg.n_layers)),
}

_REFERENCE = r"""
import dataclasses, json, os, sys
os.environ['JAX_PLATFORMS'] = 'cpu'
cells, S, devices, autotune = json.loads(sys.argv[1])
os.environ['XLA_FLAGS'] = ('--xla_force_host_platform_device_count=%d'
                           % devices)
from repro.compat import make_mesh
from repro.configs import ARCHS, reduced_config
from repro.configs.shapes import ShapeSpec
from repro.core import autotune as AT
from repro.core import hlo as HLO
from repro.launch.steps import TrainConfig, build_step
out = {}
for name, (arch, kind, shape, over, B) in cells.items():
    mesh = make_mesh(tuple(shape), ('data', 'model'))
    cfg = dataclasses.replace(reduced_config(ARCHS[arch]), **over)
    spec = ShapeSpec('c', S, B, kind)
    built = build_step(cfg, spec, mesh, TrainConfig())
    compiled = built.fn.lower(*built.args).compile()
    out[name] = {'hlo': compiled.as_text(),
                 'memory': HLO.memory_analysis_stats(compiled)}
    if name in autotune:
        res = AT._autotune(cfg, spec, mesh, cache=False)
        recs = {}
        for c in AT.default_candidates(kind):
            try:
                recs[c.name] = AT.analyze_candidate(cfg, spec, mesh, c, None)
            except Exception as e:
                recs[c.name] = None
        out[name]['autotune'] = {'order': [t.candidate.name for t in res],
                                 'records': recs}
json.dump(out, open(sys.argv[2], 'w'))
"""

#: cells whose candidates are ranked (``default_candidates``)
RANKED = ("qwen2-7b/decode/2x4", "stablelm-3b/train/4x2")


def _ranks(cell) -> int:
    return math.prod(CELLS[cell][2])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's programs, one subprocess for each count of forced
    host devices (the count is fixed once jax starts)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    got = {}
    for devices in sorted({_ranks(c) for c in CELLS}):
        out = tmp_path_factory.mktemp("reference") / "cells.json"
        cells = {c: v for c, v in CELLS.items() if _ranks(c) == devices}
        subprocess.run([sys.executable, "-c", _REFERENCE,
                        json.dumps([cells, S, devices, RANKED]), str(out)],
                       check=True, env=env, timeout=900, capture_output=True)
        got.update(json.loads(out.read_text()))
    return got


def _cfg(cell, **extra):
    arch, _, _, over, _ = CELLS[cell]
    return dataclasses.replace(reduced_config(ARCHS[arch]), **over, **extra)


def _shape(cell) -> ShapeSpec:
    _, kind, _, _, batch = CELLS[cell]
    return ShapeSpec("c", S, batch, kind)


@pytest.fixture(scope="module")
def port():
    """(records, memory) of each cell, and how many all-to-alls DTensor
    ran in it (``shard_dim_alltoall``: on a CPU mesh an all-gather and a
    chunk)."""
    from torch.distributed.tensor import placement_types as PT
    run = PT.shard_dim_alltoall
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return run(*args, **kwargs)
    out = {}
    PT.shard_dim_alltoall = counted
    try:
        for cell in CELLS:
            calls.clear()
            with fake_world(_ranks(cell)):
                mesh = init_mesh(CELLS[cell][2], AXES, device_type="cpu")
                records, mem = DR.capture_step(
                    _cfg(cell), _shape(cell), DR.TrainConfig(), mesh)
            out[cell] = records, mem, len(calls)
    finally:
        PT.shard_dim_alltoall = run
    return out


def _one_hot_products(cell) -> list[float]:
    """The reference's einsum MoE dispatches and combines with one-hot
    products, a rank's share of 2·E·C·d·n FLOPs a group each; the port
    gathers rows by index there (``models/moe.py``): no product.  A decode
    step takes the sort semantics (gathers on both sides)."""
    cfg = _cfg(cell)
    shape = _shape(cell)
    if cfg.family != "moe" or shape.kind == "decode":
        return []
    g, n, C = MOE.groups(cfg, shape.global_batch, S, "einsum")
    per_rank = 2.0 * cfg.n_experts * C * cfg.d_model * n * g / _ranks(cell)
    return [per_rank, per_rank] * cfg.n_layers


def _products_by_design(cell) -> tuple[list[float], list[float]]:
    """(the reference's products the port has not, the port's the
    reference has not), by design (``PRODUCTS_BY_DESIGN``)."""
    if cell not in PRODUCTS_BY_DESIGN:
        return [], []
    data = CELLS[cell][2][0]
    return PRODUCTS_BY_DESIGN[cell][1](_cfg(cell),
                                       _shape(cell).global_batch // data)


@pytest.mark.parametrize("cell", CELLS)
def test_products_op_for_op(cell, reference, port):
    """Rank 0's products equal the reference's per-chip dots op for op (the
    q, k and v projections at an uneven head split, and the MoE decode's
    router on this rank's tokens, included), but for the reference's
    one-hot MoE dispatch and combine and the products named in
    ``PRODUCTS_BY_DESIGN``."""
    ref = sorted(f for f, n in _hlo_dots(reference[cell]["hlo"]).items()
                 for _ in range(int(n)))
    records, _, _ = port[cell]
    got = [r.flops for r in records if r.op_class == "matmul"]
    only_ref, only_port = _products_by_design(cell)
    for f in only_port:
        got.remove(f)
    assert sorted(got + _one_hot_products(cell) + only_ref) == ref


@pytest.mark.parametrize("cell", CELLS)
def test_memory_keys_and_the_bytes_the_step_takes(cell, reference, port):
    """``memory_analysis`` carries the reference's keys; the arguments
    (everything the step takes, the decode step's tokens and int32
    position included) and the aliased bytes (what it updates in place and
    returns: caches, parameters and optimizer state, its step counter
    included) equal the reference's exactly; the total is argument +
    output + temp - alias and is the eager peak."""
    want = reference[cell]["memory"]
    _, mem, _ = port[cell]
    assert set(want) == set(DR.MEMORY_KEYS) and set(want) <= set(mem)
    for key in ("argument_size_in_bytes", "alias_size_in_bytes"):
        assert mem[key] == want[key], key
    assert mem["total_bytes"] == mem["peak_live_bytes"] == (
        mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
        + mem["temp_size_in_bytes"] - mem["alias_size_in_bytes"])
    assert mem["argument_size_in_bytes"] == sum(
        mem[k] for k in ("param_bytes", "opt_bytes", "batch_bytes",
                         "cache_bytes") if k in mem)


@pytest.mark.parametrize("cell", CELLS)
def test_total_bytes_ratio(cell, reference, port):
    _, mem, _ = port[cell]
    ratio = mem["total_bytes"] / reference[cell]["memory"]["total_bytes"]
    assert ratio == pytest.approx(TOTAL_RATIO[cell], abs=5e-4)


def _by_kind(pairs) -> dict:
    out: dict = {}
    for kind, operand, wire in pairs:
        n, o, w = out.get(kind, (0, 0.0, 0.0))
        out[kind] = (n + 1, o + operand, w + wire)
    return out


def _collectives(cell, reference, port) -> tuple[dict, dict]:
    ref = _by_kind((op.kind, op.operand_bytes, op.wire_bytes) for op in
                   H.parse_collectives(reference[cell]["hlo"]))
    records, _, _ = port[cell]
    got = _by_kind((r.opcode, r.collective_operand_bytes,
                    r.collective_wire_bytes) for r in records
                   if r.n_collectives)
    return ref, got


@pytest.mark.parametrize("cell", CELLS)
def test_every_kind_the_reference_charges(cell, reference, port):
    """Each collective kind of the reference's program is charged by the
    port, or named as absent by design; no all-to-all is charged as an
    all-gather (a CPU mesh's fallback is recorded as the all-to-all)."""
    ref, got = _collectives(cell, reference, port)
    missing = set(ref) - set(got)
    assert missing <= set(ABSENT_BY_DESIGN), missing
    _, _, alltoalls = port[cell]
    assert alltoalls > 0
    assert got["all-to-all"][0] == alltoalls


@pytest.mark.parametrize("cell", CELLS)
def test_collective_differences_are_named(cell, reference, port):
    """The kinds whose wire bytes differ from the reference's by more than
    5 % of its wire bytes are exactly the ones ``NAMED`` gives a cause."""
    ref, got = _collectives(cell, reference, port)
    total = sum(w for _, _, w in ref.values())
    big = {k for k in set(ref) | set(got)
           if abs(got.get(k, (0, 0, 0))[2] - ref.get(k, (0, 0, 0))[2])
           > 0.05 * total}
    assert big == set(NAMED[cell])


def _rank(records: dict) -> list[str]:
    names = [k for k, r in records.items() if r is not None]
    scores = AT.rank_records([records[k] for k in names], device="cpu")
    return [names[i] for i in scores["order"]]


@pytest.mark.parametrize("cell", RANKED)
def test_ranking_with_the_reference_bytes(cell, reference):
    """The reference's candidates captured by the port and ranked: with
    the reference's bytes by class swapped into each record (eager bytes
    against fused HLO bytes differ by design) the ranking is the
    reference's ``_autotune`` order."""
    _, kind, shape, _, _ = CELLS[cell]
    spec = _shape(cell)
    ref = reference[cell]["autotune"]
    layout = (shape, AXES)
    got = {}
    for c in AT.default_candidates(kind):
        try:
            got[c.name] = AT.analyze_candidate(_cfg(cell), spec, layout, c)
        except ValueError:
            got[c.name] = None
    assert {k for k, r in got.items() if r is None} == {
        k for k, r in ref["records"].items() if r is None}
    swapped = {k: r and {**r, "bytes_by_class":
                         ref["records"][k]["bytes_by_class"]}
               for k, r in got.items()}
    assert _rank(swapped) == ref["order"]
    assert set(_rank(got)) == set(ref["order"])


# ---------------------------------------------------------------------------
# the capture's live bytes against an eager run
# ---------------------------------------------------------------------------

class _Live(TorchDispatchMode):
    """The bytes of the storages a real (CPU) call creates, each from the
    op that makes it to its last reference, and their peak: what
    ``capture_call`` counts on fake tensors, counted on real ones by a
    dispatch mode that does nothing else."""

    def __init__(self, args):
        super().__init__()
        self.args = {id(t.untyped_storage()): t.untyped_storage()
                     for t in args}
        self.born, self.now, self.peak = {}, 0, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self.add(t.untyped_storage())
        return out

    def add(self, st):
        key = id(st)
        if key in self.args or key in self.born:
            return
        n = st.nbytes()
        self.born[key] = weakref.ref(st, lambda _, k=key, n=n: self.drop(k, n))
        self.now += n
        self.peak = max(self.peak, self.now)

    def drop(self, key, n):
        self.born.pop(key, None)
        self.now -= n


@pytest.mark.parametrize("arch,kind,remat", [
    ("stablelm-3b", "train", True), ("qwen2-7b", "prefill", False),
    ("qwen3-moe-235b-a22b", "train", False),
    ("recurrentgemma-9b", "train", False)])
def test_captured_peak_equals_an_eager_run(arch, kind, remat):
    """One card's step (no mesh) captured on fakes: the peak of the
    storages it creates equals the same count over the step run eagerly on
    real CPU tensors, autograd's saved tensors and the remat recompute
    included; the arguments are every parameter, moment and batch leaf."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as TF
    from repro_torch.optim.adamw import adamw_init
    cfg = dataclasses.replace(reduced_config(ARCHS[arch]), remat=remat,
                              use_kernels=False)
    shape = ShapeSpec("c", 32, 2, kind)
    tcfg = ST.TrainConfig()
    _, mem = DR.capture_step(cfg, shape, tcfg, None, device="cpu")
    built = ST.build_step(cfg, shape, tcfg, device="cpu")
    model = TF.init_params(cfg, seed=0, device="cpu")
    batch = {"tokens": torch.zeros(2, 32, dtype=torch.int32)}
    leaves = list(model.parameters())
    if kind == "train":
        opt = adamw_init(dict(model.named_parameters()), tcfg.optimizer)
        batch["labels"] = torch.zeros(2, 32, dtype=torch.int32)
        args = (model, opt, batch)
        leaves += [opt["step"], *opt["m"].values(), *opt["v"].values()]
    else:
        args = (model, batch)
    leaves += list(batch.values())
    live = _Live(leaves)
    with live:
        out = built.fn(*args)
    del out
    assert mem["total_bytes"] - mem["argument_size_in_bytes"] == live.peak
    assert mem["argument_size_in_bytes"] == sum(
        t.untyped_storage().nbytes() for t in leaves)


@pytest.mark.parametrize("cell", ["qwen2-7b/decode/2x4",
                                  "qwen3-moe/prefill/4x2"])
def test_following_memory_keeps_the_records(cell):
    """``capture_call`` records what ``walk_callable`` records, op for op:
    following the storages changes no record."""
    from repro_torch.workload import capture as C
    seen = []
    real = C._capture

    def both(fn, args, memory):
        seen.append(real(fn, args, memory=False)[0])
        return real(fn, args, memory)
    C._capture = both
    try:
        with fake_world(_ranks(cell)):
            mesh = init_mesh(CELLS[cell][2], AXES, device_type="cpu")
            records, _ = DR.capture_step(_cfg(cell), _shape(cell),
                                         DR.TrainConfig(), mesh)
    finally:
        C._capture = real
    assert seen[0] == records
