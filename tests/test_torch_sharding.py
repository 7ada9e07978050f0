"""The port's sharding plan (``repro_torch.launch.sharding``), its logical
axes (``repro_torch.models.pspec``) and the elastic mesh planner, held to
the reference's on the same inputs.

The plan reads only a mesh's axis names and sizes, so both sides plan on
stand-ins (the reference's ``axis_names``/``devices.shape``, the port's
``mesh_dim_names``/``shape``) of the production meshes 16x16 and 2x16x16
and of 4x2, 2x4 and 1x1: no device is needed.  The reference's
``NamedSharding`` wraps its spec; the tests read the spec alone.
"""
import dataclasses
import functools
import types

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced_config as ref_reduced
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.configs.shapes import input_specs as ref_input_specs
from repro.launch import sharding as RSH
from repro.models import pspec as RPS
from repro.models import transformer as RTF
from repro.optim import OptimizerConfig as RefOptimizerConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.runtime.elastic import plan_mesh_shape as ref_plan_mesh_shape
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.configs.shapes import SHAPES, input_specs
from repro_torch.launch import sharding as SH
from repro_torch.models import pspec as PS
from repro_torch.models import transformer as TF
from repro_torch.optim.adamw import OptimizerConfig, adamw_init
from repro_torch.runtime.elastic import plan_mesh_shape

ARCH_NAMES = sorted(ARCHS)
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
KV_SHARDS = ("auto", "heads", "seq")


def ref_mesh(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def port_mesh(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(mesh_dim_names=axes, shape=shape)


def _cfgs(arch, reduced):
    if reduced:
        return ref_reduced(REF_ARCHS[arch]), reduced_config(ARCHS[arch])
    return REF_ARCHS[arch], ARCHS[arch]


def _outcome(fn):
    try:
        return "ok", fn()
    except ValueError as e:
        return "raises", str(e)


# ---------------------------------------------------------------------------
# make_plan, field for field
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_make_plan_equals_reference(arch, mesh):
    """Every field and rule, at full and reduced widths, over the four
    shapes, the three kv_shard modes and fsdp_decode; where one raises the
    other raises the same error."""
    n = 0
    for reduced in (False, True):
        rcfg, cfg = _cfgs(arch, reduced)
        for sname, shape in SHAPES.items():
            for kv in KV_SHARDS:
                for fsdp in (False, True):
                    kw = dict(global_batch=shape.global_batch, kv_shard=kv,
                              kind=shape.kind, fsdp_decode=fsdp)
                    want = _outcome(lambda: RSH.make_plan(
                        rcfg, ref_mesh(mesh), **kw))
                    got = _outcome(lambda: SH.make_plan(
                        cfg, port_mesh(mesh), **kw))
                    assert got[0] == want[0], (reduced, sname, kv, fsdp)
                    if want[0] == "raises":
                        assert got[1] == want[1]
                        continue
                    assert dataclasses.asdict(got[1]) == \
                        dataclasses.asdict(want[1]), (reduced, sname, kv, fsdp)
                    assert got[1].rules() == want[1].rules()
                    n += 1
    assert n > 0


# ---------------------------------------------------------------------------
# specs of every leaf
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_params(arch, reduced):
    rcfg, _ = _cfgs(arch, reduced)
    return jax.eval_shape(lambda: RTF.init_params(jax.random.PRNGKey(0), rcfg))


@functools.lru_cache(maxsize=None)
def _port_params(arch, reduced):
    _, cfg = _cfgs(arch, reduced)
    return {k: v for k, v in
            TF.Transformer(cfg, device="meta").named_parameters()}


def _ref_leaf(tree, cfg, name: str):
    """(the reference leaf of the port's ``name``, whether it is stacked
    over the scanned groups): layer L is ``groups/b{L % n}`` at index
    ``L // n`` for the scanned layers and ``rest/{i}`` after them."""
    parts = name.split(".")
    if parts[0] != "layers":
        node = tree
        for p in parts:
            node = node[p]
        return node, False
    layer, rest = int(parts[1]), parts[2:]
    n = len(cfg.block_pattern)
    scanned = cfg.pattern_repeats * n
    if layer < scanned:
        node, stacked = tree["groups"][f"b{layer % n}"], True
    else:
        node, stacked = tree["rest"][layer - scanned], False
    for p in rest:
        node = node[p]
    return node, stacked


def _canon(spec) -> tuple:
    """A spec with one-axis tuples written as the axis (``PartitionSpec``
    writes ``("data",)`` as ``"data"``: the same split)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _spec(p, ndim) -> tuple:
    spec = _canon(tuple(p))
    return spec + (None,) * (ndim - len(spec))


def _check_tree(port_specs: dict, ref_specs, cfg, shapes: dict) -> int:
    for name, spec in port_specs.items():
        ref, stacked = _ref_leaf(ref_specs, cfg, name)
        want = _spec(ref, len(shapes[name]) + stacked)
        if stacked:
            assert want[0] is None, name
            want = want[1:]
        assert _canon(spec) == want, (name, spec, want)
    return len(port_specs)


def _n_port_leaves(ref_tree, cfg) -> int:
    """The reference's leaves counted as the port holds them: a stacked
    group's leaf once a repeat."""
    flat, _ = jax.tree_util.tree_flatten_with_path(ref_tree)
    return sum(cfg.pattern_repeats if path[0].key == "groups" else 1
               for path, _ in flat)


@pytest.fixture()
def specs_only(monkeypatch):
    """The reference's ``NamedSharding`` as its spec (stand-in meshes)."""
    monkeypatch.setattr(RSH, "NamedSharding", lambda mesh, spec: spec)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_and_moment_specs_equal_reference(arch, reduced, specs_only):
    """Every parameter and AdamW moment of the port's ``Transformer``
    (meta tensors) gets the spec the reference gives its leaf (shape
    structs from ``jax.eval_shape``), without the stacked leading axis, on
    every mesh and shape."""
    rcfg, cfg = _cfgs(arch, reduced)
    rparams, params = _ref_params(arch, reduced), _port_params(arch, reduced)
    shapes = {k: tuple(v.shape) for k, v in params.items()}
    ropt = jax.eval_shape(lambda: ref_adamw_init(rparams,
                                                 RefOptimizerConfig()))
    opt = adamw_init(params, OptimizerConfig())
    for mesh in ("16x16", "2x16x16", "4x2"):
        for shape in SHAPES.values():
            kw = dict(global_batch=shape.global_batch, kind=shape.kind)
            rplan = RSH.make_plan(rcfg, ref_mesh(mesh), **kw)
            plan = SH.make_plan(cfg, port_mesh(mesh), **kw)
            pspecs = SH.param_specs(params, cfg, plan, port_mesh(mesh))
            rspecs = RSH.param_shardings(rparams, rplan, ref_mesh(mesh))
            assert _check_tree(pspecs, rspecs, cfg, shapes) == \
                _n_port_leaves(rparams, cfg)
            ropt_specs = RSH.opt_state_shardings(ropt, rspecs, ref_mesh(mesh),
                                                 rplan)
            ospecs = SH.opt_state_shardings(opt, pspecs, port_mesh(mesh), plan)
            for g in ("m", "v"):
                _check_tree(ospecs[g], ropt_specs[g], cfg, shapes)
            assert tuple(ropt_specs["step"]) == ()


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_batch_and_cache_specs_equal_reference(arch, reduced, specs_only):
    """Every batch leaf and every decode cache or recurrent state gets the
    reference's spec (the port's per-layer caches against the reference's
    stacked groups and ``rest``)."""
    from repro.configs.shapes import cell_status as ref_cell_status
    rcfg, cfg = _cfgs(arch, reduced)
    for mesh in ("16x16", "2x16x16", "4x2"):
        for sname, shape in SHAPES.items():
            if not ref_cell_status(rcfg, REF_SHAPES[sname])[0]:
                continue
            kw = dict(global_batch=shape.global_batch, kind=shape.kind)
            rplan = RSH.make_plan(rcfg, ref_mesh(mesh), **kw)
            plan = SH.make_plan(cfg, port_mesh(mesh), **kw)
            rspecs = ref_input_specs(rcfg, REF_SHAPES[sname])
            specs = input_specs(cfg, shape)
            if "batch" in specs:
                got = SH.batch_specs(specs["batch"], plan, port_mesh(mesh))
                want = RSH.batch_shardings(rspecs["batch"], rplan,
                                           ref_mesh(mesh))
                assert set(got) == set(want)
                for k in got:
                    assert _canon(got[k]) == _spec(want[k],
                                                   specs["batch"][k].ndim)
                continue
            got = SH.cache_specs(specs["caches"], plan, port_mesh(mesh))
            want = RSH.cache_shardings(rspecs["caches"], rplan,
                                       ref_mesh(mesh), rcfg)
            for layer, (c, spec) in enumerate(zip(specs["caches"], got)):
                for k in c:
                    ref, stacked = _ref_leaf(want, cfg, f"layers.{layer}.{k}")
                    full = _spec(ref, c[k].ndim + stacked)
                    assert _canon(spec[k]) == (full[1:] if stacked
                                               else full), (mesh, sname,
                                                            layer, k)


# ---------------------------------------------------------------------------
# the small functions
# ---------------------------------------------------------------------------

RULE_NAMES = ("batch", "seq", "kv_seq", "heads", "kv_heads", "ff", "vocab",
              "experts", "expert_cap", "expert_ff", "tokens", "rnn",
              "mlstm_dh", "act_seq", "moe_groups", "unknown")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["qwen2-7b", "grok-1-314b", "xlstm-1.3b"])
def test_logical_to_spec_and_rule_axis_size_equal_reference(arch, mesh):
    for shape in SHAPES.values():
        kw = dict(global_batch=shape.global_batch, kind=shape.kind)
        rplan = RSH.make_plan(REF_ARCHS[arch], ref_mesh(mesh), **kw)
        plan = SH.make_plan(ARCHS[arch], port_mesh(mesh), **kw)
        with RPS.axis_rules(ref_mesh(mesh), rplan.rules()), \
                PS.axis_rules(port_mesh(mesh), plan.rules()):
            for name in RULE_NAMES:
                assert PS.rule_axis_size(name) == RPS.rule_axis_size(name)
            names = ("batch", None, "heads", "vocab")
            assert _canon(PS.logical_to_spec(names)) == _canon(
                RPS.logical_to_spec(names))
    assert PS.rule_axis_size("heads") == RPS.rule_axis_size("heads") == 1


def test_plan_mesh_shape_equals_reference():
    for n in range(1, 1025):
        for mp in (16, 8):
            want = _outcome(lambda: ref_plan_mesh_shape(n, model_parallel=mp))
            got = _outcome(lambda: plan_mesh_shape(n, model_parallel=mp))
            assert got == want, (n, mp)


def test_shard_is_the_identity_without_a_mesh_or_on_a_plain_tensor():
    x = torch.randn(2, 3)
    assert PS.shard(x, "batch", None) is x
    with PS.axis_rules(port_mesh("4x2"), {"batch": ("data",)}):
        assert PS.shard(x, "batch", None) is x


def test_placements_split_joint_axes_in_mesh_order():
    """A dim over ("pod", "data") is Shard(d) on both, pod-major, and each
    rank's chunk is the reference's: rank (p, d, m) of 2x2x2 holds rows
    [(2p + d) * 2, (2p + d) * 2 + 2) of 8."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import fake_world, init_mesh
    mesh_axes = ("pod", "data", "model")
    with fake_world(8):
        mesh = init_mesh((2, 2, 2), mesh_axes, device_type="cpu")
        assert PS.placements(mesh, (("pod", "data"), "model")) == \
            (Shard(0), Shard(0), Shard(1))
        assert PS.placements(mesh, (None, None)) == (Replicate(),) * 3
        with pytest.raises(ValueError, match="mesh's axis order"):
            PS.placements(mesh, (("data", "pod"),))
        for coord in ((0, 0, 0), (1, 0, 1), (1, 1, 0)):
            mesh.get_coordinate = lambda c=coord: list(c)
            size, offset = PS.local_extent((8, 4), mesh,
                                           (Shard(0), Shard(0), Shard(1)))
            assert size == [2, 2]
            assert offset == [(2 * coord[0] + coord[1]) * 2, 2 * coord[2]]
