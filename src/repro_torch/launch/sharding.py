"""Sharding policy: logical-axis rules for activations and path-based
specs for parameters, optimizer state, batches and caches.

Port of ``repro.launch.sharding``.  Strategy, as the reference's:

* batch over ("pod","data"): pure DP across pods, FSDP within a pod;
* parameters FSDP-sharded over "data" on one dimension and
  tensor-parallel over "model" on the other;
* MoE experts expert-parallel over "model" when the expert count divides
  the axis, else tensor-parallel inside experts (grok-1's 8 experts);
* GQA KV heads shard over "model" when divisible; otherwise the decode
  KV cache shards its sequence dim over "model" (``kv_shard``);
* single-stream long-context decode (batch=1) can't data-parallelize, so
  channel-like axes spill onto ("data","model") jointly.

A spec is a tuple with one entry a tensor dimension (``models.pspec``);
``param_shardings``, ``opt_state_shardings``, ``batch_shardings`` and
``cache_shardings`` return DTensor placements on a ``DeviceMesh``, and
:func:`distribute_tree` places a tree of real or fake tensors by them.
The plan reads only the mesh's axis names and sizes
(``pspec.mesh_sizes``), so any stand-in with ``mesh_dim_names`` and
``shape`` plans.

Parameters are the port's (``models.transformer.Transformer``, one
module a layer); ``models.convert.reference_path``, the port's name map,
names each one as the reference's tree names it, and the reference's
path rules give its spec, without the leading axis the reference stacks
its scanned layers on.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import reference_path
from repro_torch.models.pspec import axis_product, mesh_sizes, placements


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Resolved axis assignment for one (cfg, mesh, shape) combination."""

    batch_axes: tuple[str, ...] | None
    fsdp_axes: tuple[str, ...] | None       # weight-dim sharding (ZeRO-3)
    tp_axis: str | None                     # tensor-parallel axis
    heads_axes: Any
    kv_heads_axes: Any
    kv_seq_axes: Any                        # decode-cache sequence sharding
    expert_axes: Any
    expert_ff_axes: Any
    rnn_axes: Any
    ff_axes: Any
    vocab_axes: Any
    mlstm_dh_axes: Any = None

    def rules(self) -> dict[str, Any]:
        """Logical-axis rules for ``pspec.axis_rules`` (activations)."""
        return {
            "batch": self.batch_axes,
            "seq": None,
            "kv_seq": self.kv_seq_axes,
            "heads": self.heads_axes,
            "kv_heads": self.kv_heads_axes,
            "ff": self.ff_axes,
            "vocab": self.vocab_axes,
            "experts": self.expert_axes,
            "expert_cap": self.batch_axes,
            "expert_ff": self.expert_ff_axes,
            "tokens": self.batch_axes,
            "rnn": self.rnn_axes,
            "mlstm_dh": self.mlstm_dh_axes,
            # sequence-parallel residuals at remat boundaries over the
            # tensor-parallel axis; dropped for S=1 decode (dim < axis)
            "act_seq": self.tp_axis if self.batch_axes else None,
            # MoE dispatch token groups: batch axes + the TP axis
            "moe_groups": (tuple(self.batch_axes) + (self.tp_axis,)
                           if self.batch_axes and self.tp_axis
                           else self.batch_axes),
        }


def make_plan(cfg: ModelConfig, mesh, *, global_batch: int,
              kv_shard: str = "auto", kind: str = "train",
              fsdp_decode: bool = False) -> ShardingPlan:
    sizes = mesh_sizes(mesh)
    model = sizes.get("model", 1)
    data = sizes.get("data", 1)
    pod = sizes.get("pod", 1)

    batch_axes: tuple[str, ...] | None
    if global_batch % (pod * data) == 0 and global_batch >= pod * data:
        batch_axes = ("pod", "data") if pod > 1 else ("data",)
    elif pod > 1 and global_batch % pod == 0:
        batch_axes = ("pod",)
    else:
        batch_axes = None                      # single-stream decode

    fsdp: tuple[str, ...] | None = ("data",) if batch_axes else None
    if kind in ("decode", "long_decode") and not fsdp_decode:
        # inference has no optimizer state: keep weights TP-sharded only
        fsdp = None
    joint = ("data", "model") if batch_axes is None else None

    def div(n: int, axis_size: int):
        return n > 0 and n % axis_size == 0

    def div_pad(n: int, axis_size: int):
        # uneven sharding: fine when the dim >= axis
        return n >= axis_size

    heads = "model" if div_pad(cfg.n_heads, model) else None
    kv_heads = "model" if div(cfg.n_kv_heads, model) else None
    if kv_shard == "heads" and kv_heads is None:
        raise ValueError("kv heads not divisible by model axis")
    kv_seq = None
    if kv_heads is None or kv_shard == "seq":
        kv_heads = None
        kv_seq = "model"

    experts = "model" if div(cfg.n_experts, model) else None
    expert_ff = None if experts else ("model" if div(cfg.d_ff, model) else None)

    rnn = (joint if joint and div(cfg.rnn_width, data * model)
           else ("model" if div(cfg.rnn_width, model) else None))
    # effective FFN width: mLSTM blocks (d_ff == 0) use the up-projection
    ff_width = cfg.d_ff if cfg.d_ff > 0 else int(cfg.d_model * cfg.mlstm_proj_factor)
    ff = (joint if joint and div(ff_width, data * model)
          else ("model" if div(ff_width, model) else None))
    mlstm_dh = ff_width // max(1, cfg.n_heads)
    mlstm_dh_axes = "model" if div(mlstm_dh, model) else None
    vocab = (joint if joint and div(cfg.padded_vocab, data * model)
             else ("model" if div(cfg.padded_vocab, model) else None))

    return ShardingPlan(
        batch_axes=batch_axes,
        fsdp_axes=fsdp,
        tp_axis="model" if model > 1 else None,
        heads_axes=heads,
        kv_heads_axes=kv_heads,
        kv_seq_axes=kv_seq,
        expert_axes=experts,
        expert_ff_axes=expert_ff,
        rnn_axes=rnn,
        ff_axes=ff,
        vocab_axes=vocab,
        mlstm_dh_axes=mlstm_dh_axes,
    )


# ---------------------------------------------------------------------------
# parameter specs (path-pattern based)
# ---------------------------------------------------------------------------

def _param_spec(path: str, shape: tuple[int, ...], plan: ShardingPlan,
                mesh) -> tuple:
    """The spec of one parameter leaf by its path in the reference's tree
    (``groups/...`` for a leaf stacked over the scanned layers)."""
    f = plan.fsdp_axes
    t = plan.tp_axis
    sizes = mesh_sizes(mesh)

    def fits(spec: tuple) -> tuple:
        """Drop axis assignments that do not divide the dimension."""
        out = []
        for dim, s in zip(shape, spec + (None,) * (len(shape) - len(spec))):
            out.append(None if s is None or dim % axis_product(s, sizes)
                       else s)
        return tuple(out)

    stacked = path.startswith("groups/")

    def st(spec: tuple) -> tuple:
        return fits((None, *spec) if stacked else spec)

    p = path
    if re.search(r"embed$", p):
        return fits((plan.vocab_axes, f))
    if re.search(r"head/w$", p):
        return st((f, plan.vocab_axes))
    if re.search(r"frontend/w$", p):
        return fits((None, t))
    if re.search(r"attn/w[qkv]/w$", p):
        ax = plan.heads_axes if p[-4] == "q" else plan.kv_heads_axes
        return st((f, ax))
    if re.search(r"attn/w[qkv]/b$", p):
        ax = plan.heads_axes if p[-4] == "q" else plan.kv_heads_axes
        return st((ax,))
    if re.search(r"attn/wo/w$", p):
        return st((plan.heads_axes, f))
    if re.search(r"moe/router/w$", p):
        return st((f, None))
    if re.search(r"moe/w[ig]$", p):
        return st((plan.expert_axes, f, plan.expert_ff_axes))
    if re.search(r"moe/wo$", p):
        return st((plan.expert_axes, plan.expert_ff_axes, f))
    if re.search(r"(mlp|ffn)/w[ig]/w$", p):
        return st((f, plan.ff_axes))
    if re.search(r"(mlp|ffn)/wo/w$", p):
        return st((plan.ff_axes, f))
    if re.search(r"rec/(wx|wgate)/w$", p):
        return st((f, plan.rnn_axes))
    if re.search(r"rec/wo/w$", p):
        return st((plan.rnn_axes, f))
    if re.search(r"rec/conv$", p) or re.search(r"rec/gate_[ri]$", p):
        return st((None, plan.rnn_axes))
    if re.search(r"rec/lam$", p):
        return st((plan.rnn_axes,))
    if re.search(r"cell/(up|up_gate)/w$", p):
        return st((f, plan.ff_axes))
    if re.search(r"cell/down/w$", p):
        return st((None, plan.mlstm_dh_axes, f))
    if re.search(r"cell/w[qkv]$", p):          # mLSTM per-head maps
        return st((None, f, None))
    if re.search(r"cell/wif/w$", p):
        return st((f, None))
    if re.search(r"cell/w/w$", p):             # sLSTM gate projection
        return st((f, plan.rnn_axes))
    if re.search(r"cell/r$", p):               # sLSTM diagonal recurrence
        return st((None, plan.rnn_axes))
    if re.search(r"cell/b$", p):
        return st((None,))
    if re.search(r"cell/conv$", p):
        return st((None, None))
    # norms, scalars, biases: replicate
    return st(())


def param_spec(cfg: ModelConfig, name: str, shape, plan: ShardingPlan,
               mesh) -> tuple:
    """The spec of the port's parameter ``name`` of ``shape``: the
    reference's spec of that leaf, without its stacked leading axis."""
    path, _ = reference_path(cfg, name)     # unstacked: the port's shape
    return _param_spec(path, tuple(shape), plan, mesh)


def param_specs(params, cfg: ModelConfig, plan: ShardingPlan,
                mesh) -> dict[str, tuple]:
    """{parameter name: spec} of a ``Transformer`` (or a dict of named
    tensors)."""
    named = params if isinstance(params, dict) \
        else dict(params.named_parameters())
    return {k: param_spec(cfg, k, w.shape, plan, mesh)
            for k, w in named.items()}


def param_shardings(params, cfg: ModelConfig, plan: ShardingPlan,
                    mesh) -> dict[str, tuple]:
    """{parameter name: placements} on ``mesh``."""
    return {k: placements(mesh, s)
            for k, s in param_specs(params, cfg, plan, mesh).items()}


def opt_state_shardings(opt_state: dict, pshard: dict, mesh,
                        plan: ShardingPlan) -> dict:
    """Moments shard exactly like their parameters; step is replicated."""
    out = {"step": placements(mesh, ())}
    for key in ("m", "v"):
        out[key] = {k: pshard[k] for k in opt_state[key]}
    return out


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------

def batch_specs(batch: dict, plan: ShardingPlan, mesh) -> dict:
    b = plan.batch_axes
    n = axis_product(b, mesh_sizes(mesh))

    def one(leaf):
        spec = [b] + [None] * (leaf.ndim - 1)
        if b is not None and leaf.shape[0] % n != 0:
            spec[0] = None
        return tuple(spec)
    return {k: one(v) for k, v in batch.items()}


def batch_shardings(batch: dict, plan: ShardingPlan, mesh) -> dict:
    return {k: placements(mesh, s)
            for k, s in batch_specs(batch, plan, mesh).items()}


def cache_spec(shape, plan: ShardingPlan, mesh) -> tuple:
    """KV caches (B, S, Hkv, D): batch + (kv_heads | kv_seq); recurrent
    states (B, ..., C): batch + channel sharding over ``rnn``."""
    sizes = mesh_sizes(mesh)

    def axis_fits(ax, dim):
        if ax is None:
            return None
        return ax if dim % axis_product(ax, sizes) == 0 else None

    dims = list(shape)
    if len(dims) == 4:                       # (B, S, Hkv, D) attention
        return (axis_fits(plan.batch_axes, dims[0]),
                axis_fits(plan.kv_seq_axes, dims[1]),
                axis_fits(plan.kv_heads_axes, dims[2]), None)
    if len(dims) >= 2:                       # recurrent states
        return (axis_fits(plan.batch_axes, dims[0]),
                *([None] * (len(dims) - 2)),
                axis_fits(plan.rnn_axes if plan.rnn_axes else None, dims[-1]))
    return (None,) * len(dims)


def cache_specs(caches: list[dict], plan: ShardingPlan, mesh) -> list[dict]:
    """One ``{leaf: spec}`` a layer (``TF.init_caches``' layout)."""
    return [{k: cache_spec(v.shape, plan, mesh) for k, v in c.items()}
            for c in caches]


def cache_shardings(caches: list[dict], plan: ShardingPlan,
                    mesh) -> list[dict]:
    return [{k: placements(mesh, s) for k, s in c.items()}
            for c in cache_specs(caches, plan, mesh)]


# ---------------------------------------------------------------------------
# placing trees
# ---------------------------------------------------------------------------

def distribute(t: torch.Tensor, mesh, place) -> torch.Tensor:
    """``t`` (the whole tensor, the same on every rank: real or fake) as a
    DTensor of ``place``.  Each rank keeps its own chunk; nothing is sent
    (``src_data_rank=None``)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, list(place), src_data_rank=None)


def distribute_tree(tree, place, mesh):
    """``tree`` (dicts and lists of tensors) with each leaf a DTensor of
    the placements at the same place in ``place`` (a leaf whose placements
    are None is kept)."""
    if place is None:                    # kept as it is (a step counter)
        return tree
    if isinstance(tree, torch.Tensor):
        return distribute(tree, mesh, place)
    if isinstance(tree, dict):
        return {k: distribute_tree(v, place[k], mesh) for k, v in tree.items()}
    return [distribute_tree(v, p, mesh) for v, p in zip(tree, place)]


def distribute_params(params, cfg: ModelConfig, plan: ShardingPlan, mesh):
    """Replace every parameter of ``params`` (a ``Transformer``) in place
    by a DTensor of its placements; returns ``params``."""
    shardings = param_shardings(params, cfg, plan, mesh)
    for name, place in shardings.items():
        owner, _, leaf = name.rpartition(".")
        mod = params.get_submodule(owner) if owner else params
        old = getattr(mod, leaf)
        setattr(mod, leaf, torch.nn.Parameter(
            distribute(old.detach(), mesh, place), requires_grad=False))
    return params


def gather_tree(tree):
    """``tree`` with every DTensor leaf gathered to the whole tensor (a
    collective: every rank calls it)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, DTensor):
        return tree.full_tensor()
    if isinstance(tree, dict):
        return {k: gather_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_tree(v) for v in tree)
    return tree


def local_bytes(tree) -> int:
    """Bytes this rank holds of ``tree`` (a DTensor's local shard)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if isinstance(tree, DTensor) else tree
        return t.numel() * t.element_size()
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(local_bytes(v) for v in tree)
    return 0
