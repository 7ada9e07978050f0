"""Step functions (train / prefill / decode), on one card or a mesh.

Port of ``repro.launch.steps``.  A step is a plain function of the
parameters, run eagerly (there is no jit).  ``build_step`` returns the
step of one (config, shape) cell with its inputs as meta tensors
(``configs.shapes.input_specs``).

On one card (``mesh=None``) the step runs as it is.  With a ``DeviceMesh``
it follows the reference's sharded step: the plan comes from
``sharding.make_plan(..., kv_shard=tcfg.kv_shard, kind=shape.kind,
fsdp_decode=tcfg.fsdp_decode)``; the parameters, the AdamW moments, the
batch and the caches are DTensors placed by the plan
(``BuiltStep.shardings``; ``place_params``, ``place_opt_state``,
``place_batch`` and ``place_caches`` place real or fake trees by them)
and the step runs under ``pspec.axis_rules(mesh, plan.rules())``.  A
mesh of more than one rank runs the plain path: ``use_kernels=True``
raises, as the reference's dry-run keeps XLA.

The train step takes its gradients with ``torch.autograd.grad`` through
``TF.loss_fn`` (on a mesh each gradient reduced once to its parameter's
placements) on the plain path only: the kernels have no backward (the
reference's Pallas kernels have none either, and its ``jax.grad``
through ``use_pallas=True`` raises), so ``make_train_step`` refuses a
config with ``use_kernels=True`` and every kernel wrapper refuses a tensor
that requires grad.  The optimizer writes in place (``adamw_update_``),
the counterpart of the reference's donated parameters and state, and
decays the leaves the reference decays: those of two or more dimensions
in its tree, where the scanned layers' norms and biases are stacked into
matrices (``convert.reference_ndim``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch

from repro_torch import compat
from repro_torch.configs.shapes import ShapeSpec, input_specs
from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import reference_ndim
from repro_torch.models.pspec import axis_rules, is_dtensor, whole_last_dim
from repro_torch.launch import sharding as SH
from repro_torch.optim.adamw import OptimizerConfig, adamw_init, adamw_update_
from repro_torch.runtime import tracing
from repro_torch.runtime.compression import compress_grads, decompress_grads


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = OptimizerConfig()
    grad_compression: str = "none"      # none | bf16 | int8
    # sharding knobs of a mesh step (make_plan); one card reads neither
    kv_shard: str = "auto"              # auto | heads | seq
    fsdp_decode: bool = True


@dataclasses.dataclass
class BuiltStep:
    fn: Callable
    args: tuple                          # meta tensors (the step's inputs)
    kind: str
    device: torch.device                 # where the step's tensors live
    mesh: Any = None                     # the DeviceMesh, or None
    plan: SH.ShardingPlan | None = None
    #: placements of the step's inputs on ``mesh``, as ``args`` nests
    #: them (``params`` and, by kind, ``opt``, ``batch``, ``caches``)
    shardings: dict | None = None


def _rules(mesh, plan):
    return axis_rules(mesh, plan.rules()) if mesh is not None \
        else contextlib.nullcontext()


def _whole(tree):
    """Metrics as plain tensors (a DTensor gathered)."""
    return {k: v.full_tensor() if is_dtensor(v) else v
            for k, v in tree.items()}


def _as_param(grad: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A gradient in its parameter's placements: autograd hands a mesh
    parameter's gradient back partial over the dims its uses were split
    on, and each later use of a partial value reduces it again (the norm,
    the first and the second moment: three reductions of one gradient);
    reduced once here, as the reference reduces each gradient once."""
    if is_dtensor(grad) and tuple(grad.placements) != tuple(w.placements):
        return grad.redistribute(w.device_mesh, w.placements)
    return grad


def batch_to_device(batch: dict, device) -> dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on ``device`` (a
    DTensor, already placed, as it is)."""
    return {k: v if is_dtensor(v) else torch.as_tensor(v, device=device)
            for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh=None,
                    plan: SH.ShardingPlan | None = None):
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` is a ``Transformer`` and ``opt_state`` its ``adamw_init``
    state (keyed by parameter name); both are updated in place and
    returned.  The batch's arrays are moved to the parameters' device.
    Metrics ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr`` are 0-dim
    tensors on that device, as the reference returns them.  With ``mesh``
    the parameters and moments are DTensors (``place_params``,
    ``place_opt_state``), the batch is placed by the plan and the metrics
    come back whole."""
    if cfg.use_kernels:
        raise ValueError(
            "make_train_step differentiates the plain path only: the kernels "
            "have no backward; build the config with use_kernels=False")

    def train_step(params, opt_state, batch):
        named = dict(params.named_parameters())
        decayed = {k for k, w in named.items()
                   if reference_ndim(cfg, k, w) >= 2}
        weights = list(named.values())
        batch = batch_to_device(batch, weights[0].device)
        if mesh is not None:
            batch = place_batch(batch, plan, mesh)
        for w in weights:
            w.requires_grad_(True)
        try:
            with torch.enable_grad(), _rules(mesh, plan):
                loss, metrics = TF.loss_fn(params, cfg, batch)
                grads = torch.autograd.grad(loss, weights, allow_unused=True)
        finally:
            for w in weights:
                w.requires_grad_(False)
        grads = {k: torch.zeros_like(w) if g is None else _as_param(g, w)
                 for (k, w), g in zip(named.items(), grads)}
        with _rules(mesh, plan):
            if tcfg.grad_compression != "none":
                wire, _ = compress_grads(grads, tcfg.grad_compression)
                grads = decompress_grads(wire, tcfg.grad_compression, grads)
                del wire
            om, _ = adamw_update_(grads, opt_state, named, tcfg.optimizer,
                                  decayed)
        out = {"loss": loss.detach(),
               **{k: v.detach() for k, v in metrics.items()}, **om}
        return params, opt_state, _whole(out)
    return train_step


def make_prefill_step(cfg: ModelConfig, mesh=None,
                      plan: SH.ShardingPlan | None = None):
    """prefill_step(params, batch) -> logits at the last position (B, 1, V)
    (a DTensor on a mesh; the batch is placed by the plan)."""
    def prefill_step(params, batch):
        with tracing.root("prefill_step", params.ln_f.scale.device):
            if mesh is not None:
                batch = place_batch(batch, plan, mesh)
            with torch.no_grad(), _rules(mesh, plan):
                x = TF.embed_inputs(params, cfg, tokens=batch.get("tokens"),
                                    features=batch.get("features"))
                h, _ = TF.forward_hidden(params, cfg, x)
                return TF.logits_fn(params, cfg, h[:, -1:, :])
    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None,
                     plan: SH.ShardingPlan | None = None):
    """serve_step(params, tokens, caches, index) -> (next tokens (B, 1) int32,
    logits (B, V), caches): one decode step and its greedy (argmax) pick;
    the caches are updated in place (on a mesh: DTensors placed by
    ``place_caches``; the tokens are placed by the plan, the logits and
    next tokens are DTensors)."""
    def serve_step(params, tokens, caches, index):
        # the host paces a decode step: its spans are timed on the host's
        # clock alone (a CUDA event a span edge would slow the step)
        with tracing.root("decode_step"):
            if mesh is not None:
                tokens = place_batch({"tokens": tokens}, plan, mesh)["tokens"]
            with torch.no_grad(), _rules(mesh, plan):
                logits, caches = TF.decode_step(params, cfg, tokens, caches,
                                                index)
                next_tok = whole_last_dim(logits).argmax(-1).to(
                    torch.int32)[:, None]
            return next_tok, logits, caches
    return serve_step


# ---------------------------------------------------------------------------
# placing a step's inputs on a mesh
# ---------------------------------------------------------------------------

def place_params(params: TF.Transformer, cfg: ModelConfig,
                 plan: SH.ShardingPlan, mesh) -> TF.Transformer:
    """``params`` (whole on every rank: real, or fake under a fake mode)
    with each parameter a DTensor of the plan, in place."""
    return SH.distribute_params(params, cfg, plan, mesh)


def place_opt_state(opt_state: dict, params: TF.Transformer,
                    cfg: ModelConfig, plan: SH.ShardingPlan, mesh) -> dict:
    """``adamw_init``'s state with each moment a DTensor of its
    parameter's placements (the step whole on every rank)."""
    pshard = SH.param_shardings(params, cfg, plan, mesh)
    place = SH.opt_state_shardings(opt_state, pshard, mesh, plan)
    return {"step": opt_state["step"],
            "m": SH.distribute_tree(opt_state["m"], place["m"], mesh),
            "v": SH.distribute_tree(opt_state["v"], place["v"], mesh)}


def place_batch(batch: dict, plan: SH.ShardingPlan, mesh) -> dict:
    """The batch's tensors (whole on every rank) as DTensors of the plan;
    a leaf that is already a DTensor is kept."""
    place = SH.batch_shardings(batch, plan, mesh)
    return {k: v if is_dtensor(v) else SH.distribute(v, mesh, place[k])
            for k, v in batch.items()}


def place_caches(caches: list[dict], plan: SH.ShardingPlan, mesh
                 ) -> list[dict]:
    """``TF.init_caches``' states as DTensors of the plan."""
    return SH.distribute_tree(caches, SH.cache_shardings(caches, plan, mesh),
                              mesh)


def build_step(cfg: ModelConfig, shape: ShapeSpec,
               tcfg: TrainConfig = TrainConfig(), *, mesh=None,
               device=None) -> BuiltStep:
    """The step of one (config, shape) cell, its inputs as meta tensors
    (parameters, optimizer state and batch for ``train``; parameters and
    batch for ``prefill``; parameters, tokens, caches and index for
    ``decode``/``long_decode``), and the device its tensors go to (default:
    the CUDA card; raises without one).  With ``mesh`` the step is the
    sharded one and ``shardings`` holds its inputs' placements."""
    dev = compat.resolve_device(device)
    specs = input_specs(cfg, shape)
    params = TF.Transformer(cfg, device="meta")
    plan = shardings = None
    if mesh is not None:
        if cfg.use_kernels and mesh.size() > 1:
            raise ValueError(
                "a mesh of more than one rank runs the plain path: build "
                "the config with use_kernels=False")
        plan = SH.make_plan(cfg, mesh, global_batch=shape.global_batch,
                            kv_shard=tcfg.kv_shard, kind=shape.kind,
                            fsdp_decode=tcfg.fsdp_decode)
        shardings = {"params": SH.param_shardings(params, cfg, plan, mesh)}
    sharded = dict(mesh=mesh, plan=plan)
    if shape.kind == "train":
        opt = adamw_init(dict(params.named_parameters()), tcfg.optimizer)
        if mesh is not None:
            shardings["opt"] = SH.opt_state_shardings(
                opt, shardings["params"], mesh, plan)
            shardings["batch"] = SH.batch_shardings(specs["batch"], plan, mesh)
        return BuiltStep(fn=make_train_step(cfg, tcfg, **sharded),
                         args=(params, opt, specs["batch"]), kind="train",
                         device=dev, shardings=shardings, **sharded)
    if shape.kind == "prefill":
        if mesh is not None:
            shardings["batch"] = SH.batch_shardings(specs["batch"], plan, mesh)
        return BuiltStep(fn=make_prefill_step(cfg, **sharded),
                         args=(params, specs["batch"]), kind="prefill",
                         device=dev, shardings=shardings, **sharded)
    if mesh is not None:
        shardings["caches"] = SH.cache_shardings(specs["caches"], plan, mesh)
    return BuiltStep(fn=make_decode_step(cfg, **sharded),
                     args=(params, specs["tokens"], specs["caches"],
                           specs["index"]), kind=shape.kind, device=dev,
                     shardings=shardings, **sharded)
