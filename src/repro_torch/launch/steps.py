"""Step functions (train / prefill / decode) of one card.

Port of ``repro.launch.steps``.  One card holds the whole model, so there
is no mesh, sharding plan or jit: a step is a plain function of the
parameters, run eagerly.  ``build_step`` returns the step of one (config,
shape) cell with its inputs as meta tensors (``configs.shapes.
input_specs``); the reference's shardings and plan come with the mesh.

The train step takes its gradients with ``torch.autograd.grad`` through
``TF.loss_fn`` on the plain path only: the kernels have no backward (the
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

import dataclasses
from typing import Callable

import torch

from repro_torch import compat
from repro_torch.configs.shapes import ShapeSpec, input_specs
from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import reference_ndim
from repro_torch.optim.adamw import OptimizerConfig, adamw_init, adamw_update_
from repro_torch.runtime.compression import compress_grads, decompress_grads


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = OptimizerConfig()
    grad_compression: str = "none"      # none | bf16 | int8
    # The reference's sharding knobs, carried for parity; one card reads
    # neither.
    kv_shard: str = "auto"              # auto | heads | seq
    fsdp_decode: bool = True


@dataclasses.dataclass
class BuiltStep:
    fn: Callable
    args: tuple                          # meta tensors (the step's inputs)
    kind: str
    device: torch.device                 # where the step's tensors live


def batch_to_device(batch: dict, device) -> dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig):
    """train_step(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` is a ``Transformer`` and ``opt_state`` its ``adamw_init``
    state (keyed by parameter name); both are updated in place and
    returned.  The batch's arrays are moved to the parameters' device.
    Metrics ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr`` are 0-dim
    tensors on that device, as the reference returns them."""
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
        for w in weights:
            w.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss, metrics = TF.loss_fn(params, cfg, batch)
                grads = torch.autograd.grad(loss, weights, allow_unused=True)
        finally:
            for w in weights:
                w.requires_grad_(False)
        grads = {k: torch.zeros_like(w) if g is None else g
                 for (k, w), g in zip(named.items(), grads)}
        if tcfg.grad_compression != "none":
            wire, _ = compress_grads(grads, tcfg.grad_compression)
            grads = decompress_grads(wire, tcfg.grad_compression, grads)
            del wire
        om, _ = adamw_update_(grads, opt_state, named, tcfg.optimizer,
                              decayed)
        out = {"loss": loss.detach(),
               **{k: v.detach() for k, v in metrics.items()}, **om}
        return params, opt_state, out
    return train_step


def make_prefill_step(cfg: ModelConfig):
    """prefill_step(params, batch) -> logits at the last position (B, 1, V)."""
    def prefill_step(params, batch):
        with torch.no_grad():
            x = TF.embed_inputs(params, cfg, tokens=batch.get("tokens"),
                                features=batch.get("features"))
            h, _ = TF.forward_hidden(params, cfg, x)
            return TF.logits_fn(params, cfg, h[:, -1:, :])
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """serve_step(params, tokens, caches, index) -> (next tokens (B, 1) int32,
    logits (B, V), caches): one decode step and its greedy (argmax) pick;
    the caches are updated in place."""
    def serve_step(params, tokens, caches, index):
        with torch.no_grad():
            logits, caches = TF.decode_step(params, cfg, tokens, caches, index)
            next_tok = logits.argmax(-1).to(torch.int32)[:, None]
        return next_tok, logits, caches
    return serve_step


def build_step(cfg: ModelConfig, shape: ShapeSpec,
               tcfg: TrainConfig = TrainConfig(), *, device=None) -> BuiltStep:
    """The step of one (config, shape) cell, its inputs as meta tensors
    (parameters, optimizer state and batch for ``train``; parameters and
    batch for ``prefill``; parameters, tokens, caches and index for
    ``decode``/``long_decode``), and the device its tensors go to (default:
    the CUDA card; raises without one)."""
    dev = compat.resolve_device(device)
    specs = input_specs(cfg, shape)
    params = TF.Transformer(cfg, device="meta")
    if shape.kind == "train":
        opt = adamw_init(dict(params.named_parameters()), tcfg.optimizer)
        return BuiltStep(fn=make_train_step(cfg, tcfg),
                         args=(params, opt, specs["batch"]), kind="train",
                         device=dev)
    if shape.kind == "prefill":
        return BuiltStep(fn=make_prefill_step(cfg),
                         args=(params, specs["batch"]), kind="prefill",
                         device=dev)
    return BuiltStep(fn=make_decode_step(cfg),
                     args=(params, specs["tokens"], specs["caches"],
                           specs["index"]), kind=shape.kind, device=dev)
