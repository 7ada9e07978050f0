"""The model zoo's phases (train / prefill / decode) as captured records.

Port of ``repro.workload.steps``.  The reference lowers each phase to HLO
from shape structs; the port builds the shipped transformer stack and its
inputs inside a ``FakeTensorMode`` (no parameter is materialized: the
weights' draw makes fake tensors) and captures the phase op by op
(:func:`repro_torch.workload.capture.walk_callable`).  Every phase runs
with ``use_kernels=False``, as the reference lowers with its
``use_pallas=False`` default, so a capture never reaches a kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import compat
from repro_torch.models import transformer as TF
from repro_torch.workload.capture import fake_mode, walk_callable
from repro_torch.workload.walker import OpRecord

__all__ = ["PHASES", "phase_callable", "phase_records", "param_bytes"]

PHASES = ("train", "prefill", "decode")


def _check_cfg(cfg) -> None:
    if getattr(cfg, "frontend", None):
        raise ValueError(
            f"workload.steps captures token-frontend models only; "
            f"{cfg.name!r} has frontend={cfg.frontend!r} (build the phase "
            f"callable yourself and pass it to Session.estimate_model)")


def phase_callable(cfg, phase: str, *, batch: int, seq_len: int,
                   device=None) -> tuple[Callable, tuple[Any, ...]]:
    """(fn, example_args) for one phase of the shipped transformer stack,
    with the model and its inputs as fake tensors on ``device`` (default:
    the CUDA card; raises without one).

    ``train`` is the loss and the gradients of every parameter
    (``torch.autograd.grad`` over ``loss_fn``), ``prefill`` runs the stack
    over the full prompt and keeps the last position's logits, ``decode``
    is one cached decoding step at position ``seq_len - 1`` (its caches
    written in place).
    """
    _check_cfg(cfg)
    if phase not in PHASES:
        raise ValueError(f"unknown phase {phase!r}; pick one of {PHASES}")
    cfg = dataclasses.replace(cfg, use_kernels=False)
    dev = compat.resolve_device(device)
    with fake_mode():
        params = TF.Transformer(cfg, device=dev)
        tok = torch.zeros((batch, seq_len), dtype=torch.int32, device=dev)

        if phase == "train":
            weights = list(params.parameters())
            for w in weights:
                w.requires_grad_(True)

            def train(params, tokens, labels):
                with torch.enable_grad():
                    loss, _ = TF.loss_fn(params, cfg, {"tokens": tokens,
                                                       "labels": labels})
                    grads = torch.autograd.grad(loss, weights,
                                                allow_unused=True)
                return loss, grads
            return train, (params, tok, tok)

        if phase == "prefill":
            def prefill(params, tokens):
                with torch.no_grad():
                    x = TF.embed_inputs(params, cfg, tokens=tokens)
                    h, _ = TF.forward_hidden(params, cfg, x)
                    return TF.logits_fn(params, cfg, h[:, -1:, :])
            return prefill, (params, tok)

        caches = TF.init_caches(cfg, batch, seq_len, device=dev)
        index = torch.full((1,), seq_len - 1, dtype=torch.int64, device=dev)

        def decode(params, tokens, caches, index):
            with torch.no_grad():
                return TF.decode_step(params, cfg, tokens, caches, index)
        return decode, (params, tok[:, :1], caches, index)


def phase_records(cfg, phase: str, *, batch: int, seq_len: int,
                  device=None) -> list[OpRecord]:
    """Per-op records of one captured phase (the counterpart of the
    reference's ``phase_hlo`` walked by ``walk_module``)."""
    fn, args = phase_callable(cfg, phase, batch=batch, seq_len=seq_len,
                              device=device)
    return walk_callable(fn, *args)


def param_bytes(cfg) -> float:
    """Total parameter bytes, from the model built on the ``meta`` device
    (nothing materialized).  Feeds the data-parallel gradient all-reduce
    term of the sharding axis in :mod:`repro_torch.workload.sweep`."""
    model = TF.Transformer(cfg, device="meta")
    return float(sum(p.numel() * p.element_size()
                     for p in model.parameters()))
