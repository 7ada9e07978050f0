"""Prefill and decode step functions (port of ``repro.launch.steps``).

One card holds the whole model, so there is no mesh, sharding plan or jit:
a step is a plain function of the parameters, run eagerly under
``torch.no_grad``.  The train step comes with the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as TF
from repro_torch.models.config import ModelConfig


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
