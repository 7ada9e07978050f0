"""Dense MLP (GLU or plain two-layer).  Port of ``repro.models.mlp``."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.pspec import shard


class MLP(nn.Module):
    """``wi`` (and ``wg`` for a GLU) up, ``wo`` down."""

    def __init__(self, cfg: ModelConfig, gen=None, *, device=None,
                 d_in: int | None = None, d_ff: int | None = None):
        super().__init__()
        d = d_in or cfg.d_model
        f = d_ff or cfg.d_ff
        pd = getattr(torch, cfg.param_dtype)
        init = dict(dtype=pd, device=device)
        self.wi = L.Dense(L.dense_init(gen, d, f, **init), cfg.mlp_bias)
        self.wg = L.Dense(L.dense_init(gen, d, f, **init), cfg.mlp_bias) \
            if cfg.glu else None
        self.wo = L.Dense(L.dense_init(gen, f, d, **init), cfg.mlp_bias)


def forward(p: MLP, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = L.dense(p.wi, x)
    if cfg.glu:
        h = L.activate(L.dense(p.wg, x), cfg.act) * h
    else:
        h = L.activate(h, cfg.act)
    h = shard(h, "batch", "seq", "ff")
    return L.dense(p.wo, h)
