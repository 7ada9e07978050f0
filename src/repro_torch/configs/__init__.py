"""Architecture + shape registry (``--arch <id>`` selectable).

Port of ``repro.configs``."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.archs import ARCHS
from repro_torch.configs.shapes import SHAPES, ShapeSpec, cell_status, input_specs
from repro_torch.models.config import ModelConfig


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> list[str]:
    return sorted(ARCHS)


def all_cells() -> list[tuple[str, str]]:
    """All 40 assigned (arch x shape) cells, in registry order."""
    return [(a, s) for a in list_archs() for s in SHAPES]


def reduced_config(cfg: ModelConfig, *, layers_scale: int = 1) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests.

    Keeps the block pattern, GQA ratio, MoE routing structure, frontend and
    norm/activation choices; shrinks every width so one train step runs on a
    single CPU device in seconds.
    """
    n_kv = max(1, min(cfg.n_kv_heads, 2))
    n_heads = max(n_kv, 4 if cfg.n_heads >= 4 else cfg.n_heads)
    n_heads = (n_heads // n_kv) * n_kv or n_kv
    pattern_layers = len(cfg.block_pattern) * layers_scale
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=pattern_layers + len(cfg.remainder_pattern),
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_head=16,
        d_ff=cfg.d_ff and 128,
        vocab_size=128,
        n_experts=min(cfg.n_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        block_pattern=cfg.block_pattern,
        remainder_pattern=cfg.remainder_pattern,
        frontend_dim=cfg.frontend_dim and 16,
        local_window=16,
        chunk_size=8,
        attn_block_q=16,
        attn_block_kv=16,
        rope_theta=min(cfg.rope_theta, 10_000.0),
        d_rnn=0,
        remat=False,
    )
