"""AdamW with global-norm clipping, a warmup + cosine schedule and a
configurable moment dtype, as plain functions on dicts of tensors.

Port of ``repro.optim.adamw``: the same schedule (computed in float32),
the same clipping and the same update — moments kept in ``state_dtype``
and dequantized to float32 for the arithmetic, parameters updated in
float32 and cast back to their own dtype, decoupled weight decay on
matrices only.  ``torch.optim.AdamW`` is not used: its schedule and
clipping are not these.

:func:`adamw_update` returns new dicts; :func:`adamw_update_` is its
in-place counterpart for the trainer (the reference donates its parameters
and state to the jitted step instead): the same arithmetic leaf by leaf,
written into the parameters and moments, each gradient dropped once used,
so a step never holds a second copy of the parameters and moments.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Collection

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    state_dtype: str = "float32"      # "bfloat16" halves m/v memory


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to ``min_lr_ratio * lr`` (float32)."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def adamw_init(params: dict[str, torch.Tensor], cfg: OptimizerConfig) -> dict:
    dt = _DTYPES[cfg.state_dtype]
    dev = next(iter(params.values())).device if params else None
    return {
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "m": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
              for k, p in params.items()},
        "v": {k: torch.zeros(p.shape, dtype=dt, device=p.device)
              for k, p in params.items()},
    }


def global_norm(tree: dict[str, torch.Tensor]) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.to(torch.float32)))
              for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def adamw_update(grads: dict[str, torch.Tensor], state: dict,
                 params: dict[str, torch.Tensor], cfg: OptimizerConfig,
                 ) -> tuple[dict, dict, dict]:
    """Returns ``(new_params, new_state, metrics)``."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)
    dt = _DTYPES[cfg.state_dtype]
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].to(torch.float32) * scale
        mf = b1 * state["m"][k].to(torch.float32) + (1 - b1) * g
        vf = b2 * state["v"][k].to(torch.float32) + (1 - b2) * torch.square(g)
        delta = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
        if p.ndim >= 2:  # decoupled decay on matrices only
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        new_p[k] = (p.to(torch.float32) - lr * delta).to(p.dtype)
        new_m[k] = mf.to(dt)
        new_v[k] = vf.to(dt)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, {"step": step, "m": new_m, "v": new_v}, metrics


def adamw_update_(grads: dict[str, torch.Tensor], state: dict,
                  params: dict[str, torch.Tensor], cfg: OptimizerConfig,
                  decayed: Collection[str] | None = None,
                  ) -> tuple[dict, torch.Tensor]:
    """:func:`adamw_update` in place: writes the new parameters into
    ``params``' tensors, the moments into ``state["m"]``/``state["v"]``
    and the new step into ``state["step"]``, and pops each gradient from
    ``grads`` once it has been used.  ``decayed`` names the leaves that take weight decay
    (default: those of two or more dimensions, as :func:`adamw_update`).
    Returns ``(metrics, new step)``; with the default every value is the
    one :func:`adamw_update` computes, bit for bit."""
    with torch.no_grad():
        step = state["step"].add_(1)
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        lr = lr_schedule(cfg, step)
        b1, b2 = cfg.b1, cfg.b2
        bc1 = 1 - b1 ** step.to(torch.float32)
        bc2 = 1 - b2 ** step.to(torch.float32)
        dt = _DTYPES[cfg.state_dtype]
        for k, p in params.items():
            g = grads.pop(k).to(torch.float32) * scale
            m, v = state["m"][k], state["v"][k]
            mf = b1 * m.to(torch.float32) + (1 - b1) * g
            vf = b2 * v.to(torch.float32) + (1 - b2) * torch.square(g)
            del g
            delta = (mf / bc1) / (torch.sqrt(vf / bc2) + cfg.eps)
            if (p.ndim >= 2 if decayed is None else k in decayed):
                delta = delta + cfg.weight_decay * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
            m.copy_(mf.to(dt))
            v.copy_(vf.to(dt))
    return {"grad_norm": gnorm, "lr": lr}, step
