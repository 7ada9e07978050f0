"""GQA attention block: projections, RoPE, the KV cache, and the kernels.

Port of ``repro.models.attention``.  Prefill runs flash attention (K5,
``kernels.flash_attention.ops.mha``) and every decode step decode attention
(K4, ``kernels.decode_attention.ops.gqa_decode``) when ``cfg.use_kernels``;
otherwise the reference's XLA-path attention (``blocked_attention``,
``dense_attention``).  The reference's ``_maybe_repeat_kv`` and sharding
tags act only on a mesh; on one card they are no-ops and are left out.

K and V stay two products (no fused QKV whose slices would be views with
other strides): flash attention takes k and v of one stride layout, and
decode attention a contiguous q.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.decode_attention.ops import gqa_decode
from repro_torch.kernels.flash_attention.ops import mha
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, gen=None, *, device=None):
        super().__init__()
        init = dict(dtype=getattr(torch, cfg.param_dtype), device=device)
        d = cfg.d_model
        self.wq = L.Dense(L.dense_init(gen, d, cfg.q_dim, **init), cfg.qkv_bias)
        self.wk = L.Dense(L.dense_init(gen, d, cfg.kv_dim, **init), cfg.qkv_bias)
        self.wv = L.Dense(L.dense_init(gen, d, cfg.kv_dim, **init), cfg.qkv_bias)
        self.wo = L.Dense(L.dense_init(gen, cfg.q_dim, d, **init), cfg.o_bias)
        if cfg.use_qk_norm:
            self.q_norm = L.Norm(cfg.head_dim, "rmsnorm", device=device)
            self.k_norm = L.Norm(cfg.head_dim, "rmsnorm", device=device)


def rotary(cfg: ModelConfig, positions: torch.Tensor):
    """RoPE tables at ``positions`` (``layers.rope_tables``), computed once
    a step and shared by every layer."""
    return L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)


def _qkv(p: Attention, cfg: ModelConfig, x: torch.Tensor, rot):
    """Projections and RoPE (``rot`` from :func:`rotary` at the tokens'
    positions, where the reference takes the positions)."""
    B, S, _ = x.shape
    q = L.dense(p.wq, x).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = L.dense(p.wk, x).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = L.dense(p.wv, x).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.use_qk_norm:
        q = L.apply_norm(p.q_norm, q, "rmsnorm")
        k = L.apply_norm(p.k_norm, k, "rmsnorm")
    if cfg.is_decoder or cfg.frontend != "audio":
        q = L.apply_rope(q, rot)
        k = L.apply_rope(k, rot)
    return q, k, v


def forward(p: Attention, cfg: ModelConfig, x: torch.Tensor, *,
            local: bool = False, rot=None) -> torch.Tensor:
    """Full-sequence attention (training / prefill); ``rot`` defaults to
    the tables of positions 0..S-1."""
    B, S, _ = x.shape
    if rot is None:
        rot = rotary(cfg, torch.arange(S, device=x.device)[None, :])
    q, k, v = _qkv(p, cfg, x, rot)
    window = cfg.local_window if local else None
    if cfg.use_kernels:
        out = mha(q, k, v, causal=cfg.is_decoder, window=window,
                  softcap=cfg.logit_softcap, block_q=cfg.attn_block_q,
                  block_kv=cfg.attn_block_kv)
    else:
        out = L.blocked_attention(q, k, v, causal=cfg.is_decoder, window=window,
                                  block_q=cfg.attn_block_q,
                                  block_kv=cfg.attn_block_kv,
                                  softcap=cfg.logit_softcap)
    return L.dense(p.wo, out.reshape(B, S, cfg.q_dim))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               local: bool = False, device=None) -> dict:
    """KV cache for one attention layer.  Local layers keep a ring buffer of
    ``local_window`` positions; full layers keep ``max_len``."""
    length = min(cfg.local_window, max_len) if local else max_len
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    dt = getattr(torch, cfg.kv_cache_dtype or cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def decode_step(p: Attention, cfg: ModelConfig, x: torch.Tensor, cache: dict,
                index: torch.Tensor, *, local: bool = False, rot=None
                ) -> tuple[torch.Tensor, dict]:
    """One-token decode at position ``index`` (a one-element int64 tensor on
    x's device; ``rot`` defaults to its RoPE tables): the new K/V row is
    written into ``cache`` in place at its slot, then the token attends
    over the cache's first ``kv_len`` rows.  Nothing is read back to the
    host.

    The cache read is the memory-bound hot loop this framework's analytical
    model is about: every step streams the live (B, S, Hkv, D) cache.
    """
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"decode takes one token per row, got {S}")
    if rot is None:
        rot = rotary(cfg, index.reshape(1, 1))
    q, k, v = _qkv(p, cfg, x, rot)
    ck, cv = cache["k"], cache["v"]
    length = ck.shape[1]
    slot = index % length if local else index
    ck.index_copy_(1, slot, k.to(ck.dtype))
    cv.index_copy_(1, slot, v.to(cv.dtype))
    kv_len = torch.clamp(index + 1, max=length) if local else index + 1
    # the cache is stored in kv_cache_dtype; the attention reads it in q's
    ck_c, cv_c = ck.to(q.dtype), cv.to(q.dtype)
    if cfg.use_kernels:
        # ring buffer: every slot older than the window has been
        # overwritten, so all valid slots attend
        out = gqa_decode(q, ck_c, cv_c, kv_len, softcap=cfg.logit_softcap)
    else:
        out = L.dense_attention(q, ck_c, cv_c, causal=False, kv_len=kv_len,
                                softcap=cfg.logit_softcap)
    y = L.dense(p.wo, out.reshape(B, 1, cfg.q_dim))
    return y, cache
