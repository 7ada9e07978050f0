"""Multi-head latent attention (MLA), DeepSeek-V3's attention block.

Follows the published ``modeling_deepseek.py`` (``DeepseekV3Attention``);
the JAX reference has no such block.  Projections:

* ``q = wq_b(rmsnorm(wq_a(x)))``, each head's 192 columns split into 128
  without position (``nope``) and 64 rotated (``rope``);
* ``wkv_a(x)`` gives a latent of ``kv_lora_rank`` (512) and one rotated
  key of 64 shared by every head; ``wkv_b(rmsnorm(latent))`` gives each
  head's 128-column k_nope and 128-column v.

RoPE: each rotated half is de-interleaved (even columns, then odd), then
rotated by rotate-half at YaRN's frequencies (:func:`yarn_inv_freq`).  The
softmax scale is ``cfg.softmax_scale`` (``mscale² / sqrt(192)``), and
attention is causal over the 192-column q·k with 128-column values, then
``wo`` (H·128 -> d).

Prefill runs K5's 192/128 instance (``kernels.flash_attention.ops.mha``,
one launch a layer a call) with ``cfg.use_kernels`` (on CPU tensors the
wrapper's plain version), otherwise the plain ``attention_ref``; the
projections run under the span ``mla.project`` and the attention under
``mla.core``.  Decode keeps a cache of the normalized latent and the
rotated shared key, 512 + 64 values a token and layer (``init_cache``),
and attends in the latent space: ``wkv_b``'s k half absorbed into the
query and its v half applied after the softmax, in f32 torch products
(no kernel), the same math as decompressing every cached row.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.kernels.flash_attention.ops import attention_ref, mha
from repro_torch.models import layers as L
from repro_torch.models.config import MLAConfig
from repro_torch.runtime import tracing


class MLA(nn.Module):
    """``wq_a`` (d, q_lora), ``q_norm``, ``wq_b`` (q_lora, H·192),
    ``wkv_a`` (d, 512 + 64), ``kv_norm``, ``wkv_b`` (512, H·(128 + 128)),
    ``wo`` (H·128, d)."""

    def __init__(self, cfg: MLAConfig, gen=None, *, device=None):
        super().__init__()
        init = dict(dtype=getattr(torch, cfg.param_dtype), device=device)
        d, H = cfg.d_model, cfg.n_heads
        self.wq_a = L.Dense(L.dense_init(gen, d, cfg.q_lora_rank, **init))
        self.q_norm = L.Norm(cfg.q_lora_rank, "rmsnorm", device=device)
        self.wq_b = L.Dense(L.dense_init(gen, cfg.q_lora_rank,
                                         H * cfg.qk_head_dim, **init))
        self.wkv_a = L.Dense(L.dense_init(
            gen, d, cfg.kv_lora_rank + cfg.qk_rope_dim, **init))
        self.kv_norm = L.Norm(cfg.kv_lora_rank, "rmsnorm", device=device)
        self.wkv_b = L.Dense(L.dense_init(
            gen, cfg.kv_lora_rank, H * (cfg.qk_nope_dim + cfg.v_head_dim),
            **init))
        self.wo = L.Dense(L.dense_init(gen, H * cfg.v_head_dim, d, **init))


def yarn_inv_freq(cfg: MLAConfig, device=None) -> torch.Tensor:
    """YaRN's frequencies of the ``qk_rope_dim`` rotated columns (f32, one
    a pair): ``1/base^(2i/dim)`` and ``1/(factor·base^(2i/dim))`` blended
    by the linear ramp between the correction dimensions of
    ``rope_beta_fast`` and ``rope_beta_slow`` rotations over
    ``rope_original_max`` positions (the first for high frequencies, the
    second for low), as ``DeepseekV3YarnRotaryEmbedding`` computes them."""
    dim, base = cfg.qk_rope_dim, cfg.rope_theta
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / base ** exps
    if cfg.rope_factor <= 1:
        return extra
    inter = 1.0 / (cfg.rope_factor * base ** exps)

    def corr(rotations):
        turns = cfg.rope_original_max / (rotations * 2 * math.pi)
        return dim * math.log(turns) / (2 * math.log(base))
    lo = max(math.floor(corr(cfg.rope_beta_fast)), 0)
    hi = min(math.ceil(corr(cfg.rope_beta_slow)), dim - 1)
    if lo == hi:
        hi += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - lo)
            / (hi - lo)).clamp(0, 1)
    keep = 1.0 - ramp                       # 1: the unscaled frequency
    return inter * (1 - keep) + extra * keep


def rotary(cfg: MLAConfig, positions: torch.Tensor):
    """The rotated columns' (cos, sin) tables at ``positions`` (..., S),
    laid out for ``layers.apply_rope`` and scaled by
    ``cfg.rope_table_scale``: once a step, for every layer."""
    angles = positions[..., None].float() * yarn_inv_freq(cfg,
                                                          positions.device)
    cos = torch.cos(angles) * cfg.rope_table_scale
    sin = torch.sin(angles) * cfg.rope_table_scale
    return (torch.cat([cos, cos], -1)[..., None, :],
            torch.cat([-sin, sin], -1)[..., None, :])


def _rope(x: torch.Tensor, rot) -> torch.Tensor:
    """x (..., S, H, 64) de-interleaved (even columns, then odd), then
    rotated by rotate-half."""
    x = x.unflatten(-1, (-1, 2)).transpose(-1, -2).flatten(-2)
    return L.apply_rope(x, rot)


def _latent(p: MLA, cfg: MLAConfig, x: torch.Tensor, rot):
    """The normalized latent (B, S, 512) and the rotated shared key (B, S,
    1, 64) of x (B, S, d)."""
    kv = L.dense(p.wkv_a, x)
    latent, k_pe = kv.split([cfg.kv_lora_rank, cfg.qk_rope_dim], -1)
    latent = L.apply_norm(p.kv_norm, latent, "rmsnorm")
    return latent, _rope(k_pe[..., None, :], rot)


def _query(p: MLA, cfg: MLAConfig, x: torch.Tensor, rot) -> torch.Tensor:
    """q (B, S, H, 192): its rotated columns rotated in place."""
    B, S, _ = x.shape
    q = L.dense(p.wq_b, L.apply_norm(p.q_norm, L.dense(p.wq_a, x), "rmsnorm"))
    q = q.view(B, S, cfg.n_heads, cfg.qk_head_dim)
    q[..., cfg.qk_nope_dim:] = _rope(q[..., cfg.qk_nope_dim:], rot)
    return q


def forward(p: MLA, cfg: MLAConfig, x: torch.Tensor, rot) -> torch.Tensor:
    """Full-sequence latent attention (prefill) of x (B, S, d): q and k of
    (B, S, H, 192) and v a (B, S, H, 128) view of ``wkv_b``'s output
    through K5 (``mla.core``), then ``wo``."""
    B, S, _ = x.shape
    H, nope = cfg.n_heads, cfg.qk_nope_dim
    with tracing.span("mla.project"):
        q = _query(p, cfg, x, rot)
        latent, k_pe = _latent(p, cfg, x, rot)
        kv = L.dense(p.wkv_b, latent).view(B, S, H, nope + cfg.v_head_dim)
        k = q.new_empty(B, S, H, cfg.qk_head_dim)
        k[..., :nope] = kv[..., :nope]
        k[..., nope:] = k_pe
        v = kv[..., nope:]
    with tracing.span("mla.core"):
        if cfg.use_kernels:
            out = mha(q, k, v, causal=cfg.is_decoder,
                      scale=cfg.softmax_scale)
        else:
            out = attention_ref(q, k, v, causal=cfg.is_decoder,
                                scale=cfg.softmax_scale)
    return L.dense(p.wo, out.reshape(B, S, H * cfg.v_head_dim))


def init_cache(cfg: MLAConfig, batch: int, max_len: int, *,
               device=None) -> dict:
    """One layer's latent cache: the normalized latent (B, max_len, 512)
    and the rotated shared key (B, max_len, 64), in the activation
    dtype."""
    dt = getattr(torch, cfg.kv_cache_dtype or cfg.dtype)
    return {"latent": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                  dtype=dt, device=device),
            "k_pe": torch.zeros((batch, max_len, cfg.qk_rope_dim), dtype=dt,
                                device=device)}


def decode_step(p: MLA, cfg: MLAConfig, x: torch.Tensor, cache: dict,
                index: torch.Tensor, rot) -> torch.Tensor:
    """One token a row, x (B, 1, d), at position ``index`` (a one-element
    long tensor): its latent and rotated key written into ``cache`` in
    place, then attention over rows 0..index in the latent space (f32):
    scores ``(q_nope · W_uk) · latent + q_rope · k_rope``, the softmax, and
    ``(P · latent) · W_uv`` each head's value."""
    B = x.shape[0]
    H, nope, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.v_head_dim
    with tracing.span("mla.project"):
        q = _query(p, cfg, x, rot)[:, 0].float()          # (B, H, 192)
        latent, k_pe = _latent(p, cfg, x, rot)
        cache["latent"].index_copy_(1, index, latent.to(cache["latent"].dtype))
        cache["k_pe"].index_copy_(1, index, k_pe[:, :, 0].to(
            cache["k_pe"].dtype))
    with tracing.span("mla.core"):
        w = p.wkv_b.w.float().view(cfg.kv_lora_rank, H, nope + dv)
        c, r = cache["latent"].float(), cache["k_pe"].float()
        q_lat = torch.einsum("bhn,chn->bhc", q[..., :nope], w[..., :nope])
        s = (torch.einsum("bhc,btc->bht", q_lat, c)
             + torch.einsum("bhr,btr->bht", q[..., nope:], r))
        live = torch.arange(c.shape[1], device=x.device) <= index
        s = (s * cfg.softmax_scale).masked_fill(~live, float("-inf"))
        o_lat = torch.einsum("bht,btc->bhc", torch.softmax(s, dim=-1), c)
        out = torch.einsum("bhc,chv->bhv", o_lat, w[..., nope:])
    return L.dense(p.wo, out.reshape(B, 1, H * dv).to(x.dtype))
