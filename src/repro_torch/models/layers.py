"""Shared layers of the model zoo: plain functions on tensors.

Port of ``repro.models.layers``.  Conventions, as in the reference:

* parameters live in small modules (:class:`Dense`, :class:`Norm`) whose
  names follow the reference's parameter dicts (``w``, ``b``, ``scale``,
  ``bias``); the layer functions take ``(p, x, ...)``;
* activations run in ``cfg.dtype`` (bf16), parameters are kept in
  ``param_dtype`` (f32) and cast at use; ``convert.to_serving`` casts the
  matmul weights once instead, which gives every product the same inputs;
* the XLA-path attention (:func:`blocked_attention`) walks the reference's
  static schedule of (q-block, kv-block) pairs with an online softmax, so
  causal and local masks skip whole blocks.  Under a mesh it runs on each
  rank's shards (``attention.py``'s local region), whose placements are
  the reference's tags on q, k, v and the softmax state.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.pspec import (is_dtensor, settled, vocab_pick,
                                     whole_last_dim)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# parameters and initializers
# ---------------------------------------------------------------------------

def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def dense_init(gen, d_in: int, d_out: int, *, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """N(0, 1/d_in) weights of shape (d_in, d_out), drawn from ``gen``."""
    w = torch.randn((d_in, d_out), generator=gen, dtype=dtype, device=device)
    return w.mul_(1.0 / math.sqrt(d_in))


def embed_init(gen, vocab: int, d: int, *, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """N(0, 0.02^2) embeddings of shape (vocab, d), drawn from ``gen``."""
    w = torch.randn((vocab, d), generator=gen, dtype=dtype, device=device)
    return w.mul_(0.02)


class Dense(nn.Module):
    """``x @ w (+ b)``: w (d_in, d_out), as the reference stores it."""

    def __init__(self, w: torch.Tensor, bias: bool = False):
        super().__init__()
        self.w = _param(w)
        self.b = _param(torch.zeros(w.shape[1], dtype=w.dtype, device=w.device)) \
            if bias else None


class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale``, ``bias``), kept in f32."""

    def __init__(self, d: int, kind: str = "rmsnorm", device=None):
        super().__init__()
        self.scale = _param(torch.ones(d, device=device))
        self.bias = _param(torch.zeros(d, device=device)) \
            if kind == "layernorm" else None


# ---------------------------------------------------------------------------
# norms, dense, activation
# ---------------------------------------------------------------------------

def apply_norm(p: Norm, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    """The reference's norm: f32 math, eps 1e-6, the scale in f32, the
    result in x's dtype (one fused PyTorch norm each, for fewer launches
    than the reference's formula written out)."""
    d = (x.shape[-1],)
    if type(x) is not torch.Tensor:     # a DTensor (or another subclass)
        x = whole_last_dim(x)
    if kind == "rmsnorm":
        out = F.rms_norm(x.float(), d, p.scale, eps=eps)
    elif kind == "layernorm":
        out = F.layer_norm(x.float(), d, p.scale, p.bias, eps=eps)
    else:
        raise ValueError(kind)
    return out.to(x.dtype)


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w.to(x.dtype)
    if p.b is not None:
        y = y + p.b.to(x.dtype)
    return y


def activate(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(x)
    if act == "gelu":                     # jax.nn.gelu's default, tanh form
        return F.gelu(x, approximate="tanh")
    if act == "relu":
        return F.relu(x)
    raise ValueError(act)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

def rope_tables(positions: torch.Tensor, d: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """RoPE's (cos, sin) for head size ``d`` at ``positions`` (..., S), as
    (..., S, 1, d) f32 tables laid out for :func:`apply_rope`: cos twice,
    and sin with its first half negated.  A step computes them once for
    every layer."""
    half = d // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=positions.device) / half)
    angles = positions[..., None].float() * freq            # (..., S, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    return (torch.cat([cos, cos], -1)[..., None, :],
            torch.cat([-sin, sin], -1)[..., None, :])


def apply_rope(x: torch.Tensor, rot) -> torch.Tensor:
    """x: (..., S, H, D) rotated by ``rot`` (:func:`rope_tables`): halves
    [x1 cos - x2 sin, x2 cos + x1 sin] in f32, the result in x's dtype."""
    half = x.shape[-1] // 2
    cos, sin = rot
    swapped = torch.cat([x[..., half:], x[..., :half]], -1)
    return (x * cos + swapped * sin).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Apply RoPE (halves rotated).  x: (..., S, H, D); positions: (..., S)."""
    return apply_rope(x, rope_tables(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# block-streamed attention (the reference's XLA path)
# ---------------------------------------------------------------------------

def _block_schedule(n_q: int, n_kv: int, block_q: int, block_kv: int,
                    *, causal: bool, window: int | None,
                    q_offset: int) -> np.ndarray:
    """Static (qi, kj) pairs whose blocks are not fully masked."""
    pairs = []
    for qi in range(n_q):
        q_lo = q_offset + qi * block_q
        q_hi = q_lo + block_q - 1
        for kj in range(n_kv):
            k_lo = kj * block_kv
            k_hi = k_lo + block_kv - 1
            if causal and k_lo > q_hi:
                continue
            if window is not None and k_hi < q_lo - window + 1:
                continue
            pairs.append((qi, kj))
    return np.asarray(pairs, dtype=np.int32).reshape(-1, 2)


def _pad_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    return F.pad(t, (0, 0, 0, 0, 0, n)) if n else t


def blocked_attention(q, k, v, *, causal: bool = True,
                      window: int | None = None, q_offset: int = 0,
                      block_q: int = 512, block_kv: int = 1024,
                      softcap: float = 0.0, kv_len=None) -> torch.Tensor:
    """q: (B, Sq, Hq, D), k, v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D) in v's
    dtype.  Scores and the softmax state in f32; P is cast to v's dtype
    before P·V, as in the reference."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads over {Hkv} kv heads")
    G = Hq // Hkv
    block_q = min(block_q, Sq)
    block_kv = min(block_kv, Skv)
    n_q = -(-Sq // block_q)
    n_kv = -(-Skv // block_kv)
    q = _pad_rows(q, n_q * block_q - Sq)
    k = _pad_rows(k, n_kv * block_kv - Skv)
    v = _pad_rows(v, n_kv * block_kv - Skv)

    schedule = _block_schedule(n_q, n_kv, block_q, block_kv, causal=causal,
                               window=window, q_offset=q_offset)
    dev = q.device
    q = (q * (1.0 / math.sqrt(D))).reshape(B, n_q, block_q, Hkv, G, D)
    k = k.reshape(B, n_kv, block_kv, Hkv, D)
    v = v.reshape(B, n_kv, block_kv, Hkv, D)
    # the softmax state of each q-block, replaced (not written in place) at
    # every step, so autograd can differentiate through the schedule
    acc = [torch.zeros((B, block_q, Hkv, G, D), dtype=torch.float32,
                       device=dev) for _ in range(n_q)]
    m = [torch.full((B, block_q, Hkv, G), NEG_INF, dtype=torch.float32,
                    device=dev) for _ in range(n_q)]
    l = [torch.zeros((B, block_q, Hkv, G), dtype=torch.float32, device=dev)
         for _ in range(n_q)]
    q_pos = q_offset + torch.arange(n_q * block_q, device=dev).reshape(n_q, block_q)
    k_pos = torch.arange(n_kv * block_kv, device=dev).reshape(n_kv, block_kv)
    # a Python int unless the limit is a tensor: no host-made constant
    kv_limit = Skv if kv_len is None else torch.as_tensor(kv_len, device=dev)

    for qi, kj in schedule.tolist():
        s = torch.einsum("bqhgd,bkhd->bqhgk", q[:, qi].float(), k[:, kj].float())
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        qp, kp = q_pos[qi], k_pos[kj]
        mask = kp[None, :] < kv_limit
        if causal:
            mask = mask & (kp[None, :] <= qp[:, None])
        if window is not None:
            mask = mask & (kp[None, :] > qp[:, None] - window)
        s = torch.where(mask[None, :, None, None, :], s,
                        torch.full_like(s, NEG_INF))
        m_prev = m[qi]
        m_new = torch.maximum(m_prev, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m_prev - m_new)
        l[qi] = alpha * l[qi] + p.sum(-1)
        acc[qi] = acc[qi] * alpha[..., None] + torch.einsum(
            "bqhgk,bkhd->bqhgd", p.to(v.dtype).float(), v[:, kj].float())
        m[qi] = m_new
    out = torch.stack(acc, 1) / torch.clamp(torch.stack(l, 1)[..., None],
                                            min=1e-30)
    out = out.reshape(B, n_q * block_q, Hq, D)[:, :Sq]
    return out.to(v.dtype)


def dense_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    q_offset: int = 0, softcap: float = 0.0,
                    kv_len=None) -> torch.Tensor:
    """Unblocked attention (the reference's oracle, and its decode path on
    the XLA side): q is scaled in its own dtype, scores and softmax in f32,
    P cast to v's dtype before P·V."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev = q.device
    qq = q.reshape(B, Sq, Hkv, G, D) * (1.0 / math.sqrt(D))
    s = torch.einsum("bqhgd,bkhd->bqhgk", qq.float(), k.float())
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qp = q_offset + torch.arange(Sq, device=dev)
    kp = torch.arange(Skv, device=dev)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=dev)
    if kv_len is not None:
        mask = mask & (kp[None, :] < torch.as_tensor(kv_len, device=dev))
    if causal:
        mask = mask & (kp[None, :] <= qp[:, None])
    if window is not None:
        mask = mask & (kp[None, :] > qp[:, None] - window)
    s = torch.where(mask[None, :, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqhgk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return out.to(v.dtype).reshape(B, Sq, Hq, D)


# ---------------------------------------------------------------------------
# the affine scan (the reference's associative_scan)
# ---------------------------------------------------------------------------

def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along axis 1 (even may be one longer)."""
    n = odd.shape[1]
    both = torch.stack([even[:, :n], odd], 2).flatten(1, 2)
    return torch.cat([both, even[:, n:]], 1) if even.shape[1] > n else both


def associative_scan(a: torch.Tensor, b: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The inclusive scan along axis 1 of the affine pairs (a_t, b_t) under
    (a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2): (prod a, h) with h_t = a_t
    h_{t-1} + b_t.  The recursion of ``jax.lax.associative_scan`` (pairs
    combined, the half scanned, the evens filled in): about 2 log2 S
    elementwise passes, no loop over S."""
    n = a.shape[1]
    if n < 2:
        return a, b
    oa, ob = associative_scan(a[:, 1::2] * a[:, 0:-1:2],
                              a[:, 1::2] * b[:, 0:-1:2] + b[:, 1::2])
    m = a[:, 2::2].shape[1]
    ea = torch.cat([a[:, :1], oa[:, :m] * a[:, 2::2]], 1)
    eb = torch.cat([b[:, :1], a[:, 2::2] * ob[:, :m] + b[:, 2::2]], 1)
    return _interleave(ea, oa), _interleave(eb, ob)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Mean token cross-entropy with z-loss, in f32.  The max is a constant
    to autograd, as the reference's ``stop_gradient`` makes it (its
    gradient cancels in exact arithmetic)."""
    lf = logits.float()
    m = settled(lf.amax(-1, keepdim=True)).detach()
    shifted = lf - m
    lse = torch.log(torch.exp(shifted).sum(-1)) + m[..., 0]
    if is_dtensor(shifted):
        picked = vocab_pick(shifted, labels, shifted.ndim - 1,
                            lambda t, i, inside: t.gather(
                                -1, i[..., None])[..., 0] * inside)
    else:
        picked = shifted.gather(-1, labels.long()[..., None])[..., 0]
    ll = picked + m[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse.square()
    if mask is not None:
        loss = loss * mask
        return loss.sum() / torch.clamp(mask.sum(), min=1.0)
    return loss.mean()
