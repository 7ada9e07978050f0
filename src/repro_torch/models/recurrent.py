"""RG-LRU recurrent block (RecurrentGemma / Griffin).

Port of ``repro.models.recurrent``.  Block:

    x -> [in-proj -> causal conv(4) -> RG-LRU] * gelu(gate-proj) -> out-proj

RG-LRU cell (Griffin Eq. 1-4, diagonal gates):
    r_t = sigmoid(w_r * x_t + b_r)                    recurrence gate
    i_t = sigmoid(w_i * x_t + b_i)                    input gate
    a_t = exp(c * softplus(Lambda) * (-r_t))          per-channel decay
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The full sequence runs the scan K6 (``kernels.rglru.ops.scan``) when
``cfg.use_kernels``, else the log-depth ``layers.associative_scan``; decode
is the O(1) update, written into the state in place.  The temporal conv is
four shifted adds in the activation dtype, the last three inputs carried as
decode state.  Under a mesh the block carries the reference's two tags
(``rnn`` on the conv output and on the gated scan output) and the scan
runs on each rank's shards (``pspec.local_call``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.rglru.ops import scan as rglru_scan
from repro_torch.models import layers as L
from repro_torch.models import pspec
from repro_torch.models.config import ModelConfig
from repro_torch.models.pspec import shard

_C = 8.0  # Griffin's fixed gate sharpness


class Recurrent(nn.Module):
    """``wx``, ``wgate``, ``conv`` (W, w), ``gate_r`` and ``gate_i`` (2, w:
    [w, b] of a diagonal gate, zero), ``lam`` (w) and ``wo``."""

    #: tensors besides the Dense weights that the reference casts to the
    #: activation dtype at use (``convert.to_serving``)
    serving_cast = ("conv",)

    def __init__(self, cfg: ModelConfig, gen=None, *, device=None):
        super().__init__()
        init = dict(dtype=getattr(torch, cfg.param_dtype), device=device)
        d, w, W = cfg.d_model, cfg.rnn_width, cfg.conv_width
        self.wx = L.Dense(L.dense_init(gen, d, w, **init))
        self.wgate = L.Dense(L.dense_init(gen, d, w, **init))
        conv = torch.randn((W, w), generator=gen, **init) / math.sqrt(W)
        self.conv = nn.Parameter(conv, requires_grad=False)
        self.gate_r = nn.Parameter(torch.zeros((2, w), **init), requires_grad=False)
        self.gate_i = nn.Parameter(torch.zeros((2, w), **init), requires_grad=False)
        # Lambda so that a^c lies in ~(0.9, 0.999) (Griffin A.2): softplus^-1
        lam = torch.empty((w,), **init).uniform_(0.9 ** 2, 0.999 ** 2,
                                                  generator=gen)
        lam = torch.log(torch.expm1(torch.exp(torch.log(-torch.log(lam)) / _C)))
        self.lam = nn.Parameter(lam, requires_grad=False)
        self.wo = L.Dense(L.dense_init(gen, w, d, **init))


def _decay_and_input(p: Recurrent, x: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-step (a_t, b_t) of the affine recurrence h = a*h + b, in f32."""
    xf = x.float()
    r = torch.sigmoid(xf * p.gate_r[0] + p.gate_r[1])
    i = torch.sigmoid(xf * p.gate_i[0] + p.gate_i[1])
    log_a = -_C * F.softplus(p.lam.float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) * (i * xf)
    return a, b


def _conv(conv: torch.Tensor, x: torch.Tensor,
          state: torch.Tensor | None = None):
    """Causal temporal conv of width W as shifted adds in x's dtype, in the
    reference's order.  x: (B, S, w); ``state`` (B, W-1, w): the trailing
    inputs of the previous call (decode).  Returns (y, new state)."""
    W = conv.shape[0]
    kern = conv.to(x.dtype)
    if state is None:
        state = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    xx = torch.cat([state, x], 1)                      # (B, W-1+S, w)
    S = x.shape[1]
    y = xx[:, :S] * kern[W - 1]
    for j in range(1, W):
        y = y + xx[:, j:j + S] * kern[W - 1 - j]
    return y, xx[:, -(W - 1):]


def forward(p: Recurrent, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence block forward (prefill).  x: (B, S, d)."""
    u = L.dense(p.wx, x)
    gate = L.activate(L.dense(p.wgate, x), "gelu")
    u, _ = _conv(p.conv, u)
    u = shard(u, "batch", "seq", "rnn")
    a, b = _decay_and_input(p, u)
    if cfg.use_kernels:
        if pspec.is_dtensor(a) and a.device_mesh.size() > 1:
            raise ValueError("the kernels run on one card: a mesh runs the "
                             "plain path (use_kernels=False)")
        h = rglru_scan(a, b)
    else:
        # the scan is per (row, channel): each rank scans its shards, where
        # DTensor would run the log-depth recursion's strided slices op by
        # op
        place = pspec.even_placements(a, a.placements) \
            if pspec.is_dtensor(a) else ()
        h = pspec.local_call(lambda a, b: L.associative_scan(a, b)[1],
                             (a, b), place)
    h = shard(h.to(x.dtype) * gate, "batch", "seq", "rnn")
    return L.dense(p.wo, h)


def init_state(cfg: ModelConfig, batch: int, *, device=None) -> dict:
    """``h`` (B, w) f32 and the conv's trailing inputs (B, W-1, w) in the
    activation dtype (the reference makes them bf16 and carries them in
    the activation dtype after one step: zeros either way)."""
    w = cfg.rnn_width
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, w),
                                dtype=cfg.activation_dtype, device=device)}


def decode_step(p: Recurrent, cfg: ModelConfig, x: torch.Tensor,
                state: dict) -> tuple[torch.Tensor, dict]:
    """One-token update, x: (B, 1, d); ``state`` is updated in place."""
    u = L.dense(p.wx, x)
    gate = L.activate(L.dense(p.wgate, x), "gelu")
    u, conv = _conv(p.conv, u, state["conv"].to(u.dtype))
    a, b = _decay_and_input(p, u)
    h = state["h"].mul_(a[:, 0]).add_(b[:, 0])         # (B, w) f32
    state["conv"].copy_(conv)
    return L.dense(p.wo, h.to(x.dtype)[:, None, :] * gate), state
