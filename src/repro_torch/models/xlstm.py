"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (scalar memory).

Port of ``repro.models.xlstm``.  mLSTM, a linear matrix-memory recurrence
per head:

    C_t = f_t C_{t-1} + i_t v_t k_t^T        (dh x dh state)
    n_t = f_t n_{t-1} + i_t k_t
    h_t = (q_t C_t) / max(|q_t . n_t|, 1)

with ``f_t = sigmoid(f~_t)``, ``i_t = sigmoid(i~_t)``.  The full sequence
runs the chunkwise-parallel form: K7 (``kernels.mlstm_chunk.ops``) when
``cfg.use_kernels``, else the same chunkwise recurrence in plain PyTorch
(``chunked_mlstm_ref``, a loop over chunks as the reference's XLA path
scans them).  Decode is the sequential update, written into (C, n) in
place; :func:`mlstm_sequential` is the step-by-step oracle.

sLSTM, scalar memory with exponential gating and a normalizer: its gates
read h_{t-1}, so the sequence is a Python loop over time (the reference's
``lax.scan``), after one f32 input projection for the whole sequence.

Under a mesh the blocks carry the reference's tags: the mLSTM's head
features ``dh`` carry the tensor-parallel axis (``mlstm_dh``) on the
value side, q and k stay whole over it; the sLSTM's four gate inputs are
split and each taken on ``rnn``.  Both recurrences run on each rank's
shards (``pspec.local_call``): the mLSTM's chunkwise recurrence splits
exactly over the value dim (the state C is (key dh, value dh/ranks) on a
rank, the normalizer reads only q and k), and the sLSTM's cell is
elementwise over its channels, so a rank runs the loop over its own;
DTensor would dispatch every step's ops one by one.  The reference's tags
inside its chunk scan (v, C, h and the initial C, all on ``mlstm_dh``) and
on the cell's c and h (``rnn``) are these regions' placements.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.mlstm_chunk import ops as ML
from repro_torch.models import layers as L
from repro_torch.models import pspec
from repro_torch.models.config import ModelConfig
from repro_torch.models.pspec import shard
from repro_torch.models.recurrent import _conv


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

class MLSTM(nn.Module):
    """``up``, ``up_gate``, per-head ``wq``/``wk``/``wv`` (H, dh, dh), the
    scalar gates ``wif`` (d, 2H), ``ln_heads`` and ``down`` kept as
    (H, dh, d)."""

    serving_cast = ("wq", "wk", "wv")

    def __init__(self, cfg: ModelConfig, gen=None, *, device=None):
        super().__init__()
        init = dict(dtype=getattr(torch, cfg.param_dtype), device=device)
        d, H = cfg.d_model, cfg.n_heads
        d_in = int(d * cfg.mlstm_proj_factor)
        dh = d_in // H
        lim = 1.0 / math.sqrt(dh)
        self.up = L.Dense(L.dense_init(gen, d, d_in, **init))
        self.up_gate = L.Dense(L.dense_init(gen, d, d_in, **init))
        self.wq, self.wk, self.wv = (
            _param(torch.randn((H, dh, dh), generator=gen, **init) * lim)
            for _ in range(3))
        self.wif = L.Dense(L.dense_init(gen, d, 2 * H, **init))
        self.ln_heads = L.Norm(dh, "rmsnorm", device=device)
        self.down = L.Dense(L.dense_init(gen, d_in, d, **init).reshape(H, dh, d))


def _mlstm_qkvif(p: MLSTM, cfg: ModelConfig, x: torch.Tensor):
    """Per-head q, k, v (B, S, H, dh) in x's dtype, f32 log gates li, lf
    (B, S, H) and silu of the gate projection (B, S, d_in)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    u = L.dense(p.up, x)
    gate = F.silu(L.dense(p.up_gate, x))
    dh = u.shape[-1] // H
    uh = u.reshape(B, S, H, dh)
    uh = shard(uh, "batch", "seq", None, "mlstm_dh")
    q = torch.einsum("bshd,hde->bshe", uh, p.wq.to(x.dtype))
    k = torch.einsum("bshd,hde->bshe", uh, p.wk.to(x.dtype)) / math.sqrt(dh)
    v = torch.einsum("bshd,hde->bshe", uh, p.wv.to(x.dtype))
    q = shard(q, "batch", "seq", None, None)        # whole dh
    k = shard(k, "batch", "seq", None, None)
    v = shard(v, "batch", "seq", None, "mlstm_dh")  # split value dim
    gates = L.dense(p.wif, x).float()                  # (B, S, 2H)
    if pspec.is_dtensor(gates):
        # DTensor has no rule for logsigmoid's backward: each rank takes
        # its rows of the gates, whole over the 2H gate columns
        from torch.distributed.tensor import Replicate, Shard
        gates = pspec.settled(gates)
        place = tuple(pl if pl == Shard(0) else Replicate() for pl in
                      pspec.even_placements(gates, gates.placements))
        return (q, k, v, *pspec.local_call(
            lambda g: (F.logsigmoid(g[..., :H]), F.logsigmoid(g[..., H:])),
            (gates,), place, n_out=2), gate)
    li = F.logsigmoid(gates[..., :H])                  # log i_t (<= 0)
    lf = F.logsigmoid(gates[..., H:])                  # log f_t (<= 0)
    return q, k, v, li, lf, gate


def _mlstm_out(p: MLSTM, x: torch.Tensor, h: torch.Tensor,
               gate: torch.Tensor) -> torch.Tensor:
    """Head norm, the gate and the down projection: h (B, S, H, dh)."""
    B, S, H, dh = h.shape
    h = L.apply_norm(p.ln_heads, h, "rmsnorm").to(x.dtype)
    h = h * gate.reshape(B, S, H, dh)
    h = shard(h, "batch", "seq", None, "mlstm_dh")
    return torch.einsum("bshd,hde->bse", h, p.down.w.to(x.dtype))


def mlstm_forward(p: MLSTM, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Chunkwise-parallel full-sequence mLSTM.  x: (B, S, d).  K7 takes
    (B, H, S, dh) views of the projections; the chunk is the reference's
    (``ops.chunk_size``)."""
    q, k, v, li, lf, gate = _mlstm_qkvif(p, cfg, x)
    if cfg.use_kernels:
        if pspec.is_dtensor(q) and q.device_mesh.size() > 1:
            raise ValueError("the kernels run on one card: a mesh runs the "
                             "plain path (use_kernels=False)")
        h = ML.chunked_mlstm(q, k, v, li, lf, chunk=cfg.chunk_size)
    else:
        def chunks(q, k, v, li, lf):
            return ML.chunked_mlstm_ref(q, k, v, li, lf, chunk=cfg.chunk_size)
        h = pspec.local_call(chunks, (q, k, v, li, lf),
                             *_mlstm_placements(v))
    return _mlstm_out(p, x, h, gate)


def _mlstm_placements(v) -> tuple:
    """(per-argument placements of q, k, v, li, lf; h's) for the chunk
    recurrence's local region: every input keeps v's batch split, v and
    h also its value-dim split; () without a mesh."""
    if not pspec.is_dtensor(v):
        return ((),)
    from torch.distributed.tensor import Replicate, Shard
    pv = pspec.even_placements(v, v.placements)
    pv = tuple(p if isinstance(p, Shard) and p.dim in (0, 3) else Replicate()
               for p in pv)
    whole = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                  for p in pv)
    return [whole, whole, pv, whole, whole], pv


def mlstm_init_state(cfg: ModelConfig, batch: int, *, device=None) -> dict:
    d_in = int(cfg.d_model * cfg.mlstm_proj_factor)
    H = cfg.n_heads
    dh = d_in // H
    return {"C": torch.zeros((batch, H, dh, dh), dtype=torch.float32,
                             device=device),
            "n": torch.zeros((batch, H, dh), dtype=torch.float32, device=device)}


def _mlstm_read(C, n, qf):
    """h = (q C) / max(|q . n|, 1) per head, f32.  qf (B, H, dh)."""
    num = torch.einsum("bhd,bhde->bhe", qf, C)
    den = torch.clamp(torch.einsum("bhd,bhd->bh", qf, n).abs(), min=1.0)
    return num / den[..., None]


def mlstm_decode_step(p: MLSTM, cfg: ModelConfig, x: torch.Tensor,
                      state: dict) -> tuple[torch.Tensor, dict]:
    """One-token mLSTM update, x: (B, 1, d); C and n are updated in place."""
    q, k, v, li, lf, gate = _mlstm_qkvif(p, cfg, x)
    i = torch.exp(li[:, 0])                            # (B, H)
    f = torch.exp(lf[:, 0])
    kf, vf, qf = k[:, 0].float(), v[:, 0].float(), q[:, 0].float()
    # C f + (i k) v^T: two passes over C where the reference's i (k v^T)
    # makes four; the products round alike to within one ulp
    C = state["C"].mul_(f[..., None, None]).addcmul_(
        (i[..., None] * kf)[..., :, None], vf[..., None, :])
    n = state["n"].mul_(f[..., None]).add_(i[..., None] * kf)
    h = _mlstm_read(C, n, qf)
    return _mlstm_out(p, x, h[:, None], gate), state


def mlstm_sequential(p: MLSTM, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Step-by-step oracle for the chunked form (tests)."""
    B = x.shape[0]
    st = mlstm_init_state(cfg, B, device=x.device)
    C, n = st["C"], st["n"]
    q, k, v, li, lf, gate = _mlstm_qkvif(p, cfg, x)
    hs = []
    for t in range(x.shape[1]):
        i, f = torch.exp(li[:, t]), torch.exp(lf[:, t])
        kf = k[:, t].float()
        C = C * f[..., None, None] + i[..., None, None] * torch.einsum(
            "bhd,bhe->bhde", kf, v[:, t].float())
        n = n * f[..., None] + i[..., None] * kf
        hs.append(_mlstm_read(C, n, q[:, t].float()))
    return _mlstm_out(p, x, torch.stack(hs, 1), gate)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

class _F32Weight(nn.Module):
    """``w``, a weight the reference multiplies in f32 whatever the
    activation dtype; ``convert.to_serving`` leaves it f32."""

    def __init__(self, w: torch.Tensor):
        super().__init__()
        self.w = _param(w)


class SLSTM(nn.Module):
    """``w`` (d, 4d: the i, f, z, o projections), the diagonal recurrent
    ``r`` (4, d, zero), ``conv`` (W, d) and ``b`` (4d), all used in f32
    but the conv."""

    serving_cast = ("conv",)

    def __init__(self, cfg: ModelConfig, gen=None, *, device=None):
        super().__init__()
        init = dict(dtype=getattr(torch, cfg.param_dtype), device=device)
        d, W = cfg.d_model, cfg.conv_width
        self.w = _F32Weight(L.dense_init(gen, d, 4 * d, **init))
        self.r = _param(torch.zeros((4, d), **init))
        self.conv = _param(torch.randn((W, d), generator=gen, **init)
                           / math.sqrt(W))
        self.b = _param(torch.zeros((4 * d,), **init))


def slstm_init_state(cfg: ModelConfig, batch: int, *, device=None) -> dict:
    """c, n, h zeros and the stabilizer m = -10, (B, d) f32; the conv's
    trailing inputs in the activation dtype."""
    d = cfg.d_model

    def z():
        return torch.zeros((batch, d), dtype=torch.float32, device=device)
    return {"c": z(), "n": z(), "h": z(), "m": z() - 10.0,
            "conv": torch.zeros((batch, cfg.conv_width - 1, d),
                                dtype=cfg.activation_dtype, device=device)}


def _input_gates(p: SLSTM, u: torch.Tensor) -> torch.Tensor:
    """The input projection x W + b in f32, hoisted out of the recurrence
    (it does not read h): (..., 4d) -> (..., 4, d)."""
    g = u.float() @ p.w.w.float() + p.b.float()
    return g.unflatten(-1, (4, -1))


def _slstm_cell(r: torch.Tensor, gates: torch.Tensor, state: tuple):
    """One sLSTM step.  ``r`` (4, d) f32; ``gates`` (B, 4, d): the input
    projection of this step; ``state`` (c, n, h, m).  Returns the new
    state."""
    c, n, h, m = state
    gi, gf, gz, go = torch.addcmul(gates, r, h[:, None, :]).unbind(1)
    gfm = gf + m
    m_new = torch.maximum(gfm, gi)                     # exponential-gating stabilizer
    i = torch.exp(gi - m_new)
    f = torch.exp(gfm - m_new)
    c = torch.addcmul(f * c, i, torch.tanh(gz))
    n = torch.addcmul(i, f, n)
    h = torch.sigmoid(go) * c / torch.clamp(n, min=1e-6)
    return c, n, h, m_new


def _slstm_loop(r: torch.Tensor, gates: torch.Tensor, state: tuple
                ) -> torch.Tensor:
    """The cell over the sequence: ``gates`` (S, B, 4, w) time-major, ``r``
    (4, w) f32, ``state`` (c, n, h, m) -> the hidden states (B, S, w) f32."""
    hs = []     # each step's h, stacked once (autograd records no out= write)
    for t in range(gates.shape[0]):
        state = _slstm_cell(r, gates[t], state)
        hs.append(state[2])
    return torch.stack(hs, 1)


def _slstm_scan(gates: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """:func:`_slstm_loop` from the zero state (m = -10) on gates (B, S, 4,
    w) of any width w: one rank's channels under a mesh."""
    B, _, _, w = gates.shape

    def z():
        return torch.zeros((B, w), dtype=torch.float32, device=gates.device)
    return _slstm_loop(r.float(), gates.transpose(0, 1),
                       (z(), z(), z(), z() - 10.0))


def slstm_forward(p: SLSTM, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Sequential full-sequence sLSTM.  x: (B, S, d)."""
    B, _, d = x.shape
    u, _ = _conv(p.conv, x)
    if not pspec.is_dtensor(u):
        gates = _input_gates(p, u).transpose(0, 1)     # (S, B, 4, d)
        st = slstm_init_state(cfg, B, device=x.device)
        state = (st["c"], st["n"], st["h"], st["m"])
        return _slstm_loop(p.r.float(), gates, state).to(x.dtype)
    # the four gate inputs split and each taken on "rnn" (a slice of the
    # rnn-split (B, S, 4d) projection inside the loop would gather every
    # step), then the loop on each rank's channels
    from torch.distributed.tensor import Replicate, Shard
    g = u.float() @ p.w.w.float() + p.b.float()
    gates = torch.stack([shard(g[..., j * d:(j + 1) * d], "batch", "seq",
                               "rnn") for j in range(4)], 2)
    pg = tuple(pl if isinstance(pl, Shard) and pl.dim in (0, 3)
               else Replicate()
               for pl in pspec.even_placements(gates, gates.placements))
    pr = tuple(Shard(1) if pl == Shard(3) else Replicate() for pl in pg)
    ph = tuple(Shard(2) if pl == Shard(3) else pl for pl in pg)
    h = pspec.local_call(_slstm_scan, (gates, p.r), [pg, pr], ph)
    return h.to(x.dtype)


def slstm_decode_step(p: SLSTM, cfg: ModelConfig, x: torch.Tensor,
                      state: dict) -> tuple[torch.Tensor, dict]:
    """One-token update, x: (B, 1, d); ``state`` is updated in place."""
    u, conv = _conv(p.conv, x, state["conv"].to(x.dtype))
    names = ("c", "n", "h", "m")
    new = _slstm_cell(p.r.float(), _input_gates(p, u[:, 0]),
                      tuple(state[k] for k in names))
    for k, t in zip(names, new):
        state[k].copy_(t)
    state["conv"].copy_(conv)
    return state["h"].to(x.dtype)[:, None, :], state
