"""Plain float32 PyTorch reference of the ``deepseek_v3`` family.

Written from the published architecture (DeepSeek-V3's
``modeling_deepseek.py``: RMSNorm; latent attention with low-rank q and
kv paths, q and k heads of 128 + 64 and v heads of 128, the 64 rotated
columns de-interleaved and rotated by rotate-half at YaRN's frequencies,
the softmax scale ``mscale² / sqrt(192)``; the leading dense layers'
SwiGLU MLP; the ``noaux_tc`` gate, routed SwiGLU experts and the shared
expert) and from what the configuration file states besides: the expert
share (the gate over every expert, only the held experts' terms added,
the shared expert added whole) and the capacity rule (groups, capacity,
priority; dropped pairs add nothing), as ``reference/qwen.py`` states it
for the ``qwen`` family.  It imports nothing of the program, and reads
only the benchmark's own tensors (``weights.py``), each cast to f32 when
its layer runs, so it holds one layer's f32 weights at a time; attention
takes ``QUERY_BLOCK`` query rows at a time.

Every product runs in f32 with TF32 off (``exact_matmuls``).  With
``fp8=True`` the inputs of every product the configuration states in bf16
(the projections, experts, shared expert, dense MLP, head, Q K^T and
P V) are rounded to float8 e4m3 with one scale a tensor: the control.
The gate and the norms stay f32, as the configuration states them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.qwen import Reference as _Qwen

#: Query rows an attention block takes at a time.
QUERY_BLOCK = 256
#: The least gap between biased gate scores (sigmoid + correction bias)
#: that decides a choice, below which two routers that compute the scores
#: in f32 from one input may choose either way (:meth:`Reference.routed`):
#: 100 times f32 rounding over the gate's 7,168 products and more.
TIE = 1e-4


def yarn_inv_freq(g) -> torch.Tensor:
    """The rotated columns' frequencies (f64, one a pair): the unscaled
    ``base^(-2i/dim)`` where the ramp between the correction dimensions of
    ``beta_fast`` and ``beta_slow`` rotations over the trained context is
    0, ``/ factor`` where it is 1, blended between."""
    dim, base = g.qk_rope_dim, g.rope_theta
    extra = base ** (-torch.arange(0, dim, 2, dtype=torch.float64) / dim)

    def corr(rotations):
        return (dim * math.log(g.rope_original_max / (rotations * 2 * math.pi))
                / (2 * math.log(base)))
    lo = max(math.floor(corr(g.rope_beta_fast)), 0)
    hi = min(math.ceil(corr(g.rope_beta_slow)), dim - 1)
    ramp = ((torch.arange(dim // 2, dtype=torch.float64) - lo)
            / max(hi - lo, 1e-3)).clamp(0, 1)
    return extra / g.rope_factor * ramp + extra * (1 - ramp)


def mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


class Reference(_Qwen):
    """The model of ``g`` on ``weights`` (the benchmark's leaves by name):
    the ``qwen`` reference's products, norms, embedding, head, MoE
    experts and capacity bookkeeping, with DeepSeek-V3's attention, gate
    and layers."""

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x (T, H, 64) at positions ``pos`` (T,): de-interleaved, then
        rotate-half at YaRN's frequencies (angles in f64), the tables
        scaled by ``mscale(factor, mscale) / mscale(factor,
        mscale_all_dim)``."""
        g = self.g
        x = torch.cat([x[..., 0::2], x[..., 1::2]], -1)
        half = x.shape[-1] // 2
        ang = pos.to(torch.float64)[:, None] \
            * yarn_inv_freq(g).to(x.device)[None, :]
        m = mscale(g.rope_factor, g.rope_mscale) \
            / mscale(g.rope_factor, g.rope_mscale_all_dim)
        cos = (torch.cos(ang) * m).float()[:, None, :]
        sin = (torch.sin(ang) * m).float()[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def attend(self, q, k, v, q_pos, k_pos, layer: int) -> torch.Tensor:
        """Causal attention of q, k (T, H, 192) and v (T, H, 128), sorted
        by position, at the YaRN softmax scale."""
        g = self.g
        scale = g.qk_head_dim ** -0.5
        if g.rope_mscale_all_dim:
            scale *= mscale(g.rope_factor, g.rope_mscale_all_dim) ** 2
        k, v = self._q(k), self._q(v)
        out = q.new_empty(q.shape[0], g.n_heads, g.v_head_dim)
        for r0 in range(0, q.shape[0], QUERY_BLOCK):
            qp = q_pos[r0:r0 + QUERY_BLOCK]
            n = qp.shape[0]
            lim = int(torch.searchsorted(k_pos, qp.max(), right=True))
            s = torch.einsum("qhd,khd->hqk", self._q(q[r0:r0 + n] * scale),
                             k[:lim])
            s = s.masked_fill(~self.live(layer, qp, k_pos[:lim]),
                              float("-inf"))
            p = self._q(torch.softmax(s, dim=-1))
            out[r0:r0 + n] = torch.einsum("hqk,khd->qhd", p, v[:lim])
        return out

    def route(self, h: torch.Tensor, pre: str, seq: int):
        """The ``noaux_tc`` gate over every expert, then the capacity
        rule, on the tokens ``h`` (T, d) of a call in batch-major order:
        (weights, experts, kept) of each token's top-k choices, (T, k)
        each, best biased score first."""
        w, e = noaux_tc(h @ self._f(pre + "mlp.gate.weight"),
                        self._f(pre + "mlp.gate.e_score_correction_bias"),
                        self.g)
        return w, e, self.kept(e, seq)

    def kept(self, e: torch.Tensor, seq: int) -> torch.Tensor:
        """Which of the choices ``e`` (T, k) of a call's tokens in rows of
        ``seq`` the capacity rule keeps: in each group, its pairs in
        priority order (every first choice, then every second, ...), a
        pair kept where fewer than C earlier pairs chose its expert."""
        g = self.g
        T = e.shape[0]
        sg, cap = g.groups(T, seq)
        order = e.reshape(T // sg, sg, g.top_k).transpose(1, 2) \
            .reshape(T // sg, -1)
        onehot = F.one_hot(order, g.router_outputs).to(torch.int32)
        place = (onehot.cumsum(1) * onehot).sum(-1) - 1
        place = place.reshape(T // sg, g.top_k, sg).transpose(1, 2) \
            .reshape(T, g.top_k)
        return place < cap

    def routed(self, i: int, h: torch.Tensor, experts: torch.Tensor):
        """MoE layer ``i``'s routed part on one capacity group's inputs ``h``
        (T, d), given the choices ``experts`` (T, k) of another router
        (the program's, best first): (what the held experts add there
        (T, d), taking those choices with this reference's weights for
        them and the capacity rule; this reference's own choices (T, k);
        where its choice rests on a near tie (T,): the 4th and 5th group
        scores, or the k-th and (k+1)-th expert scores left in the chosen
        groups, within ``TIE``)."""
        g = self.g
        pre = f"layers.{i}."
        T, E = h.shape[0], g.router_outputs
        logits = h @ self._f(pre + "mlp.gate.weight")
        bias = self._f(pre + "mlp.gate.e_score_correction_bias")
        _, own = noaux_tc(logits, bias, g)
        scores = logits.sigmoid()
        choice = scores + bias
        group = choice.view(T, g.n_group, -1).topk(2, -1)[0].sum(-1)
        ranked = group.sort(-1, descending=True)[0]
        kept_groups = group >= ranked[:, g.topk_group - 1:g.topk_group]
        left = choice.masked_fill(
            ~kept_groups.repeat_interleave(E // g.n_group, -1),
            float("-inf")).scatter(1, own, float("-inf"))
        near = ((ranked[:, g.topk_group - 1] - ranked[:, g.topk_group] < TIE)
                | (choice.gather(1, own).amin(-1) - left.amax(-1) < TIE))
        w = scores.gather(1, experts)
        if g.norm_topk_prob:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        w = w * g.routed_scaling_factor
        kept = self.kept(experts, T)
        return self.held_part(h, pre, w, experts, kept), own, near

    def moe(self, h: torch.Tensor, pre: str, seq: int):
        """The held experts' part of the layer: (output (T, d), kept pairs
        held here)."""
        w, e, kept = self.route(h, pre, seq)
        lo, hi = self.g.held
        return (self.held_part(h, pre, w, e, kept),
                int(((e >= lo) & (e < hi) & kept).sum()))

    def held_part(self, h: torch.Tensor, pre: str, w: torch.Tensor,
                  e: torch.Tensor, kept: torch.Tensor) -> torch.Tensor:
        """What the held experts add to the tokens ``h`` (T, d) for the
        choices ``e`` with weights ``w`` that ``kept`` keeps, (T, k) each:
        one expert's weights in f32 at a time."""
        out = torch.zeros_like(h)
        for j, x in enumerate(range(*self.g.held)):
            tok, slot = torch.nonzero((e == x) & kept, as_tuple=True)
            if tok.numel() == 0:
                continue
            hx = h[tok]
            gate, up, down = (self.w[pre + f"mlp.experts.{n}"][j].float()
                              for n in ("gate_proj", "up_proj", "down_proj"))
            y = self.mm(F.silu(self.mm(hx, gate)) * self.mm(hx, up), down)
            out.index_add_(0, tok, y * w[tok, slot][:, None])
        return out

    def ffn(self, h: torch.Tensor, pre: str) -> torch.Tensor:
        """A SwiGLU of ``pre + gate_proj``, ``up_proj``, ``down_proj``."""
        gate = self.mm(h, self._f(pre + "gate_proj"))
        up = self.mm(h, self._f(pre + "up_proj"))
        return self.mm(F.silu(gate) * up, self._f(pre + "down_proj"))

    def layer(self, i: int, x: torch.Tensor, pos: torch.Tensor,
              prefix=None):
        """Layer ``i`` over x (R, T, d) at positions ``pos`` (T), each row
        attending its own keys.  Returns (x, None, kept pairs)."""
        if prefix is not None:
            raise NotImplementedError("the reference has no cache")
        g = self.g
        pre = f"layers.{i}."
        at = pre + "self_attn."
        R, T, d = x.shape
        H, nope = g.n_heads, g.qk_nope_dim
        h = self.norm(x, self._f(pre + "input_layernorm")).reshape(R * T, d)
        q = self.mm(self.norm(self.mm(h, self._f(at + "q_a_proj.w")),
                              self._f(at + "q_a_layernorm")),
                    self._f(at + "q_b_proj.w")).reshape(R, T, H, -1)
        kv = self.mm(h, self._f(at + "kv_a_proj_with_mqa.w"))
        latent, k_pe = kv[:, :g.kv_lora_rank], kv[:, g.kv_lora_rank:]
        kvb = self.mm(self.norm(latent, self._f(at + "kv_a_layernorm")),
                      self._f(at + "kv_b_proj.w")).reshape(R, T, H, -1)
        k_pe = k_pe.reshape(R, T, 1, g.qk_rope_dim)
        att = x.new_empty(R, T, H, g.v_head_dim)
        for r in range(R):
            qr = torch.cat([q[r, :, :, :nope], self.rope(q[r, :, :, nope:],
                                                        pos)], -1)
            kr = torch.cat([kvb[r, :, :, :nope],
                            self.rope(k_pe[r], pos).expand(T, H, -1)], -1)
            att[r] = self.attend(qr, kr, kvb[r, :, :, nope:], pos, pos, i)
        x = x + self.mm(att.reshape(R * T, H * g.v_head_dim),
                        self._f(at + "o_proj.w")).reshape(R, T, d)
        h = self.norm(x, self._f(pre + "post_attention_layernorm")) \
            .reshape(R * T, d)
        kept = 0
        if i < g.n_dense_layers:
            m = self.ffn(h, pre + "mlp.")
        else:
            m, kept = self.moe(h, pre, T)
            m = m + self.ffn(h, pre + "mlp.shared_experts.")
        return x + m.reshape(R, T, d), None, kept

    def decode_chunk(self, tokens, start, prefix_of):
        raise NotImplementedError("no decode cell runs this family yet: its "
                                  "reference decodes nothing")


def noaux_tc(logits: torch.Tensor, bias: torch.Tensor, g):
    """DeepSeek-V3's gate (``MoEGate``, ``topk_method`` ``noaux_tc``) on
    the router's f32 logits (T, E): (weights, experts) of each token's
    ``top_k`` choices, best biased score first.  As published: sigmoid
    scores; the bias added for the choice only; each group scored by the
    sum of its two best biased scores; the ``topk_group`` best groups
    kept, the other groups' scores 0; the ``top_k`` best of what is left;
    the unbiased scores of the choice, over their sum + 1e-20
    (``norm_topk_prob``), times ``routed_scaling_factor``."""
    T, E = logits.shape
    scores = logits.sigmoid()
    for_choice = scores + bias[None, :]
    group_scores = for_choice.view(T, g.n_group, -1).topk(2, dim=-1)[0] \
        .sum(dim=-1)
    group_idx = torch.topk(group_scores, k=g.topk_group, dim=-1)[1]
    group_mask = torch.zeros_like(group_scores)
    group_mask.scatter_(1, group_idx, 1)
    score_mask = group_mask.unsqueeze(-1).expand(
        T, g.n_group, E // g.n_group).reshape(T, -1)
    tmp = for_choice.masked_fill(~score_mask.bool(), 0.0)
    _, topk_idx = torch.topk(tmp, k=g.top_k, dim=-1)
    weight = scores.gather(1, topk_idx)
    if g.norm_topk_prob:
        weight = weight / (weight.sum(dim=-1, keepdim=True) + 1e-20)
    return weight * g.routed_scaling_factor, topk_idx
