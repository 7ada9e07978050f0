"""Plain float32 PyTorch reference of the ``qwen`` family.

Written from the published architecture (Qwen2 and Qwen3-MoE: RMSNorm,
rotate-half RoPE, causal GQA, q/k/v biases or per-head q/k RMSNorm, SwiGLU
MLP or routed SwiGLU experts) and from what the configuration file states
besides: an MoE model's expert share (the router over every expert, only
the held experts' terms added) and the capacity rule (groups, capacity,
priority; dropped pairs add nothing).  It imports nothing of the program
and reads only the benchmark's own tensors (``weights.py``), each cast to
f32 when its layer runs, so it holds one layer's f32 weights at a time.

Every product runs in f32 with TF32 off (``exact_matmuls``).  With
``fp8=True`` the inputs of every product the configuration states in bf16
(projections, experts, head, Q K^T, P V) are rounded to float8 e4m3 with
one scale a tensor, as an fp8 kernel would take them: the precision below
the configuration's, which the comparison must tell apart (the control).
The router and the norms stay f32, as the configuration states them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import to_fp8

#: Query rows an attention block takes at a time.
QUERY_BLOCK = 256


class Reference:
    """The model of ``g`` on ``weights`` (the benchmark's leaves by name)."""

    def __init__(self, g, weights: dict, *, fp8: bool = False):
        self.g, self.w, self.fp8 = g, weights, fp8
        #: per MoE layer, each row's last-token router margin
        #: (``_near_tie``), where a caller sets it to a list
        self.margins = None

    # -- pieces ---------------------------------------------------------
    def _f(self, name: str) -> torch.Tensor:
        return self.w[name].float()

    def _q(self, t: torch.Tensor) -> torch.Tensor:
        return to_fp8(t) if self.fp8 else t

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self._q(x) @ self._q(w)

    def norm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        var = x.pow(2).mean(-1, keepdim=True)
        return x * torch.rsqrt(var + self.g.eps) * w

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x (T, H, D) at positions ``pos`` (T,), rotate-half; the angles
        in f64."""
        half = x.shape[-1] // 2
        inv = self.g.rope_theta ** (-torch.arange(
            half, dtype=torch.float64, device=x.device) / half)
        ang = pos.to(torch.float64)[:, None] * inv[None, :]
        cos = torch.cos(ang).float()[:, None, :]
        sin = torch.sin(ang).float()[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def live(self, layer: int, q_pos: torch.Tensor,
             k_pos: torch.Tensor) -> torch.Tensor:
        """(Tq, Tk): where a key attends a query in layer ``layer``: where
        its position is at most the query's."""
        return k_pos[None, :] <= q_pos[:, None]

    def attend(self, q, k, v, q_pos, k_pos, layer: int) -> torch.Tensor:
        """Causal GQA in layer ``layer``: q (Tq, Hq, D) over k, v (Tk, Hkv,
        D), sorted by position; a key attends where :meth:`live` says."""
        g = self.g
        grp = g.n_heads // g.n_kv_heads
        k, v = self._q(k), self._q(v)
        out = torch.empty_like(q)
        scale = 1.0 / math.sqrt(g.head_dim)
        for r0 in range(0, q.shape[0], QUERY_BLOCK):
            qp = q_pos[r0:r0 + QUERY_BLOCK]
            n = qp.shape[0]
            # keys past the block's last query are masked for every row
            lim = int(torch.searchsorted(k_pos, qp.max(), right=True))
            qq = self._q(q[r0:r0 + n] * scale).reshape(n, g.n_kv_heads, grp,
                                                       g.head_dim)
            s = torch.einsum("qhgd,khd->hgqk", qq, k[:lim])
            live = self.live(layer, qp, k_pos[:lim])
            s = s.masked_fill(~live, float("-inf"))
            p = self._q(torch.softmax(s, dim=-1))
            o = torch.einsum("hgqk,khd->qhgd", p, v[:lim])
            out[r0:r0 + n] = o.reshape(n, g.n_heads, g.head_dim)
        return out

    def mlp(self, h: torch.Tensor, pre: str) -> torch.Tensor:
        gate = self.mm(h, self._f(pre + "mlp.gate_proj"))
        up = self.mm(h, self._f(pre + "mlp.up_proj"))
        return self.mm(F.silu(gate) * up, self._f(pre + "mlp.down_proj"))

    def route(self, h: torch.Tensor, pre: str, seq: int):
        """The router over every expert and the capacity rule, on the
        tokens ``h`` (T, d) of a call in batch-major order: (weights,
        experts, kept) of each token's top-k choices, (T, k) each."""
        g = self.g
        probs = torch.softmax(h @ self._f(pre + "mlp.router"), dim=-1)
        w, e = probs.sort(dim=-1, descending=True, stable=True)
        self._near_tie(w, e, seq)
        w, e = w[:, :g.top_k], e[:, :g.top_k]
        w = w / w.sum(-1, keepdim=True)
        T = h.shape[0]
        sg, cap = g.groups(T, seq)
        # a group's pairs in priority order: every first choice, then
        # every second choice, ...; a pair's place is the count of earlier
        # pairs to its expert
        order = e.reshape(T // sg, sg, g.top_k).transpose(1, 2) \
            .reshape(T // sg, -1)
        onehot = F.one_hot(order, g.router_outputs).to(torch.int32)
        place = (onehot.cumsum(1) * onehot).sum(-1) - 1
        place = place.reshape(T // sg, g.top_k, sg).transpose(1, 2) \
            .reshape(T, g.top_k)
        return w, e, place < cap

    def _near_tie(self, w, e, seq: int) -> None:
        """Record, at each row's last token, the margin between its k-th
        and (k+1)-th router probability where either expert is held here
        (a tie there is where rounding moves a held expert's term)."""
        if self.margins is None:
            return
        k, (lo, hi) = self.g.top_k, self.g.held
        last = w[seq - 1::seq]
        pair = e[seq - 1::seq, k - 1:k + 1]
        held = ((pair >= lo) & (pair < hi)).any(-1)
        margin = last[:, k - 1] - last[:, k]
        self.margins.append(torch.where(held, margin,
                                        torch.full_like(margin, 1.0)))

    def moe(self, h: torch.Tensor, pre: str, seq: int):
        """The held experts' part of the layer: (output (T, d), kept pairs
        held here)."""
        g = self.g
        w, e, kept = self.route(h, pre, seq)
        out = torch.zeros_like(h)
        n_kept = 0
        for j, x in enumerate(range(*g.held)):
            tok, slot = torch.nonzero((e == x) & kept, as_tuple=True)
            n_kept += tok.numel()
            if tok.numel() == 0:
                continue
            hx = h[tok]
            # one expert's weights in f32 at a time
            gate, up, down = (self.w[pre + f"mlp.experts.{n}"][j].float()
                              for n in ("gate_proj", "up_proj", "down_proj"))
            y = self.mm(F.silu(self.mm(hx, gate)) * self.mm(hx, up), down)
            out.index_add_(0, tok, y * w[tok, slot][:, None])
        return out, n_kept

    # -- a layer, the model ---------------------------------------------
    def layer(self, i: int, x: torch.Tensor, pos: torch.Tensor,
              prefix=None):
        """Layer ``i`` over x (R, T, d) at positions ``pos`` (T,), each row
        attending its own keys and, with ``prefix`` = (first, (k, v)), k
        and v (R, P, Hkv, D) at positions first..first+P-1, those first.
        Returns (x, (k, v) of the T new positions after RoPE, kept
        pairs)."""
        g = self.g
        pre = f"layers.{i}."
        R, T, d = x.shape
        h = self.norm(x, self._f(pre + "input_layernorm")).reshape(R * T, d)
        proj = {}
        for name, heads in (("q_proj", g.n_heads), ("k_proj", g.n_kv_heads),
                            ("v_proj", g.n_kv_heads)):
            y = self.mm(h, self._f(pre + name + ".w"))
            if g.qkv_bias:
                y = y + self._f(pre + name + ".b")
            proj[name] = y.reshape(R, T, heads, g.head_dim)
        q, k, v = proj["q_proj"], proj["k_proj"], proj["v_proj"]
        if g.qk_norm:
            q = self.norm(q, self._f(pre + "q_norm"))
            k = self.norm(k, self._f(pre + "k_norm"))
        q = torch.stack([self.rope(q[r], pos) for r in range(R)])
        k = torch.stack([self.rope(k[r], pos) for r in range(R)])
        att = torch.empty_like(q)
        for r in range(R):
            kr, vr, kp = k[r], v[r], pos
            if prefix is not None:
                first, (pk, pv) = prefix
                P = pk.shape[1]
                kr = torch.cat([pk[r].float(), kr])
                vr = torch.cat([pv[r].float(), vr])
                kp = torch.cat([torch.arange(first, first + P,
                                             device=x.device), pos])
            att[r] = self.attend(q[r], kr, vr, pos, kp, i)
        x = x + self.mm(att.reshape(R * T, g.q_dim),
                        self._f(pre + "o_proj.w")).reshape(R, T, d)
        h = self.norm(x, self._f(pre + "post_attention_layernorm")) \
            .reshape(R * T, d)
        kept = 0
        if g.is_moe:
            m, kept = self.moe(h, pre, T)
        else:
            m = self.mlp(h, pre)
        return x + m.reshape(R, T, d), (k, v), kept

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.w["embed_tokens"][tokens.long()].float()

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """The head over the real vocabulary of x (..., d)."""
        h = self.norm(x, self._f("norm"))
        return self.mm(h, self._f("lm_head")[:, :self.g.vocab])

    def prefill_last(self, tokens: torch.Tensor):
        """A prefill call: tokens (B, S) -> (last-position logits (B, V),
        kept pairs of the held experts summed over layers)."""
        x = self.embed(tokens)
        pos = torch.arange(tokens.shape[1], device=tokens.device)
        kept = 0
        for i in range(self.g.n_layers):
            x, _, n = self.layer(i, x, pos, None)
            kept += n
        return self.logits(x[:, -1]), kept

    def decode_chunk(self, tokens: torch.Tensor, start: int, prefix_of):
        """A dense model's decode steps, teacher-forced: tokens (R, n) fed
        at positions start..start+n-1 of R sequences, each over its prompt
        ``prefix_of(layer)`` = (first, (k, v)), k and v (R, start - first,
        Hkv, D) at positions first..start-1, and its earlier steps.
        Returns (logits (R, n, V), [(k, v) (R, n, Hkv, D) a layer]): what
        each step's output and cache write must be."""
        if self.g.is_moe:
            raise NotImplementedError("the reference decodes dense models "
                                      "only (an MoE decode routes with "
                                      "the sort semantics)")
        x = self.embed(tokens)
        pos = start + torch.arange(tokens.shape[1], device=tokens.device)
        rows = []
        for i in range(self.g.n_layers):
            x, kv, _ = self.layer(i, x, pos, prefix_of(i))
            rows.append(kv)
        return self.logits(x), rows
