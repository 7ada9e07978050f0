"""A configuration file read into the sizes every other module needs.

``configs/<name>.json`` holds the published ``config.json`` keys (those of
Hugging Face's format), what the published modeling code fixes besides
(``architecture``), the keys cut for one chip (``reduced``, with the
published values under ``published``), an MoE model's expert share and
capacity rule, and what was assumed.  :func:`geometry` turns it into one
frozen record, which the weight draw, the FLOP and byte counts, the
reference and the adapter to the program all read.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Geometry:
    name: str
    d_model: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int                     # the MLP's, or one expert's
    vocab: int
    padded_vocab: int
    qkv_bias: bool
    qk_norm: bool
    eps: float
    rope_theta: float
    # MoE (router_outputs 0: dense)
    router_outputs: int = 0
    top_k: int = 0
    held: tuple[int, int] = (0, 0)
    group_tokens: int = 0
    capacity_factor: float = 0.0

    @property
    def is_moe(self) -> bool:
        return self.router_outputs > 0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def n_held(self) -> int:
        return self.held[1] - self.held[0]

    def groups(self, n_tokens: int, seq: int) -> tuple[int, int]:
        """(tokens a capacity group, capacity C) of a call of ``n_tokens``
        tokens in rows of ``seq``, by the configuration's capacity rule."""
        sg = min(self.group_tokens, seq) if seq > 1 else 1
        while n_tokens % sg:
            sg //= 2
        c = math.ceil(sg * self.top_k * self.capacity_factor
                      / self.router_outputs)
        return sg, max(8, -(-c // 8) * 8)


def geometry(c: dict) -> Geometry:
    arch = c["architecture"]
    heads = c["num_attention_heads"]
    head_dim = c.get("head_dim") or arch.get("head_dim") \
        or c["hidden_size"] // heads
    common = dict(
        name=c["name"], d_model=c["hidden_size"],
        n_layers=c["num_hidden_layers"], n_heads=heads,
        n_kv_heads=c["num_key_value_heads"], head_dim=head_dim,
        vocab=c["vocab_size"], padded_vocab=c["assumed"]["padded_vocab"],
        qkv_bias=bool(arch["qkv_bias"]), qk_norm=bool(arch["qk_norm"]),
        eps=float(c["rms_norm_eps"]), rope_theta=float(c["rope_theta"]))
    share = c.get("expert_share")
    if share is None:
        return Geometry(d_ff=c["intermediate_size"], **common)
    lo, hi = share["held"]
    if hi - lo != c["num_experts"]:
        raise ValueError(f"{c['name']}: num_experts {c['num_experts']} "
                         f"is not the {hi - lo} experts held")
    cap = c["capacity"]
    return Geometry(d_ff=c["moe_intermediate_size"],
                    router_outputs=share["router_outputs"],
                    top_k=c["num_experts_per_tok"], held=(lo, hi),
                    group_tokens=cap["group_tokens"],
                    capacity_factor=float(cap["capacity_factor"]), **common)
