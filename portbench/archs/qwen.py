"""Family ``qwen``: the Qwen2 and Qwen3-MoE decoders (the contract is in
``archs/__init__.py``).

``configs/<name>.json`` holds the published ``config.json`` keys (those of
Hugging Face's format), what the published modeling code fixes besides
(``architecture``: ``qkv_bias``, ``qk_norm``, ``head_dim``), the keys cut
for one chip (``reduced``, with the published values under
``published``), an MoE model's expert share and capacity rule, and what
was assumed.  :func:`geometry` turns it into one frozen record.

Every layer is GQA attention (q/k/v biases or per-head q/k RMSNorm, RoPE)
and a SwiGLU MLP or routed SwiGLU experts, of which one chip holds a
share.  The program runs it as ``block_pattern=("attn",)``; its
reference is ``reference/qwen.py``.
"""
from __future__ import annotations

import dataclasses
import math

from portbench.counts import BF16, bound_s, causal_pairs
from portbench.port import (  # noqa: F401  (the family's entry points)
    init_caches, make_decode_step, make_prefill_step)
from portbench.reference.qwen import Reference  # noqa: F401
from portbench.weights import (BIAS_STD, EMBED_STD, NORM_STD, ROUTER_STD,
                               fan_in)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# the draw plan: bf16 products and biases, f32 norms and MoE router
# ---------------------------------------------------------------------------

def layer_leaves(g: Geometry, i: int) -> list[tuple[str, tuple, str, tuple]]:
    """(name, shape, dtype, (how, scale)) of layer ``i``'s leaves, the same
    in every layer; ``how`` is ``normal`` (scale times N(0, 1)) or
    ``one_plus`` (1 + scale N(0, 1))."""
    d, q, kv = g.d_model, g.q_dim, g.kv_dim
    bf, f32 = "bfloat16", "float32"
    out = [("input_layernorm", (d,), f32, ("one_plus", NORM_STD))]
    for name, cols in (("q_proj", q), ("k_proj", kv), ("v_proj", kv)):
        out.append((f"{name}.w", (d, cols), bf,
                    ("normal", fan_in((d, cols)))))
        if g.qkv_bias:
            out.append((f"{name}.b", (cols,), bf, ("normal", BIAS_STD)))
    out.append(("o_proj.w", (q, d), bf, ("normal", fan_in((q, d)))))
    if g.qk_norm:
        out += [("q_norm", (g.head_dim,), f32, ("one_plus", NORM_STD)),
                ("k_norm", (g.head_dim,), f32, ("one_plus", NORM_STD))]
    out.append(("post_attention_layernorm", (d,), f32,
                ("one_plus", NORM_STD)))
    f = g.d_ff
    if g.is_moe:
        e = g.n_held
        out += [("mlp.router", (d, g.router_outputs), f32,
                 ("normal", ROUTER_STD)),
                ("mlp.experts.gate_proj", (e, d, f), bf,
                 ("normal", fan_in((d, f)))),
                ("mlp.experts.up_proj", (e, d, f), bf,
                 ("normal", fan_in((d, f)))),
                ("mlp.experts.down_proj", (e, f, d), bf,
                 ("normal", fan_in((f, d))))]
    else:
        out += [("mlp.gate_proj", (d, f), bf, ("normal", fan_in((d, f)))),
                ("mlp.up_proj", (d, f), bf, ("normal", fan_in((d, f)))),
                ("mlp.down_proj", (f, d), bf, ("normal", fan_in((f, d))))]
    return out


def top_leaves(g: Geometry) -> list[tuple[str, tuple, str, tuple]]:
    d, v = g.d_model, g.padded_vocab
    return [("embed_tokens", (v, d), "bfloat16", ("normal", EMBED_STD)),
            ("norm", (d,), "float32", ("one_plus", NORM_STD)),
            ("lm_head", (d, v), "bfloat16", ("normal", fan_in((d, v))))]


# ---------------------------------------------------------------------------
# the adapter to the program
# ---------------------------------------------------------------------------

#: The benchmark's leaf names as the program names them.
LAYER_NAMES = {
    "input_layernorm": "ln1.scale",
    "q_proj.w": "attn.wq.w", "q_proj.b": "attn.wq.b",
    "k_proj.w": "attn.wk.w", "k_proj.b": "attn.wk.b",
    "v_proj.w": "attn.wv.w", "v_proj.b": "attn.wv.b",
    "o_proj.w": "attn.wo.w",
    "q_norm": "attn.q_norm.scale", "k_norm": "attn.k_norm.scale",
    "post_attention_layernorm": "ln2.scale",
    "mlp.gate_proj": "mlp.wg.w", "mlp.up_proj": "mlp.wi.w",
    "mlp.down_proj": "mlp.wo.w",
    "mlp.router": "moe.router.w", "mlp.experts.gate_proj": "moe.wg",
    "mlp.experts.up_proj": "moe.wi", "mlp.experts.down_proj": "moe.wo",
}
TOP_NAMES = {"embed_tokens": "embed", "norm": "ln_f.scale",
             "lm_head": "head.w"}


def model_config(g: Geometry):
    """The program's ``ModelConfig`` of the configuration, kernels on."""
    from repro_torch.models.config import ModelConfig

    moe = {}
    if g.is_moe:
        moe = dict(n_experts=g.router_outputs, experts_per_token=g.top_k,
                   capacity_factor=g.capacity_factor, moe_impl="einsum")
    cfg = ModelConfig(
        name=g.name, family="moe" if g.is_moe else "dense",
        n_layers=g.n_layers, d_model=g.d_model, n_heads=g.n_heads,
        n_kv_heads=g.n_kv_heads, d_head=g.head_dim, d_ff=g.d_ff,
        vocab_size=g.vocab, block_pattern=("attn",), qkv_bias=g.qkv_bias,
        use_qk_norm=g.qk_norm, rope_theta=g.rope_theta, norm="rmsnorm",
        act="silu", glu=True, dtype="bfloat16", use_kernels=True, **moe)
    if cfg.padded_vocab != g.padded_vocab:
        raise ValueError(f"{g.name}: the program pads the vocabulary to "
                         f"{cfg.padded_vocab}, the file assumes "
                         f"{g.padded_vocab}")
    return cfg


def port_state_dict(weights: dict) -> dict:
    """The benchmark's leaves under the program's parameter names."""
    out = {}
    for name, t in weights.items():
        if name.startswith("layers."):
            _, i, leaf = name.split(".", 2)
            out[f"layers.{i}.{LAYER_NAMES[leaf]}"] = t
        else:
            out[TOP_NAMES[name]] = t
    return out


def load_model(g: Geometry, cfg, weights: dict, device):
    """The program's model holding ``weights`` (every parameter given),
    prepared for serving by the program's own ``to_serving``."""
    from repro_torch.models.convert import load, to_serving

    experts = g.held if g.is_moe else None
    return to_serving(load(cfg, port_state_dict(weights), device=device,
                           experts=experts))


def cache_leaves(g: Geometry, layer: int, batch: int,
                 max_len: int) -> list[tuple[str, tuple, str]]:
    """Every layer's K and V, ``max_len`` rows each."""
    shape = (batch, max_len, g.n_kv_heads, g.head_dim)
    return [("k", shape, "k"), ("v", shape, "v")]


# ---------------------------------------------------------------------------
# counts: operations and bytes of each kernel and of each whole step
# ---------------------------------------------------------------------------

def flash_attention(g: Geometry, batch: int, seq: int) -> dict:
    """One causal K5 call over a prefill of ``batch`` x ``seq``: 4 D
    operations (Q K^T and P V) a live pair and query head; q, k, v read
    and the output written once."""
    flops = 4.0 * batch * g.n_heads * g.head_dim * causal_pairs(seq)
    nbytes = BF16 * batch * seq * (2 * g.q_dim + 2 * g.kv_dim)
    return {"flops": flops, "bytes": float(nbytes),
            "bound_s": bound_s(flops, nbytes)}


def decode_attention(g: Geometry, batch: int, live: int) -> dict:
    """One K4 call: each row's query over ``live`` cache rows; K and V of
    the live rows read once, q read and the output written once."""
    flops = 4.0 * batch * g.n_heads * g.head_dim * live
    nbytes = BF16 * (2 * batch * live * g.kv_dim + 2 * batch * g.q_dim)
    return {"flops": flops, "bytes": float(nbytes),
            "bound_s": bound_s(flops, nbytes)}


def layer_product_params(g: Geometry) -> int:
    """Weights one layer multiplies in bf16 for every token (the experts
    apart: they multiply only the rows routed to them)."""
    attn = g.d_model * (g.q_dim + 2 * g.kv_dim) + g.q_dim * g.d_model
    return attn if g.is_moe else attn + 3 * g.d_model * g.d_ff


def weight_bytes(g: Geometry) -> int:
    """Bytes of every weight a step reads whole: all but the embedding
    table (a step reads its tokens' rows), norms and router in f32."""
    d = g.d_model
    bias = (g.q_dim + 2 * g.kv_dim) if g.qkv_bias else 0
    per_layer = BF16 * (layer_product_params(g) + bias) + 4 * 2 * d
    if g.qk_norm:
        per_layer += 4 * 2 * g.head_dim
    if g.is_moe:
        per_layer += BF16 * 3 * g.n_held * d * g.d_ff \
            + 4 * d * g.router_outputs
    return g.n_layers * per_layer + BF16 * d * g.padded_vocab + 4 * d


def expert_flops(g: Geometry, kept_pairs: float) -> float:
    """The held experts' products over ``kept_pairs`` (token, expert)
    rows, summed over layers: gate, up and down."""
    return 6.0 * g.d_model * g.d_ff * kept_pairs


def prefill_call(g: Geometry, batch: int, seq: int,
                 kept_pairs: float = 0.0) -> dict:
    """One ``make_prefill_step`` call: every layer over ``batch`` x ``seq``
    tokens and the head at the last position (the step's output).  An MoE
    step multiplies only the rows its held experts keep: ``kept_pairs``,
    the reference's routing."""
    tokens = batch * seq
    att = flash_attention(g, batch, seq)
    flops = (2.0 * tokens * layer_product_params(g) * g.n_layers
             + att["flops"] * g.n_layers
             + 2.0 * batch * g.d_model * g.padded_vocab
             + expert_flops(g, kept_pairs))
    f32 = 2.0 * tokens * g.d_model * g.router_outputs * g.n_layers
    nbytes = (weight_bytes(g) + BF16 * tokens * g.d_model
              + BF16 * batch * g.padded_vocab)
    return {"flops": flops, "f32_flops": f32, "bytes": float(nbytes),
            "bound_s": bound_s(flops, nbytes, f32)}


def decode_step(g: Geometry, batch: int, index: int) -> dict:
    """One ``make_decode_step`` at position ``index`` (dense): the weights
    read once, every layer's live K/V rows (``index + 1``) read once and
    the new row written, the embedding rows and the logits."""
    live = index + 1
    att = decode_attention(g, batch, live)
    flops = (2.0 * batch * (layer_product_params(g) * g.n_layers
                            + g.d_model * g.padded_vocab)
             + att["flops"] * g.n_layers)
    cache = BF16 * 2 * batch * (live + 1) * g.kv_dim * g.n_layers
    nbytes = (weight_bytes(g) + cache + BF16 * batch * g.d_model
              + BF16 * batch * g.padded_vocab)
    return {"flops": flops, "bytes": float(nbytes),
            "bound_s": bound_s(flops, nbytes)}


def kernel_bounds(g: Geometry, phase: str, batch: int, n: int) -> dict:
    """K5 over every layer of a prefill call of ``batch`` x ``n``, or K4
    over every layer of a decode step at position ``n``."""
    if phase == "prefill":
        return {"flash_attention":
                flash_attention(g, batch, n)["bound_s"] * g.n_layers}
    return {"decode_attention":
            decode_attention(g, batch, n + 1)["bound_s"] * g.n_layers}


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

#: Kernel-name fragments of the program's own kernels, by kernel.
KERNELS = {"flash_attention": ("flash_wgmma", "flash_simt"),
           "decode_attention": ("decode_bulk", "decode_merge",
                                "decode_split")}
#: The compared number of each kernel's launches.
LAUNCH_CHECKS = {"flash_attention": "k5_launches_off",
                 "decode_attention": "k4_launches_off"}
#: The kernels the program builds for the cells.
BUILD = ("flash_attention", "decode_attention")


def counters() -> dict:
    """Each kernel's wrapper, which counts its launches (on the CPU the
    wrappers run their plain versions and count nothing)."""
    from repro_torch.kernels.decode_attention import ops as DA
    from repro_torch.kernels.flash_attention import ops as FA

    return {"flash_attention": FA.flash_attention,
            "decode_attention": DA.decode_attention}


def expected_launches(g: Geometry, phase: str, n: int) -> dict:
    """One K5 launch a layer a prefill call, one K4 a layer a decode
    step."""
    kernel = "flash_attention" if phase == "prefill" else "decode_attention"
    return {kernel: n * g.n_layers}
