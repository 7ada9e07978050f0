"""Family ``deepseek_v3``: DeepSeek-V3's decoder (the contract is in
``archs/__init__.py``).

``configs/<name>.json`` holds the published ``config.json`` keys, the
keys cut for one chip (``reduced``, with the published values under
``published``), the expert share and capacity rule, what was assumed,
and ``architecture`` (``family``: ``deepseek_v3``, and what the
published modeling code fixes besides).  :func:`geometry` turns it into
one frozen record.

Every layer is latent attention (MLA: low-rank q and kv paths, q and k
heads of 128 + 64, v heads of 128, YaRN RoPE on the 64) and, in the
first ``first_k_dense_replace`` layers, a SwiGLU MLP, after them routed
SwiGLU experts under the sigmoid ``noaux_tc`` gate, of which one chip
holds a share, beside a shared expert every token passes through.  The
program runs it as ``block_pattern=("mla",)`` (``repro_torch``'s
``MLAConfig``); its reference is ``reference/deepseek_v3.py``.  The
kernel table is the ``qwen`` family's; the launch counts add the MoE
combine's to K5's: K5 (its 192/128 instance) once a layer a prefill
call, the combine once an MoE layer.  :func:`routed_layers` hands the
traffic kind ``prefill_batches_routed`` what the program's MoE layers
took and gave, for the reference's layers to judge.
"""
from __future__ import annotations

import dataclasses
import math

from portbench.archs import qwen
from portbench.archs.qwen import KERNELS  # noqa: F401  (shared table)
from portbench.counts import BF16, bound_s, causal_pairs
from portbench.port import (  # noqa: F401  (the family's entry points)
    init_caches, make_decode_step, make_prefill_step)
from portbench.reference.deepseek_v3 import Reference  # noqa: F401
from portbench.weights import EMBED_STD, NORM_STD, ROUTER_STD, fan_in

#: The correction bias's draw: N(0, GATE_BIAS_STD^2), f32 (``assumed`` in
#: the configuration states it and the share of choices it changes).
GATE_BIAS_STD = 0.01
#: The routed experts' down projections are drawn this much smaller than
#: the other residual branches' (``layer_leaves``), for the logits' check
#: alone: the routed layers' check reads the routed part by itself.
ROUTED_OUT_SCALE = 0.25


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Geometry:
    name: str
    d_model: int
    n_layers: int
    n_heads: int
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int
    d_ff: int                       # one expert's (and the shared one's)
    d_ff_dense: int                 # the leading dense layers' MLP
    n_dense_layers: int
    vocab: int
    padded_vocab: int
    eps: float
    rope_theta: float
    rope_factor: float
    rope_original_max: int
    rope_beta_fast: float
    rope_beta_slow: float
    rope_mscale: float
    rope_mscale_all_dim: float
    router_outputs: int
    top_k: int
    n_group: int
    topk_group: int
    routed_scaling_factor: float
    norm_topk_prob: bool
    n_shared_experts: int
    held: tuple[int, int]
    group_tokens: int
    capacity_factor: float
    dtype: str                      # the products' and activations'
    # the residual branches' output projections are drawn N(0, out_scale^2
    # / fan_in): 1 / sqrt(2 L) of the published depth L
    out_scale: float

    is_moe = True

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim

    @property
    def n_held(self) -> int:
        return self.held[1] - self.held[0]

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers - self.n_dense_layers

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
    lo, hi = c["expert_share"]["held"]
    if hi - lo != c["n_routed_experts"]:
        raise ValueError(f"{c['name']}: n_routed_experts "
                         f"{c['n_routed_experts']} is not the {hi - lo} "
                         "experts held")
    if c["scoring_func"] != "sigmoid" or c["topk_method"] != "noaux_tc":
        raise ValueError(f"{c['name']}: the family routes by the sigmoid "
                         "noaux_tc gate only")
    rope, cap = c["rope_scaling"], c["capacity"]
    return Geometry(
        name=c["name"], d_model=c["hidden_size"],
        n_layers=c["num_hidden_layers"], n_heads=c["num_attention_heads"],
        q_lora_rank=c["q_lora_rank"], kv_lora_rank=c["kv_lora_rank"],
        qk_nope_dim=c["qk_nope_head_dim"], qk_rope_dim=c["qk_rope_head_dim"],
        v_head_dim=c["v_head_dim"], d_ff=c["moe_intermediate_size"],
        d_ff_dense=c["intermediate_size"],
        n_dense_layers=c["first_k_dense_replace"], vocab=c["vocab_size"],
        padded_vocab=c["assumed"]["padded_vocab"],
        eps=float(c["rms_norm_eps"]), rope_theta=float(c["rope_theta"]),
        rope_factor=float(rope["factor"]),
        rope_original_max=rope["original_max_position_embeddings"],
        rope_beta_fast=float(rope["beta_fast"]),
        rope_beta_slow=float(rope["beta_slow"]),
        rope_mscale=float(rope["mscale"]),
        rope_mscale_all_dim=float(rope["mscale_all_dim"]),
        router_outputs=c["expert_share"]["router_outputs"],
        top_k=c["num_experts_per_tok"], n_group=c["n_group"],
        topk_group=c["topk_group"],
        routed_scaling_factor=float(c["routed_scaling_factor"]),
        norm_topk_prob=bool(c["norm_topk_prob"]),
        n_shared_experts=c["n_shared_experts"], held=(lo, hi),
        group_tokens=cap["group_tokens"],
        capacity_factor=float(cap["capacity_factor"]),
        dtype=c["dtype"]["products"],
        out_scale=1.0 / math.sqrt(2 * c.get("published", {}).get(
            "num_hidden_layers", c["num_hidden_layers"])))


# ---------------------------------------------------------------------------
# the draw plan: bf16 products, f32 norms, gate and its bias
# ---------------------------------------------------------------------------

def _swiglu(pre: str, d: int, f: int, out_scale: float,
            lead: tuple = ()) -> list:
    bf = "bfloat16"
    return [(pre + "gate_proj", (*lead, d, f), bf, ("normal", fan_in((d, f)))),
            (pre + "up_proj", (*lead, d, f), bf, ("normal", fan_in((d, f)))),
            (pre + "down_proj", (*lead, f, d), bf,
             ("normal", out_scale * fan_in((f, d))))]


def layer_leaves(g: Geometry, i: int) -> list[tuple[str, tuple, str, tuple]]:
    """(name, shape, dtype, (how, scale)) of layer ``i``'s leaves: its
    attention, then the dense MLP (``i`` below ``n_dense_layers``) or the
    gate, the held experts and the shared expert.  Products are N(0,
    1/fan_in), the residual branches' output projections (``o_proj``,
    every ``down_proj``) that times ``g.out_scale``: GPT-2's and
    Megatron-LM's scaled initialization, which keeps each layer's part of
    the residual stream small, as in a trained model; the routed experts'
    a further ``ROUTED_OUT_SCALE``.  A gate choice that bf16 rounding
    flips (a held expert in on one side of the comparison, out on the
    other) then moves the residual stream less than the rounding does.
    Drawn as large as the other branches, such flips cascade through a
    token's later layers, and the bf16 program reads as far from the f32
    reference as the fp8 control on some seeds (``PERF.md`` §2).  The
    routing itself is judged layer by layer on the program's own inputs
    (the kind ``prefill_batches_routed``), whatever this scale."""
    d, H = g.d_model, g.n_heads
    bf, f32 = "bfloat16", "float32"
    norm = ("one_plus", NORM_STD)
    at = "self_attn."

    def proj(name, n_in, n_out, scale=1.0):
        return (at + name + ".w", (n_in, n_out), bf,
                ("normal", scale * fan_in((n_in, n_out))))
    out = [("input_layernorm", (d,), f32, norm),
           proj("q_a_proj", d, g.q_lora_rank),
           (at + "q_a_layernorm", (g.q_lora_rank,), f32, norm),
           proj("q_b_proj", g.q_lora_rank, H * g.qk_head_dim),
           proj("kv_a_proj_with_mqa", d, g.kv_lora_rank + g.qk_rope_dim),
           (at + "kv_a_layernorm", (g.kv_lora_rank,), f32, norm),
           proj("kv_b_proj", g.kv_lora_rank,
                H * (g.qk_nope_dim + g.v_head_dim)),
           proj("o_proj", H * g.v_head_dim, d, g.out_scale),
           ("post_attention_layernorm", (d,), f32, norm)]
    if i < g.n_dense_layers:
        return out + _swiglu("mlp.", d, g.d_ff_dense, g.out_scale)
    return (out
            + [("mlp.gate.weight", (d, g.router_outputs), f32,
                ("normal", ROUTER_STD)),
               ("mlp.gate.e_score_correction_bias", (g.router_outputs,), f32,
                ("normal", GATE_BIAS_STD))]
            + _swiglu("mlp.experts.", d, g.d_ff,
                      ROUTED_OUT_SCALE * g.out_scale, (g.n_held,))
            + _swiglu("mlp.shared_experts.", d, g.n_shared_experts * g.d_ff,
                      g.out_scale))


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
    "self_attn.q_a_proj.w": "attn.wq_a.w",
    "self_attn.q_a_layernorm": "attn.q_norm.scale",
    "self_attn.q_b_proj.w": "attn.wq_b.w",
    "self_attn.kv_a_proj_with_mqa.w": "attn.wkv_a.w",
    "self_attn.kv_a_layernorm": "attn.kv_norm.scale",
    "self_attn.kv_b_proj.w": "attn.wkv_b.w",
    "self_attn.o_proj.w": "attn.wo.w",
    "post_attention_layernorm": "ln2.scale",
    "mlp.gate_proj": "mlp.wg.w", "mlp.up_proj": "mlp.wi.w",
    "mlp.down_proj": "mlp.wo.w",
    "mlp.gate.weight": "moe.router.w",
    "mlp.gate.e_score_correction_bias": "moe.router.bias",
    "mlp.experts.gate_proj": "moe.wg", "mlp.experts.up_proj": "moe.wi",
    "mlp.experts.down_proj": "moe.wo",
    "mlp.shared_experts.gate_proj": "moe.shared.wg.w",
    "mlp.shared_experts.up_proj": "moe.shared.wi.w",
    "mlp.shared_experts.down_proj": "moe.shared.wo.w",
}
TOP_NAMES = {"embed_tokens": "embed", "norm": "ln_f.scale",
             "lm_head": "head.w"}


def model_config(g: Geometry):
    """The program's ``MLAConfig`` of the configuration, kernels on, its
    products and activations in the configuration's dtype."""
    from repro_torch.models.config import MLAConfig

    cfg = MLAConfig(
        name=g.name, family="moe", n_layers=g.n_layers, d_model=g.d_model,
        n_heads=g.n_heads, n_kv_heads=g.n_heads, d_head=g.qk_head_dim,
        d_ff=g.d_ff, vocab_size=g.vocab, n_experts=g.router_outputs,
        experts_per_token=g.top_k, capacity_factor=g.capacity_factor,
        moe_impl="einsum", block_pattern=("mla",), norm="rmsnorm",
        act="silu", glu=True, rope_theta=g.rope_theta, dtype=g.dtype,
        use_kernels=True, q_lora_rank=g.q_lora_rank,
        kv_lora_rank=g.kv_lora_rank, qk_nope_dim=g.qk_nope_dim,
        qk_rope_dim=g.qk_rope_dim, v_head_dim=g.v_head_dim,
        rope_factor=g.rope_factor, rope_original_max=g.rope_original_max,
        rope_beta_fast=g.rope_beta_fast, rope_beta_slow=g.rope_beta_slow,
        rope_mscale=g.rope_mscale, rope_mscale_all_dim=g.rope_mscale_all_dim,
        scoring_func="sigmoid", n_group=g.n_group, topk_group=g.topk_group,
        routed_scaling_factor=g.routed_scaling_factor,
        norm_topk_prob=g.norm_topk_prob,
        n_shared_experts=g.n_shared_experts,
        n_dense_layers=g.n_dense_layers, d_ff_dense=g.d_ff_dense)
    if cfg.padded_vocab != g.padded_vocab or abs(g.eps - 1e-6) > 1e-12:
        raise ValueError(f"{g.name}: the program pads the vocabulary to "
                         f"{cfg.padded_vocab} and normalizes with eps 1e-6; "
                         f"the file states {g.padded_vocab} and {g.eps}")
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
    """The program's model holding ``weights`` (every parameter given; the
    held experts of each MoE layer), prepared for serving by the
    program's own ``to_serving``."""
    from repro_torch.models.convert import load, to_serving

    return to_serving(load(cfg, port_state_dict(weights), device=device,
                           experts=g.held))


def cache_leaves(g: Geometry, layer: int, batch: int,
                 max_len: int) -> list[tuple[str, tuple, str]]:
    """Every layer's latent cache: the normalized latent and the rotated
    shared key, ``max_len`` rows each."""
    return [("latent", (batch, max_len, g.kv_lora_rank), "latent"),
            ("k_pe", (batch, max_len, g.qk_rope_dim), "k_pe")]


# ---------------------------------------------------------------------------
# counts: operations and bytes of K5 and of each whole step
# ---------------------------------------------------------------------------

def flash_attention(g: Geometry, batch: int, seq: int) -> dict:
    """One causal K5 call at 192/128 over a prefill of ``batch`` x
    ``seq``: 2 (192 + 128) operations (Q K^T and P V) a live pair and
    head; q, k, v read and the output written once."""
    flops = 2.0 * batch * g.n_heads * causal_pairs(seq) \
        * (g.qk_head_dim + g.v_head_dim)
    nbytes = BF16 * batch * seq * g.n_heads * 2 * (g.qk_head_dim
                                                   + g.v_head_dim)
    return {"flops": flops, "bytes": float(nbytes),
            "bound_s": bound_s(flops, nbytes)}


def mla_params(g: Geometry) -> int:
    """The weights latent attention multiplies for every token: q_a, q_b,
    kv_a, kv_b and o."""
    H = g.n_heads
    return (g.d_model * g.q_lora_rank + g.q_lora_rank * H * g.qk_head_dim
            + g.d_model * (g.kv_lora_rank + g.qk_rope_dim)
            + g.kv_lora_rank * H * (g.qk_nope_dim + g.v_head_dim)
            + H * g.v_head_dim * g.d_model)


def token_params(g: Geometry) -> int:
    """Weights every token multiplies in bf16, summed over layers: latent
    attention, the dense layers' MLP and the MoE layers' shared expert
    (the held experts apart: they multiply only the rows routed to
    them)."""
    return (g.n_layers * mla_params(g)
            + g.n_dense_layers * 3 * g.d_model * g.d_ff_dense
            + g.n_moe_layers * 3 * g.d_model * g.n_shared_experts * g.d_ff)


def weight_bytes(g: Geometry) -> int:
    """Bytes of every weight a step reads whole: all but the embedding
    table (a step reads its tokens' rows); norms, gate and bias in f32."""
    d = g.d_model
    norms = 4 * (2 * d + g.q_lora_rank + g.kv_lora_rank)
    moe = g.n_moe_layers * (BF16 * 3 * g.n_held * d * g.d_ff
                            + 4 * (d + 1) * g.router_outputs)
    return (BF16 * token_params(g) + g.n_layers * norms + moe
            + BF16 * d * g.padded_vocab + 4 * d)


def prefill_call(g: Geometry, batch: int, seq: int,
                 kept_pairs: float = 0.0) -> dict:
    """One ``make_prefill_step`` call: every layer over ``batch`` x ``seq``
    tokens and the head at the last position (the step's output).  The
    held experts multiply only the rows they keep: ``kept_pairs``, the
    reference's routing, summed over layers."""
    tokens = batch * seq
    flops = (2.0 * tokens * token_params(g)
             + flash_attention(g, batch, seq)["flops"] * g.n_layers
             + 6.0 * g.d_model * g.d_ff * kept_pairs
             + 2.0 * batch * g.d_model * g.padded_vocab)
    f32 = 2.0 * tokens * g.d_model * g.router_outputs * g.n_moe_layers
    nbytes = (weight_bytes(g) + BF16 * tokens * g.d_model
              + BF16 * batch * g.padded_vocab)
    return {"flops": flops, "f32_flops": f32, "bytes": float(nbytes),
            "bound_s": bound_s(flops, nbytes, f32)}


def decode_step(g: Geometry, batch: int, index: int) -> dict:
    """One ``make_decode_step`` at position ``index``: the weights read
    once, every layer's live latent-cache rows (``index + 1``) read once
    and the new row written; attention in the latent space, scores and
    weighted sums over 512 + 64 values a live row (``kv_b``'s two halves,
    absorbed into the query and applied to the weighted latent, are its
    product of every token); each token's expected share of the held
    experts (``top_k`` of ``router_outputs``)."""
    live, H = index + 1, g.n_heads
    attn = 2.0 * batch * H * live * (2 * g.kv_lora_rank + g.qk_rope_dim)
    experts = batch * g.top_k * g.n_held / g.router_outputs
    flops = (2.0 * batch * (token_params(g) + g.d_model * g.padded_vocab)
             + attn * g.n_layers
             + 6.0 * g.d_model * g.d_ff * experts * g.n_moe_layers)
    cache = BF16 * batch * (live + 1) * (g.kv_lora_rank + g.qk_rope_dim) \
        * g.n_layers
    nbytes = (weight_bytes(g) + cache + BF16 * batch * g.d_model
              + BF16 * batch * g.padded_vocab)
    return {"flops": flops, "bytes": float(nbytes),
            "bound_s": bound_s(flops, nbytes)}


def kernel_bounds(g: Geometry, phase: str, batch: int, n: int) -> dict:
    """K5 over every layer of a prefill call of ``batch`` x ``n``; a decode
    step launches no kernel of the table."""
    if phase == "prefill":
        return {"flash_attention":
                flash_attention(g, batch, n)["bound_s"] * g.n_layers}
    return {}


# ---------------------------------------------------------------------------
# kernels (``KERNELS`` is ``qwen``'s)
# ---------------------------------------------------------------------------

#: The kernels the program builds for the cells: K5 and the MoE combine.
BUILD = ("flash_attention", "moe_combine")
#: The compared number of each kernel's launches.
LAUNCH_CHECKS = {**qwen.LAUNCH_CHECKS, "moe_combine": "k8_launches_off"}


def counters() -> dict:
    """Each kernel's wrapper, which counts its launches: ``qwen``'s and the
    MoE combine's."""
    from repro_torch.kernels.moe_combine import ops as MC

    return {**qwen.counters(), "moe_combine": MC.combine}


def expected_launches(g: Geometry, phase: str, n: int) -> dict:
    """One K5 launch a layer and one MoE combine an MoE layer a prefill
    call; a decode step attends in torch products and launches no K4."""
    if phase == "prefill":
        return {"flash_attention": n * g.n_layers,
                "moe_combine": n * g.n_moe_layers}
    return {"decode_attention": 0}


# ---------------------------------------------------------------------------
# the MoE layers as the program ran them
# ---------------------------------------------------------------------------

def routed_layers(g: Geometry, cfg, model, step, tokens) -> list[dict]:
    """The program's MoE layers on one prefill call of ``tokens`` (B, S),
    run once more: for each MoE layer, in order, its index ``layer``, the
    input it took over the capacity group that ends at the call's last
    token (``x`` (n, d)), what the held experts added there (``out`` (n,
    d)) and each token's choices (``experts`` (n, k), best first).  A
    group's routing needs no other group, so the layer run on that group
    alone gives what it gave inside the call."""
    import torch

    from repro_torch.models import moe as MOE

    B, S = tokens.shape
    n = g.groups(B * S, S)[0]
    seen = []
    forward = MOE.forward

    def spy(p, cfg_, x, decode=False):
        seen.append((p, x.reshape(-1, x.shape[-1])[-n:].clone()))
        return forward(p, cfg_, x, decode)
    MOE.forward = spy
    try:
        step(model, {"tokens": tokens})
    finally:
        MOE.forward = forward
    out = []
    with torch.no_grad():
        for i, (p, x) in enumerate(seen, start=g.n_dense_layers):
            y, _ = MOE._routed(p, cfg, x[None], False)
            experts = MOE.assign(p, cfg, x[None], "einsum")[2]
            out.append({"layer": i, "x": x, "out": y[0],
                        "experts": experts.reshape(n, -1)})
    return out
