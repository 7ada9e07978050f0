"""Operations and bytes of each kernel and of each whole step, from shapes.

The published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at 700 W) are the table every share is taken against.  A bound is the
least time the card could take: the larger of operations over the peak
rate and bytes over the HBM bandwidth, each input byte read once and each
output byte written once.  Products the configuration states in f32 (the
MoE router) are held to the f32 peak outside the tensor cores.

Counts follow the configuration's file (``spec.Geometry``), not the
program, so that a change of the program cannot move its own yardstick.
An MoE step multiplies only the rows its held experts keep; the caller
passes that count (the reference's routing, ``kept_pairs``).
"""
from __future__ import annotations

from portbench.spec import Geometry

PEAK_BF16_FLOPS = 989e12          # bf16 on the tensor cores, dense
PEAK_FP32_FLOPS = 67e12           # f32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12        # HBM3
BF16 = 2


def bound_s(flops: float = 0.0, nbytes: float = 0.0,
            f32_flops: float = 0.0) -> float:
    """The roofline's least time of work of ``flops`` bf16 tensor-core
    operations, ``f32_flops`` f32 ones and ``nbytes`` bytes moved."""
    return max(flops / PEAK_BF16_FLOPS + f32_flops / PEAK_FP32_FLOPS,
               nbytes / PEAK_BYTES_PER_S)


def causal_pairs(seq: int) -> int:
    """(query, key) pairs a causal mask leaves live in one head."""
    return seq * (seq + 1) // 2


# ---------------------------------------------------------------------------
# kernels
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


# ---------------------------------------------------------------------------
# whole steps
# ---------------------------------------------------------------------------

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
    tokens and the head at the last position (the step's output)."""
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
