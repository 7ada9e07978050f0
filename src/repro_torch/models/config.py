"""Model configuration for every architecture family in the zoo.

A model is a stack of *blocks*; ``block_pattern`` names the per-layer block
kinds and is cycled/structured into scan groups by the transformer driver:

    "attn"       full (GQA) attention + MLP
    "local"      sliding-window attention + MLP
    "rglru"      RG-LRU recurrent block + MLP      (RecurrentGemma/Griffin)
    "mlstm"      mLSTM block (matrix memory, internal up-proj, no MLP)
    "slstm"      sLSTM block (scalar memory + causal conv, post-FFN)

The pattern is repeated ``n_layers / len(pattern)`` times when it divides
evenly; otherwise ``pattern_repeats`` full repeats are scanned and the
remainder is applied unscanned (RecurrentGemma's 38 = 12x(R,R,A) + (R,R)).

Port of ``repro.models.config``: the same fields and derived quantities
(``param_count``, ``model_bytes`` ...), with two differences.
``activation_dtype`` is a ``torch.dtype``, and the reference's
``use_pallas`` is ``use_kernels``: on CUDA tensors the attention takes the
port's kernels (K5 on prefill, K4 on decode), which launch or raise; with
``use_kernels=False`` it takes the reference's XLA-path counterparts
(``blocked_attention``/``dense_attention``).  On CPU tensors the kernels'
wrappers run their plain versions.  The port keeps one module per layer,
so ``scan_layers_decode`` is carried for parity and read by nothing;
``remat`` is read by ``transformer.forward_hidden``, which checkpoints each
pattern group and each block when autograd records, as the reference does.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | audio | vlm | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                  # 0 -> d_model // n_heads
    # block structure
    block_pattern: tuple[str, ...] = ("attn",)
    remainder_pattern: tuple[str, ...] = ()
    # attention
    qkv_bias: bool = False
    o_bias: bool = False
    mlp_bias: bool = False
    rope_theta: float = 10_000.0
    local_window: int = 2048
    is_decoder: bool = True
    use_qk_norm: bool = False
    logit_softcap: float = 0.0       # grok-style tanh soft-capping (0 = off)
    # MLP
    act: str = "silu"                # silu (SwiGLU) | gelu (GeGLU or plain)
    glu: bool = True
    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2
    moe_impl: str = "einsum"         # einsum (SPMD-native) | sort (gather)
    # recurrent (hybrid / ssm)
    d_rnn: int = 0                   # RG-LRU recurrence width (0 -> d_model)
    conv_width: int = 4
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    chunk_size: int = 256            # chunkwise-parallel recurrence chunk
    # embeddings / head
    tie_embeddings: bool = False
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    frontend: str | None = None      # None | audio | vision
    frontend_dim: int = 0            # raw feature dim of the stubbed frontend
    # numerics / runtime
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    kv_cache_dtype: str = ""         # "" -> dtype; "float8_e4m3fn" halves KV traffic
    scan_layers_decode: bool = True  # the reference's decode layer scan
    remat: bool = True
    attn_block_q: int = 512          # chunked-attention tile sizes (XLA path)
    attn_block_kv: int = 1024
    use_kernels: bool = True         # K4/K5 on CUDA; False: the plain attention

    # ----- derived -----
    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so embedding/head parameters
        shard evenly on any production mesh (standard practice; the logical
        ``vocab_size`` is unchanged — padded rows only see the logsumexp
        gradient)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def rnn_width(self) -> int:
        return self.d_rnn or self.d_model

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def pattern_repeats(self) -> int:
        return (self.n_layers - len(self.remainder_pattern)) // len(self.block_pattern)

    def __post_init__(self):
        used = (self.pattern_repeats * len(self.block_pattern)
                + len(self.remainder_pattern))
        if used != self.n_layers:
            raise ValueError(
                f"{self.name}: pattern {self.block_pattern} x "
                f"{self.pattern_repeats} + {self.remainder_pattern} != "
                f"{self.n_layers} layers")
        if self.is_moe and self.experts_per_token <= 0:
            raise ValueError(f"{self.name}: MoE needs experts_per_token")

    @property
    def block_kinds(self) -> tuple[str, ...]:
        """Flat per-layer kinds (scan repeats + remainder)."""
        return self.block_pattern * self.pattern_repeats + self.remainder_pattern

    @property
    def has_attention(self) -> bool:
        return any(k in ("attn", "local") for k in self.block_kinds)

    @property
    def sub_quadratic(self) -> bool:
        """True if no *full* attention blocks (long-context capable)."""
        return "attn" not in self.block_kinds

    # ----- parameter counting (for MODEL_FLOPS and memory budgeting) -----
    def param_count(self) -> int:
        return sum(self._params_per_block(k) for k in self.block_kinds) + self._embed_params()

    def active_param_count(self) -> int:
        total = self._embed_params()
        for k in self.block_kinds:
            p = self._params_per_block(k)
            if k == "attn" or k == "local":
                if self.is_moe:
                    dense = self._attn_params()
                    moe_active = (self.experts_per_token * 3 * self.d_model * self.d_ff
                                  + self.n_experts * self.d_model)
                    p = dense + moe_active + 2 * self.d_model
            total += p
        return total

    def _embed_params(self) -> int:
        n = self.vocab_size * self.d_model  # logical (padding excluded)
        if not self.tie_embeddings:
            n *= 2
        if self.frontend:
            n += self.frontend_dim * self.d_model
        return n + self.d_model  # final norm

    def _attn_params(self) -> int:
        return (self.d_model * self.q_dim + 2 * self.d_model * self.kv_dim
                + self.q_dim * self.d_model)

    def _mlp_params(self) -> int:
        if self.is_moe:
            return (self.n_experts * 3 * self.d_model * self.d_ff
                    + self.n_experts * self.d_model)
        mats = 3 if self.glu else 2
        return mats * self.d_model * self.d_ff

    def _params_per_block(self, kind: str) -> int:
        norms = 2 * self.d_model
        if kind in ("attn", "local"):
            return self._attn_params() + self._mlp_params() + norms
        if kind == "rglru":
            w = self.rnn_width
            rec = (2 * self.d_model * w            # in/gate projections
                   + w * self.conv_width           # temporal conv
                   + 2 * w                         # RG-LRU gates (diagonal)
                   + w * self.d_model)             # out projection
            return rec + self._mlp_params() + norms
        if kind == "mlstm":
            d_in = int(self.d_model * self.mlstm_proj_factor)
            return (self.d_model * 2 * d_in        # up projections (x, gate)
                    + 3 * d_in * d_in // max(1, self.n_heads)  # q,k,v per-head
                    + 3 * d_in                     # i,f,o gate vectors
                    + d_in * self.d_model          # down projection
                    + norms)
        if kind == "slstm":
            d_ff = int(self.d_model * self.slstm_proj_factor)
            return (4 * self.d_model * self.d_model  # i,f,z,o projections
                    + self.d_model * self.conv_width
                    + 2 * self.d_model * d_ff
                    + norms)
        raise ValueError(f"unknown block kind {kind!r}")

    def model_flops(self, tokens: int, *, training: bool) -> float:
        """MODEL_FLOPS = 6*N*D (train) / 2*N*D (inference), N = active params."""
        n = self.active_param_count() if self.is_moe else self.param_count()
        return (6.0 if training else 2.0) * n * tokens

    def model_bytes(self, tokens: int, *, kind: str, batch: int = 1,
                    seq_len: int = 0) -> float:
        """MODEL_BYTES: algorithmic-minimum global HBM traffic per step —
        the memory-side MODEL_FLOPS analogue used for the roofline's
        useful-bytes ratio.

        train:   active params read fwd+bwd (bf16) + grads written (f32) +
                 full params + moments updated (f32/bf16 mix ~16 B/param) +
                 one activation r/w per block boundary + logits.
        decode:  active params read once + the attention KV cache streamed
                 once + recurrent states.
        prefill: params read + per-block activation traffic (KV written).
        """
        n_act = self.active_param_count() if self.is_moe else self.param_count()
        n_tot = self.param_count()
        d = self.d_model
        L = self.n_layers
        act_rw = 4.0 * tokens * d * 2.0 * L          # x r/w per block fwd+bwd
        logits = 2.0 * tokens * self.padded_vocab * 2.0
        if kind == "train":
            return (4.0 * n_act                      # bf16 fwd+bwd weight reads
                    + 20.0 * n_tot                   # f32 grads + opt update
                    + act_rw + logits)
        if kind in ("decode", "long_decode"):
            kv = 0.0
            n_attn = sum(1 for k in self.block_kinds if k == "attn")
            n_local = sum(1 for k in self.block_kinds if k == "local")
            window = min(self.local_window, seq_len or self.local_window)
            kv = (2.0 * batch * self.n_kv_heads * self.head_dim * 2.0
                  * (n_attn * (seq_len or 0) + n_local * window))
            state = 0.0
            for k in self.block_kinds:
                if k == "rglru":
                    state += 4.0 * batch * self.rnn_width * 2
                elif k == "mlstm":
                    dh = int(d * self.mlstm_proj_factor) // max(1, self.n_heads)
                    state += 4.0 * batch * self.n_heads * dh * dh * 2
                elif k == "slstm":
                    state += 4.0 * batch * d * 8
            return 2.0 * n_act + kv + state + 2.0 * batch * self.padded_vocab * 2
        # prefill
        return 2.0 * n_act + act_rw / 2.0 + logits


@dataclasses.dataclass(frozen=True)
class MLAConfig(ModelConfig):
    """A model of latent-attention (``"mla"``) blocks, as DeepSeek-V3
    publishes them (``modeling_deepseek.py``): attention through low-rank
    q and kv paths (``models/mla.py``), queries and keys of ``qk_nope_dim
    + qk_rope_dim`` columns and values of ``v_head_dim``, RoPE on the
    ``qk_rope_dim`` columns at YaRN frequencies; the first
    ``n_dense_layers`` layers a dense MLP of ``d_ff_dense``, the rest an
    MoE layer of ``n_experts`` experts of ``d_ff``, routed by sigmoid
    scores over ``n_group`` groups (``models/moe.py``), beside
    ``n_shared_experts`` experts every token passes through.  The
    reference has no such model; the fields of ``ModelConfig`` keep their
    meaning, and ``n_kv_heads`` equals ``n_heads``."""
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # YaRN (rope_scaling): factor, the trained context, the correction
    # rotations, and the two mscales of the softmax scale and the tables
    rope_factor: float = 1.0
    rope_original_max: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 1.0
    rope_mscale_all_dim: float = 0.0
    # routing (the MoE layers)
    scoring_func: str = "sigmoid"
    n_group: int = 1
    topk_group: int = 1
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = True
    n_shared_experts: int = 0
    n_dense_layers: int = 0
    d_ff_dense: int = 0

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim

    @staticmethod
    def _yarn_mscale(factor: float, mscale: float) -> float:
        return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0

    @property
    def softmax_scale(self) -> float:
        """``qk_head_dim ** -0.5``, times YaRN's ``mscale(factor,
        mscale_all_dim)`` squared where ``mscale_all_dim`` is set."""
        scale = self.qk_head_dim ** -0.5
        if self.rope_mscale_all_dim:
            m = self._yarn_mscale(self.rope_factor, self.rope_mscale_all_dim)
            scale *= m * m
        return scale

    @property
    def rope_table_scale(self) -> float:
        """The factor on YaRN's cos and sin tables."""
        return (self._yarn_mscale(self.rope_factor, self.rope_mscale)
                / self._yarn_mscale(self.rope_factor,
                                    self.rope_mscale_all_dim))

    def is_dense_layer(self, i: int) -> bool:
        return i < self.n_dense_layers or not self.is_moe

    def _mla_params(self) -> int:
        d, H = self.d_model, self.n_heads
        return (d * self.q_lora_rank + self.q_lora_rank
                + self.q_lora_rank * H * self.qk_head_dim
                + d * (self.kv_lora_rank + self.qk_rope_dim)
                + self.kv_lora_rank
                + self.kv_lora_rank * H * (self.qk_nope_dim + self.v_head_dim)
                + H * self.v_head_dim * d)

    def _layer_params(self, i: int, active: bool) -> int:
        d = self.d_model
        out = self._mla_params() + 2 * d
        if self.is_dense_layer(i):
            return out + 3 * d * self.d_ff_dense
        experts = self.experts_per_token if active else self.n_experts
        return (out + (experts + self.n_shared_experts) * 3 * d * self.d_ff
                + self.n_experts * (d + 1))   # the router and its bias

    def param_count(self) -> int:
        return self._embed_params() + sum(
            self._layer_params(i, False) for i in range(self.n_layers))

    def active_param_count(self) -> int:
        return self._embed_params() + sum(
            self._layer_params(i, True) for i in range(self.n_layers))
