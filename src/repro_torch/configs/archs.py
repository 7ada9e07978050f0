"""The 10 assigned architectures (exact configs from the assignment table).

Known deviations from the HF reference implementations (none affect the
memory/compute accounting the framework is about): stablelm's
partial-rotary fraction, command-r's parallel block, and conv/positional
frontends replaced by the mandated stubs.

A copy of ``repro.configs.archs``, as data; the port's tests hold every
config equal to the reference's.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig

ARCHS: dict[str, ModelConfig] = {}


def _register(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


# --- dense -----------------------------------------------------------------
STABLELM_3B = _register(ModelConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=6912, vocab_size=50304,
    block_pattern=("attn",), norm="layernorm", act="silu", glu=True,
    rope_theta=10_000.0,
))

QWEN2_7B = _register(ModelConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4,
    d_ff=18944, vocab_size=152064,
    block_pattern=("attn",), qkv_bias=True, norm="rmsnorm",
    rope_theta=1_000_000.0,
))

CODEQWEN15_7B = _register(ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=13440, vocab_size=92416,
    block_pattern=("attn",), qkv_bias=True, norm="rmsnorm",
    rope_theta=1_000_000.0,
))

COMMAND_R_35B = _register(ModelConfig(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22528, vocab_size=256000,
    block_pattern=("attn",), norm="layernorm", tie_embeddings=True,
    rope_theta=10_000.0,
))

# --- MoE ---------------------------------------------------------------
QWEN3_MOE_235B = _register(ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_head=128,
    d_ff=1536, vocab_size=151936,
    n_experts=128, experts_per_token=8,
    block_pattern=("attn",), use_qk_norm=True, norm="rmsnorm",
    rope_theta=1_000_000.0,
))

GROK1_314B = _register(ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=32768, vocab_size=131072,
    n_experts=8, experts_per_token=2,
    block_pattern=("attn",), act="gelu", norm="rmsnorm",
    logit_softcap=30.0,
))

# --- audio (encoder-only; conv frontend stubbed) -----------------------
HUBERT_XLARGE = _register(ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab_size=504,
    block_pattern=("attn",), is_decoder=False, frontend="audio",
    frontend_dim=512, act="gelu", glu=False, norm="layernorm",
))

# --- VLM (InternViT frontend stubbed; InternLM2-1.8B backbone) ---------
INTERNVL2_2B = _register(ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab_size=92553,
    block_pattern=("attn",), frontend="vision", frontend_dim=1024,
    norm="rmsnorm",
))

# --- hybrid: Griffin pattern (RG-LRU, RG-LRU, local-attn) --------------
RECURRENTGEMMA_9B = _register(ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab_size=256000,
    block_pattern=("rglru", "rglru", "local"),
    remainder_pattern=("rglru", "rglru"),
    local_window=2048, act="gelu", norm="rmsnorm",
))

# --- ssm: xLSTM[7:1] ----------------------------------------------------
XLSTM_1_3B = _register(ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    block_pattern=("slstm",) + ("mlstm",) * 7,
    norm="layernorm",
))
