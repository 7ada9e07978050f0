"""Latent-attention models, registered apart from the reference's ten.

``ARCHS`` holds exactly the JAX package's zoo (the port's tests compare
them field by field); the reference has no latent attention, so these
configs live here, as published.  DeepSeek-V3
(https://huggingface.co/deepseek-ai/DeepSeek-V3/blob/main/config.json):
61 layers of hidden 7,168 and 128 heads; q through a rank of 1,536, k and
v through a latent of 512 and a shared rotated key of 64; q and k heads
of 128 + 64, v heads of 128; YaRN of factor 40 over 4,096 positions; the
first 3 layers dense (18,432), the others 256 experts of 2,048, top-8 by
sigmoid scores over 8 groups of which 4 are kept, scaled by 2.5, and one
shared expert.  Its multi-token-prediction layer is not on the main
model's path and is not built.
"""
from __future__ import annotations

from repro_torch.models.config import MLAConfig

DEEPSEEK_V3 = MLAConfig(
    name="deepseek-v3", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_head=192, d_ff=2048, vocab_size=129280,
    n_experts=256, experts_per_token=8,
    block_pattern=("mla",), norm="rmsnorm", act="silu", glu=True,
    rope_theta=10_000.0,
    q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128,
    rope_factor=40.0, rope_original_max=4096, rope_beta_fast=32.0,
    rope_beta_slow=1.0, rope_mscale=1.0, rope_mscale_all_dim=1.0,
    scoring_func="sigmoid", n_group=8, topk_group=4,
    routed_scaling_factor=2.5, norm_topk_prob=True, n_shared_experts=1,
    n_dense_layers=3, d_ff_dense=18432,
)
