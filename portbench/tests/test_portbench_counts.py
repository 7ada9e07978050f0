"""The ``qwen`` family's counts against operations and bytes worked out by
hand, and ``counts.bound_s``."""
from __future__ import annotations

import pytest

from portbench import counts
from portbench.archs import qwen as C
from portbench.harness import HERE, Layout

LAYOUT = Layout(HERE.parent)
QWEN2 = C.geometry(LAYOUT.config("qwen2-7b"))
MOE = C.geometry(LAYOUT.config("qwen3-moe-235b-a22b.ep16"))


def close(a, b, rel=1e-9):
    return a == pytest.approx(b, rel=rel)


def test_qwen2_layer_and_weights():
    d, q, kv, f = 3584, 28 * 128, 4 * 128, 18944
    per_layer = d * (q + 2 * kv) + q * d + 3 * d * f
    assert C.layer_product_params(QWEN2) == per_layer == 233_046_016
    # products and q/k/v biases in bf16, two f32 norms, 28 layers; the head
    # and the final norm; the embedding table is not read whole
    want = 28 * (2 * (per_layer + q + 2 * kv) + 4 * 2 * d) \
        + 2 * d * 152_064 + 4 * d
    assert C.weight_bytes(QWEN2) == want
    assert close(want / 1e9, 14.141646848)


@pytest.mark.parametrize("batch,seq,attn", [
    (4, 2048, 3.369e12), (2, 4096, 6.736e12), (1, 8192, 1.3471e13)])
def test_qwen2_prefill(batch, seq, attn):
    call = C.prefill_call(QWEN2, batch, seq)
    products = 2 * 8192 * 233_046_016 * 28
    assert close(products, 1.0691e14, rel=1e-4)
    k5 = C.flash_attention(QWEN2, batch, seq)
    assert k5["flops"] == 4 * batch * 28 * 128 * seq * (seq + 1) // 2
    assert close(k5["flops"] * 28, attn, rel=1e-3)
    # q, k, v read and the output written once, bf16
    assert k5["bytes"] == 2 * 8192 * (2 * 3584 + 2 * 512)
    head = 2 * batch * 3584 * 152_064
    assert close(call["flops"], products + k5["flops"] * 28 + head)
    assert call["f32_flops"] == 0
    assert close(call["bound_s"], call["flops"] / 989e12)


def test_qwen2_prefill_bound_at_2x4096():
    assert close(C.prefill_call(QWEN2, 2, 4096)["bound_s"] * 1e3, 114.91,
                 rel=1e-4)


def test_qwen2_decode_step_at_32k():
    """B 24 at a mean 32,256 positions: 14.14 GB of weights and 44.39 GB
    of cache, bytes bind: 17.5 ms; 6.5e11 operations."""
    B, index = 24, 32_255
    step = C.decode_step(QWEN2, B, index)
    cache = 2 * 2 * B * (index + 2) * 512 * 28
    assert close(cache / 1e9, 44.39, rel=1e-3)
    assert step["bytes"] == C.weight_bytes(QWEN2) + cache \
        + 2 * B * 3584 + 2 * B * 152_064
    assert close(step["bytes"] / 1e9, 58.54, rel=1e-3)
    assert close(step["bound_s"] * 1e3, 17.48, rel=1e-3)
    assert close(step["flops"], 6.501e11, rel=1e-3)
    k4 = C.decode_attention(QWEN2, B, index + 1)
    assert k4["bytes"] == 2 * (2 * B * 32_256 * 512 + 2 * B * 3584)
    assert close(k4["bytes"] / 1e9, 1.5858, rel=1e-4)
    assert close(k4["bound_s"] * 1e3, 0.4734, rel=1e-3)


def test_moe_share():
    d, q, kv, f = 4096, 64 * 128, 4 * 128, 1536
    per_layer = d * (q + 2 * kv) + q * d
    assert C.layer_product_params(MOE) == per_layer == 71_303_168
    experts = 8 * 3 * d * f
    want = 47 * (2 * (per_layer + experts) + 4 * d * 128 + 4 * 2 * d
                 + 4 * 2 * 128) + 2 * d * 152_064 + 4 * d
    assert C.weight_bytes(MOE) == want
    # with the embedding table: the share's 23.49 GB
    assert close((want + 2 * d * 152_064) / 1e9, 23.49, rel=1e-3)


def test_moe_prefill():
    kept = 4096 * 47                   # pairs the held experts keep
    call = C.prefill_call(MOE, 2, 4096, kept)
    products = 2 * 8192 * 71_303_168 * 47
    attn = 4 * 2 * 64 * 128 * 4096 * 4097 // 2 * 47
    expert = 6 * 4096 * 1536 * kept
    head = 2 * 2 * 4096 * 152_064
    assert close(call["flops"], products + attn + expert + head)
    assert close(call["f32_flops"], 2 * 8192 * 4096 * 128 * 47)
    assert close(call["bound_s"],
                 call["flops"] / 989e12 + call["f32_flops"] / 67e12)
    assert close(call["bound_s"] * 1e3, 95.03, rel=1e-3)


def test_bound_takes_the_larger():
    assert counts.bound_s(989e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert counts.bound_s(989e12, 6.7e12) == pytest.approx(2.0)
    assert counts.bound_s(0, 0, 67e12) == pytest.approx(1.0)
