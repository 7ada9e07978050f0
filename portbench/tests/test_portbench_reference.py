"""The reference against the program's CPU path at a tiny size.

In f32 on both sides the two compute the same function, routing, capacity
and cache writes included, so they agree to f32 rounding; the program in
its served bf16 stays inside the tiny cells' limits, and the reference in
fp8 (the control) does not.  The expert share adds up: the held experts'
parts over every share are the uncut layer.
"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from portbench import weights as W
from portbench.archs import qwen
from portbench.archs.qwen import Reference
from portbench.tests import tiny

CPU = torch.device("cpu")
GEOMETRY = {name: qwen.geometry(c) for name, c in tiny.configs().items()}


def rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a.float() - b)
                 / torch.linalg.vector_norm(b))


def program(g, seed: int, dtype: str):
    """The program's model on the benchmark's weights, in ``dtype``."""
    cfg = dataclasses.replace(qwen.model_config(g), dtype=dtype)
    weights = W.draw_weights(qwen, g, seed, CPU)
    if dtype == "float32":
        weights = {k: v.float() for k, v in weights.items()}
    return cfg, qwen.load_model(g, cfg, weights, CPU)


@pytest.mark.parametrize("name", [tiny.DENSE, tiny.MOE])
@pytest.mark.parametrize("batch,seq", [(2, 32), (1, 64)])
def test_prefill_f32_agrees(name, batch, seq):
    g = GEOMETRY[name]
    cfg, model = program(g, 5, "float32")
    tokens = W.token_pool(5, "t", batch, seq, g.vocab, CPU)
    got = qwen.make_prefill_step(cfg)(model, {"tokens": tokens})[:, 0,
                                                                 :g.vocab]
    ref = Reference(g, W.draw_weights(qwen, g, 5, CPU))
    want, kept = ref.prefill_last(tokens)
    assert rel(got, want) < 1e-5
    if g.is_moe:
        assert 0 < kept <= batch * seq * g.top_k * g.n_layers


def test_decode_f32_agrees():
    """Teacher-forced decode steps over a drawn prompt cache: each step's
    logits and the K/V rows it writes."""
    g = GEOMETRY[tiny.DENSE]
    cfg, model = program(g, 6, "float32")
    B, P, n, max_len = 3, 20, 6, 32
    caches = qwen.init_caches(cfg, B, max_len, CPU)
    for i, c in enumerate(caches):
        W.fill_cache(c["k"], 6, i, "k")
        W.fill_cache(c["v"], 6, i, "v")
    # the program's cache is f32 here; the prompt rows as the reference
    # draws them in bf16
    prompt = [(W.cache_tensor(c["k"].shape, torch.bfloat16, CPU, 6, i, "k"),
               W.cache_tensor(c["v"].shape, torch.bfloat16, CPU, 6, i, "v"))
              for i, c in enumerate(caches)]
    for c, (k, v) in zip(caches, prompt):
        c["k"].copy_(k)
        c["v"].copy_(v)
    inputs = W.token_pool(6, "in", B, n, g.vocab, CPU).long()
    step = qwen.make_decode_step(cfg)
    got = []
    for j in range(n):
        _, logits, _ = step(model, inputs[:, j:j + 1], caches,
                            torch.tensor([P + j]))
        got.append(logits[:, :g.vocab])
    want, kv = Reference(g, W.draw_weights(qwen, g, 6, CPU)).decode_chunk(
        inputs, P, lambda i: (0, (prompt[i][0][:, :P], prompt[i][1][:, :P])))
    assert rel(torch.stack(got, 1), want) < 1e-5
    for c, (k, v) in zip(caches, kv):
        assert rel(c["k"][:, P:P + n], k) < 1e-5
        assert rel(c["v"][:, P:P + n], v) < 1e-5


def test_bf16_inside_and_fp8_outside_the_limits():
    g = GEOMETRY[tiny.DENSE]
    cfg, model = program(g, 7, "bfloat16")
    tokens = W.token_pool(7, "t", 2, 32, g.vocab, CPU)
    got = qwen.make_prefill_step(cfg)(model, {"tokens": tokens})[:, 0,
                                                                 :g.vocab]
    weights = W.draw_weights(qwen, g, 7, CPU)
    want, _ = Reference(g, weights).prefill_last(tokens)
    fp8, _ = Reference(g, weights, fp8=True).prefill_last(tokens)
    limit = tiny.LIMITS["prefill"]["logits_rel_l2"]
    assert rel(got.float(), want) < limit < rel(fp8, want)


def test_expert_shares_add_up_to_the_layer():
    """Four chips' shares of one MoE layer (4 of 16 experts each) sum to
    the layer with every expert held."""
    g = dataclasses.replace(GEOMETRY[tiny.MOE], held=(0, 16))
    gen = torch.Generator().manual_seed(8)
    d, f, E = g.d_model, g.d_ff, g.router_outputs
    whole = {"layers.0.mlp.router": torch.randn(d, E, generator=gen) * 0.5}
    for name, shape in (("gate_proj", (E, d, f)), ("up_proj", (E, d, f)),
                        ("down_proj", (E, f, d))):
        whole[f"layers.0.mlp.experts.{name}"] = torch.randn(
            shape, generator=gen) / shape[1] ** 0.5
    h = torch.randn(64, d, generator=gen)
    uncut, kept = Reference(g, whole).moe(h, "layers.0.", 32)
    parts, kept_parts = torch.zeros_like(uncut), 0
    for lo in range(0, E, 4):
        share = {k: v[lo:lo + 4] if "experts" in k else v
                 for k, v in whole.items()}
        out, n = Reference(dataclasses.replace(g, held=(lo, lo + 4)),
                           share).moe(h, "layers.0.", 32)
        parts += out
        kept_parts += n
    assert kept_parts == kept
    torch.testing.assert_close(parts, uncut, rtol=1e-5, atol=1e-6)


def test_capacity_drops_the_late_pairs():
    """Where every token picks the same experts, each keeps its first C
    pairs in priority order (every first choice, then every second)."""
    g = dataclasses.replace(GEOMETRY[tiny.MOE], held=(0, 16))
    d, E = g.d_model, g.router_outputs
    router = torch.zeros(d, E)
    router[:, :g.top_k] = torch.linspace(4, 1, g.top_k)
    h = torch.ones(64, d)
    ref = Reference(g, {"layers.0.mlp.router": router})
    w, e, kept = ref.route(h, "layers.0.", 32)
    sg, cap = g.groups(64, 32)
    assert (sg, cap) == (32, 16)
    # each group: the first 16 tokens keep all four choices, the rest none
    by_token = kept.reshape(2, 32, g.top_k)
    assert by_token[:, :16].all() and not by_token[:, 16:].any()
    assert (e[:, :g.top_k] == torch.arange(g.top_k)).all()
