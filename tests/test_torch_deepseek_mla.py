"""DeepSeek-V3 in the port (``MLAConfig``, ``models/mla.py``, the sigmoid
router and shared expert of ``models/moe.py``, K5's 192/128 pair) on the
CPU, at a tiny size with seeded weights: against the benchmark's plain
reference (``portbench/reference/deepseek_v3.py``), against a line-by-line
transcription of the published gate, and against the closed forms of
YaRN and of the softmax scale.  The JAX package has no latent attention,
so nothing here runs it; ``ARCHS`` stays the reference's ten."""
import dataclasses
import json
import math
import pathlib
import sys
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import weights as W  # noqa: E402
from portbench.archs import deepseek_v3 as A  # noqa: E402
from portbench.reference.deepseek_v3 import Reference  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.deepseek import DEEPSEEK_V3  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FA  # noqa: E402
from repro_torch.models import mla as MLA  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.runtime import tracing  # noqa: E402

CPU = torch.device("cpu")
#: The tiny configuration: the benchmark's file with every size cut but
#: the head sizes (q and k of 128 + 64, v of 128: K5's pair), 3 layers of
#: which 1 dense, 16 router outputs in 4 groups (2 kept), top-4.
TINY = dict(name="tiny-deepseek", hidden_size=64, intermediate_size=96,
            moe_intermediate_size=32, num_attention_heads=2,
            num_key_value_heads=2, q_lora_rank=32, kv_lora_rank=32,
            num_hidden_layers=3, first_k_dense_replace=1, n_routed_experts=4,
            num_experts_per_tok=4, n_group=4, topk_group=2, vocab_size=500)


def tiny_geometry(held=(0, 4), **over) -> A.Geometry:
    c = json.loads((ROOT / "portbench" / "configs"
                    / "deepseek-v3.ep32.json").read_text())
    c.update(TINY, n_routed_experts=held[1] - held[0])
    c["expert_share"] = dict(c["expert_share"], held=list(held),
                             router_outputs=16)
    c["assumed"] = dict(c["assumed"], padded_vocab=512)
    return dataclasses.replace(A.geometry(c), **over)


def program(g, seed: int, dtype: str):
    """The program's model on the benchmark's weights of ``seed``."""
    cfg = dataclasses.replace(A.model_config(g), dtype=dtype)
    weights = W.draw_weights(A, g, seed, CPU)
    if dtype == "float32":
        weights = {k: v.float() for k, v in weights.items()}
    return cfg, A.load_model(g, cfg, weights, CPU)


def rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a.float() - b)
                 / torch.linalg.vector_norm(b))


def reference_logits(ref: Reference, tokens) -> torch.Tensor:
    """The reference's full forward: logits at every position."""
    x = ref.embed(tokens)
    pos = torch.arange(tokens.shape[1])
    for i in range(ref.g.n_layers):
        x, _, _ = ref.layer(i, x, pos)
    return ref.logits(x)


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------

def test_registered_apart_from_the_reference_zoo():
    assert len(ARCHS) == 10 and DEEPSEEK_V3.name not in ARCHS
    assert DEEPSEEK_V3.block_kinds == ("mla",) * 61
    assert [DEEPSEEK_V3.is_dense_layer(i) for i in range(5)] == \
        [True, True, True, False, False]


def test_param_count_from_the_published_widths():
    """671.0 B parameters, 37.6 B active a token, from the published
    table: MLA 187.1 M a layer (+ its two norms), an expert 44.0 M, the
    dense MLP 396.4 M, the gate 1.8 M (+ its bias), the embedding and the
    head 1.853 G; the multi-token-prediction layer is not built."""
    d, L = 7168, 61
    mla = (d * 1536 + 1536 * 128 * 192 + d * 576 + 512 * 128 * 256
           + 128 * 128 * d)
    assert mla == 187_105_280
    expert, dense, gate = 3 * d * 2048, 3 * d * 18432, 256 * (d + 1)
    layer = mla + 1536 + 512 + 2 * d
    embed = 2 * 129280 * d + d
    want = (embed + L * layer + 3 * dense + (L - 3) * (257 * expert + gate))
    assert DEEPSEEK_V3.param_count() == want
    assert DEEPSEEK_V3.active_param_count() == \
        want - (L - 3) * 248 * expert
    assert DEEPSEEK_V3.model_flops(1, training=False) == \
        2.0 * DEEPSEEK_V3.active_param_count()


def test_yarn_frequencies_and_scale_closed_forms():
    """YaRN at factor 40 over 4,096 positions, rotations 32 and 1: the
    correction dimensions floor(10.47) = 10 and ceil(22.5) = 23; pairs
    below 10 keep base^(-2i/64), pairs from 23 on take it / 40, and
    between the ramp (i - 10) / 13 blends them.  The softmax scale is
    (0.1 ln 40 + 1)^2 / sqrt(192); the tables' factor 1."""
    def corr(r):
        return 64 * math.log(4096 / (2 * math.pi * r)) / (2 * math.log(1e4))
    lo, hi = math.floor(corr(32)), math.ceil(corr(1))
    assert (lo, hi) == (10, 23)
    want = []
    for i in range(32):
        base = 1e4 ** (-2 * i / 64)
        ramp = min(max((i - lo) / (hi - lo), 0.0), 1.0)
        want.append(base / 40 * ramp + base * (1 - ramp))
    got = MLA.yarn_inv_freq(DEEPSEEK_V3).double()
    torch.testing.assert_close(got, torch.tensor(want, dtype=torch.float64),
                               rtol=1e-6, atol=0)
    assert DEEPSEEK_V3.softmax_scale == pytest.approx(
        (0.1 * math.log(40) + 1) ** 2 / math.sqrt(192), rel=1e-12)
    assert round(DEEPSEEK_V3.softmax_scale, 6) == 0.135234
    assert DEEPSEEK_V3.rope_table_scale == 1.0


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------

def published_gate(logits, bias, n_group, topk_group, top_k, scale):
    """``MoEGate.forward`` of the published ``modeling_deepseek.py``,
    ``topk_method == "noaux_tc"``, line by line from the router's logits
    (its ``F.linear`` of the hidden states)."""
    n_routed_experts = logits.shape[-1]
    bsz_seq = logits.shape[0]
    scores = logits.sigmoid()
    scores_for_choice = scores.view(bsz_seq, -1) + bias.unsqueeze(0)
    group_scores = (
        scores_for_choice.view(bsz_seq, n_group, -1).topk(2, dim=-1)[0]
        .sum(dim=-1))
    group_idx = torch.topk(group_scores, k=topk_group, dim=-1,
                           sorted=False)[1]
    group_mask = torch.zeros_like(group_scores)
    group_mask.scatter_(1, group_idx, 1)
    score_mask = (group_mask.unsqueeze(-1)
                  .expand(bsz_seq, n_group, n_routed_experts // n_group)
                  .reshape(bsz_seq, -1))
    tmp_scores = scores_for_choice.masked_fill(~score_mask.bool(), 0.0)
    _, topk_idx = torch.topk(tmp_scores, k=top_k, dim=-1, sorted=False)
    topk_weight = scores.gather(1, topk_idx)
    denominator = topk_weight.sum(dim=-1, keepdim=True) + 1e-20
    topk_weight = topk_weight / denominator
    topk_weight = topk_weight * scale
    return topk_idx, topk_weight


ROUTER = dataclasses.replace(DEEPSEEK_V3, name="router", d_model=16,
                             n_experts=16, experts_per_token=4, n_group=4,
                             topk_group=2)


def program_gate(logits, bias):
    """The program's router (``moe._router``) on ``logits``: the router's
    weight the identity, so its input is the logits."""
    p = types.SimpleNamespace(router=MOE.Router(torch.eye(16), bias))
    _, weights, experts, _ = MOE._router(p, ROUTER, logits)
    return experts, weights


def choices(idx, w) -> list[dict]:
    return [dict(zip(i.tolist(), x.tolist())) for i, x in zip(idx, w)]


def assert_same_choice(logits, bias):
    want = choices(*published_gate(logits, bias, 4, 2, 4, 2.5))
    idx, w = program_gate(logits, bias)
    got = choices(idx, w)
    for g_, w_ in zip(got, want):
        assert g_.keys() == w_.keys()
        for e in g_:
            assert g_[e] == pytest.approx(w_[e], rel=1e-6)
    # best biased score first: the capacity's priority order
    biased = (logits.sigmoid() + bias).gather(1, idx)
    assert (biased[:, :-1] >= biased[:, 1:]).all()
    return [set(c) for c in got]


def test_router_matches_the_published_gate():
    gen = torch.Generator().manual_seed(3)
    logits = torch.randn(64, 16, generator=gen) * 2
    bias = torch.randn(16, generator=gen) * 0.3
    assert_same_choice(logits, bias)
    assert_same_choice(logits, torch.zeros(16))


def test_router_bias_flips_a_group():
    """Groups of four; unbiased, groups 0 and 1 lead (top-2 sums); a bias
    on group 3's two best lifts it over group 1: its experts are chosen,
    weighted by their unbiased scores."""
    logits = torch.tensor([[3.0, 2.9, -4, -4, 2.0, 1.9, -4, -4,
                            -4, -4, -4, -4, 1.8, 1.7, -4, -4]])
    bias = torch.zeros(16)
    (plain,) = assert_same_choice(logits, bias)
    assert plain == {0, 1, 4, 5}
    bias[12:14] = 0.2
    (biased,) = assert_same_choice(logits, bias)
    assert biased == {0, 1, 12, 13}


def test_router_bias_flips_an_expert():
    """Inside the kept groups a bias moves expert 6 past expert 5 for the
    fourth choice; the weights stay the unbiased scores, renormalized,
    times 2.5."""
    logits = torch.tensor([[3.0, 2.9, -4, -4, 2.0, 1.0, 0.9, -4,
                            -4, -4, -4, -4, -4, -4, -4, -4]])
    bias = torch.zeros(16)
    (plain,) = assert_same_choice(logits, bias)
    assert plain == {0, 1, 4, 5}
    bias[6] = 0.05
    (biased,) = assert_same_choice(logits, bias)
    assert biased == {0, 1, 4, 6}
    idx, w = program_gate(logits, bias)
    s = logits.sigmoid()[0, [0, 1, 4, 6]]
    torch.testing.assert_close(w.sum(), torch.tensor(2.5))
    torch.testing.assert_close(w[0].sort()[0], (2.5 * s / s.sum()).sort()[0])


def test_softmax_router_unchanged():
    """The zoo's MoE configs keep the softmax router (no bias, no shared
    expert)."""
    cfg = dataclasses.replace(ARCHS["qwen3-moe-235b-a22b"], n_layers=1,
                              d_model=16, n_experts=8, d_ff=8)
    p = MOE.MoE(cfg, torch.Generator().manual_seed(0))
    assert p.router.bias is None and p.shared is None
    x = torch.randn(5, 16)
    probs, weights, experts, _ = MOE._router(p, cfg, x)
    want = torch.softmax(x @ p.router.w, -1)
    torch.testing.assert_close(probs, want)
    top = want.sort(dim=-1, descending=True, stable=True)
    torch.testing.assert_close(experts, top[1][:, :8])
    torch.testing.assert_close(weights, top[0][:, :8]
                               / top[0][:, :8].sum(-1, keepdim=True))


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch,seq", [(2, 32), (1, 64)])
def test_prefill_f32_agrees(batch, seq):
    """In f32 the program and the reference compute one function (the
    gate, capacity, shared expert and dense layer included): they agree to
    f32 rounding."""
    g = tiny_geometry()
    cfg, model = program(g, 5, "float32")
    tokens = W.token_pool(5, "t", batch, seq, g.vocab, CPU)
    got = A.make_prefill_step(cfg)(model, {"tokens": tokens})[:, 0, :g.vocab]
    want, kept = Reference(g, W.draw_weights(A, g, 5, CPU)).prefill_last(
        tokens)
    assert rel(got, want) < 1e-5
    assert 0 < kept <= batch * seq * g.top_k * g.n_moe_layers


@pytest.mark.parametrize("seed", [7, 8, 2**31 + 9])
def test_bf16_inside_and_fp8_outside(seed):
    """The program in its served bf16 stays within 0.15 of the f32
    reference (relative L2 of the last logits: bf16 rounding through 3
    layers reads 0.010-0.026 over twelve seeds here), and the reference
    with its products' inputs in fp8 (the control, the precision below the
    configuration's) falls outside (0.20-0.57 at these widths)."""
    g = tiny_geometry()
    cfg, model = program(g, seed, "bfloat16")
    tokens = W.token_pool(seed, "t", 2, 32, g.vocab, CPU)
    got = A.make_prefill_step(cfg)(model, {"tokens": tokens})[:, 0, :g.vocab]
    weights = W.draw_weights(A, g, seed, CPU)
    want, _ = Reference(g, weights).prefill_last(tokens)
    fp8, _ = Reference(g, weights, fp8=True).prefill_last(tokens)
    assert rel(got, want) < 0.15 < rel(fp8, want)


def test_decode_through_the_latent_cache():
    """Decode steps from an empty cache, token by token, against the
    reference's full forward at every position (f32).  Each step routes
    its batch's tokens with the sort semantics and prefill its groups of
    positions with the einsum's, so a capacity large enough that no pair
    is dropped makes them one function; the cache holds the latent and the
    rotated key, 512 + 64 values of the published widths (here 32 + 64)."""
    g = tiny_geometry(capacity_factor=16.0)
    cfg, model = program(g, 11, "float32")
    B, S = 2, 12
    tokens = W.token_pool(11, "d", B, S, g.vocab, CPU).long()
    caches = A.init_caches(cfg, B, 16, CPU)
    assert [sorted(c) for c in caches] == [["k_pe", "latent"]] * 3
    assert caches[0]["latent"].shape == (B, 16, g.kv_lora_rank)
    assert caches[0]["k_pe"].shape == (B, 16, g.qk_rope_dim)
    step = A.make_decode_step(cfg)
    got = []
    for j in range(S):
        _, logits, caches = step(model, tokens[:, j:j + 1], caches,
                                 torch.tensor([j]))
        got.append(logits[:, :g.vocab])
    want = reference_logits(Reference(g, W.draw_weights(A, g, 11, CPU)),
                            tokens)
    for j in range(S):
        assert rel(got[j], want[:, j]) < 1e-5, j
    assert not caches[0]["latent"][:, S:].any()


def test_expert_shares_add_up_to_the_layer():
    """Four chips' shares of one MoE layer (4 of 16 experts each), the
    program's ``MoE(experts=(lo, hi))``: their outputs, with the shared
    expert (every share's) counted once, sum to the reference's layer with
    every expert held."""
    g = tiny_geometry(held=(0, 16))
    cfg = dataclasses.replace(A.model_config(g), dtype="float32")
    gen = torch.Generator().manual_seed(8)
    d, f, E = g.d_model, g.d_ff, g.router_outputs
    pre = "layers.1.mlp."
    whole = {pre + "gate.weight": torch.randn(d, E, generator=gen) * 0.5,
             pre + "gate.e_score_correction_bias":
             torch.randn(E, generator=gen) * 0.1}
    for part, lead in (("experts.", (E,)), ("shared_experts.", ())):
        for name, shape in (("gate_proj", (d, f)), ("up_proj", (d, f)),
                            ("down_proj", (f, d))):
            whole[pre + part + name] = torch.randn(
                *lead, *shape, generator=gen) / shape[0] ** 0.5
    h = torch.randn(2, 32, d, generator=gen)
    ref = Reference(g, whole)
    uncut, _ = ref.moe(h.reshape(64, d), "layers.1.", 32)
    uncut = uncut + ref.ffn(h.reshape(64, d), pre + "shared_experts.")
    names = A.LAYER_NAMES
    parts = torch.zeros(64, d)
    for lo in range(0, E, 4):
        p = MOE.MoE(cfg, device="meta", experts=(lo, lo + 4))
        sd = {names[k[len("layers.1."):]][len("moe."):]:
              v[lo:lo + 4] if ".experts." in k else v
              for k, v in whole.items()}
        p.load_state_dict(sd, strict=True, assign=True)
        out, _ = MOE.forward(p, cfg, h)
        parts += out.reshape(64, d)
    shared = ref.ffn(h.reshape(64, d), pre + "shared_experts.")
    torch.testing.assert_close(parts - 3 * shared, uncut, rtol=1e-5,
                               atol=1e-5)


def test_spans_of_the_mla_block():
    """Under a profiler a prefill call opens ``mla.project`` and
    ``mla.core`` inside every layer's ``attention``, ``mlp`` in the dense
    layer and ``moe.shared`` beside the routed stages in the MoE ones."""
    g = tiny_geometry()
    cfg, model = program(g, 12, "float32")
    tokens = W.token_pool(12, "t", 1, 32, g.vocab, CPU)
    rec = tracing.Recorder()
    old, tracing._RECORDER = tracing._RECORDER, rec
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            A.make_prefill_step(cfg)(model, {"tokens": tokens})
        spans = tracing.records()
        t = tracing.totals()
    finally:
        tracing._RECORDER = old
    for name in ("mla.project", "mla.core"):
        assert t[name].count == g.n_layers
        assert all(spans[s.parent].name == "attention"
                   for s in spans if s.name == name)
    assert t["mlp"].count == g.n_dense_layers
    for name in ("moe.route", "moe.dispatch", "moe.experts", "moe.combine",
                 "moe.shared"):
        assert t[name].count == g.n_moe_layers


# ---------------------------------------------------------------------------
# K5's 192/128 pair: the wrapper on the CPU, the kernel on the card
# ---------------------------------------------------------------------------

def _qkv(B, S, H, D, Dv, device=CPU, dtype=torch.float32, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k = (torch.randn((B, S, H, D), generator=gen, device=device)
            .to(dtype) for _ in range(2))
    # v a view of a wider buffer, as latent attention takes it from kv_b
    kv = torch.randn((B, S, H, 128 + Dv), generator=gen,
                     device=device).to(dtype)
    return q, k, kv[..., 128:]


def naive(q, k, v, scale, causal):
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * scale
    if causal:
        S = q.shape[1]
        s = s.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1),
                          float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v.double())


@pytest.mark.parametrize("causal", [True, False])
def test_the_192_128_pair_runs_its_plain_version(causal):
    q, k, v = _qkv(2, 40, 3, 192, 128)
    out = FA.mha(q, k, v, causal=causal, scale=0.135234)
    assert out.shape == (2, 40, 3, 128)
    torch.testing.assert_close(out.double(), naive(q, k, v, 0.135234, causal),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        out, FA.attention_ref(q, k, v, causal=causal, scale=0.135234))
    t = FA.flash_attention_traffic(q, k, v, causal=causal)
    pairs = 40 * 41 // 2 if causal else 40 * 40
    assert t["flops"] == 2 * 2 * 3 * pairs * (192 + 128)
    assert t["total_bytes"] == 4 * 2 * 40 * 3 * 2 * (192 + 128)


@pytest.mark.parametrize("dk,dv", [(128, 64), (192, 64), (64, 128),
                                   (256, 128), (192, 192)])
def test_other_head_size_pairs_raise(dk, dv):
    q, k = torch.zeros(1, 4, 8, dk), torch.zeros(1, 4, 8, dk)
    v = torch.zeros(1, 4, 8, dv)
    if dk == dv:
        # on the CPU the plain version takes any equal size; the card
        # has no 192-column instance of its own
        assert FA.flash_attention(q, k, v).shape == (1, 4, 8, dv)
        return
    with pytest.raises(ValueError, match="only the pairs"):
        FA.flash_attention(q, k, v)


def test_the_pair_keeps_the_checks():
    q, k, v = (t.transpose(1, 2) for t in _qkv(1, 8, 2, 192, 128))
    with pytest.raises(ValueError, match="must be"):
        FA.flash_attention(q, k, v[:, :1])
    with pytest.raises(ValueError, match="does not match"):
        FA.flash_attention(q[..., :128], k, v)


@pytest.mark.card
@pytest.mark.parametrize("B,S,H,causal", [(1, 300, 4, True),
                                          (2, 1000, 8, True),
                                          (1, 777, 4, False),
                                          (1, 4096, 16, True)])
def test_the_192_128_instance_on_the_card(B, S, H, causal):
    """The tensor-core instance against ``attention_ref`` on the same bf16
    inputs, ragged against the 128-row tiles, causal and not: within 2^-7
    of the largest output (bf16 P and output rounding, as the card
    tolerance of K5's other instances); the output (B, S, H, 128) dense.
    On the card the pair refuses a window, a cap and float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    q, k, v = _qkv(B, S, H, 192, 128, dev, torch.bfloat16, seed=B * S)
    launches = FA.flash_attention.launches
    got = FA.mha(q, k, v, causal=causal, scale=0.135234)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == launches + 1
    assert got.shape == (B, S, H, 128) and got.is_contiguous()
    want = FA.attention_ref(q, k, v, causal=causal, scale=0.135234).float()
    err = (got.float() - want).abs().max().item()
    assert err <= 2 ** -7 * want.abs().max().item()
    for kw in (dict(window=64), dict(softcap=30.0)):
        with pytest.raises(ValueError, match="no window and no cap"):
            FA.mha(q, k, v, **kw)
    with pytest.raises(ValueError, match="no window and no cap"):
        FA.mha(q.float(), k.float(), v.float())
