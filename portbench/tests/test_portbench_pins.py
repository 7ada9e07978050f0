"""The ``qwen`` family gives what the harness gave before families were
pluggable: the seeded draws bit for bit, the counts exactly, the
reference's logits to 1e-6.

The constants were recorded on the CPU from the harness as it stood
before ``archs/`` (``spec.geometry``, ``weights.layer_leaves``,
``counts.py`` and ``reference/model.py``), at the tiny configurations of
``tiny.py`` and, for the counts, also at the real cells' configurations
and shapes.  A kernel's bound is what the parent's ``counts()`` took for
one call or step: its one-layer bound times the layers.
"""
from __future__ import annotations

import hashlib

import pytest
import torch

from portbench import weights as W
from portbench.archs import qwen
from portbench.harness import HERE, Layout
from portbench.tests import tiny

CPU = torch.device("cpu")
GEOMETRY = {name: qwen.geometry(c) for name, c in tiny.configs().items()}
LAYOUT = Layout(HERE.parent)
GEOMETRY.update({name: qwen.geometry(LAYOUT.config(name))
                 for name in ("qwen2-7b", "qwen3-moe-235b-a22b.ep16")})
#: Each case's prefill shapes, decode batch and positions, and kept pairs.
CASES = {
    "tiny-dense": ([(4, 16), (2, 32), (1, 64)], 4, [40, 44, 47], 0),
    "tiny-moe": ([(2, 32)], 0, [], 777),
    "qwen2-7b": ([(4, 2048), (2, 4096), (1, 8192)], 24,
                 [31744, 32255, 32767], 0),
    "qwen3-moe-235b-a22b.ep16": ([(2, 4096)], 0, [], 4096 * 47),
}
#: The reference's judged rows: the seed, and the tokens of the decode.
SEED = 7

#: sha256 (first 16 hex digits) of every leaf drawn for a tiny
#: configuration and seed: weights, a prompt pool of 8 x 64, first
#: tokens of 4 x 4, and each layer's cache tensors at batch 4, 64 rows.
DRAWS = {
    ("tiny-dense", 5): {
        "embed_tokens": "a12146e88b57ac44",
        "layers.0.input_layernorm": "aec175a35fc97ef2",
        "layers.0.k_proj.b": "6b83f1700dc1e74e",
        "layers.0.k_proj.w": "f45761120d4adec5",
        "layers.0.mlp.down_proj": "32b3e52e44536ec1",
        "layers.0.mlp.gate_proj": "b57ba143dbd24156",
        "layers.0.mlp.up_proj": "7b507cca0f44ce20",
        "layers.0.o_proj.w": "50715cc5c42b0c52",
        "layers.0.post_attention_layernorm": "564850149c49b0b7",
        "layers.0.q_proj.b": "c4666d79c3e61aa6",
        "layers.0.q_proj.w": "9c434cd6efecc405",
        "layers.0.v_proj.b": "c9445a8a058bfe96",
        "layers.0.v_proj.w": "be6d54ab85d44169",
        "layers.1.input_layernorm": "b026a446d2d74f2a",
        "layers.1.k_proj.b": "724acff1e5135e94",
        "layers.1.k_proj.w": "83af0789a3e6fce1",
        "layers.1.mlp.down_proj": "fb537e615815d3b4",
        "layers.1.mlp.gate_proj": "c2eb5f6396ad3f33",
        "layers.1.mlp.up_proj": "bdaf7378e5604751",
        "layers.1.o_proj.w": "1d1d63808401ace1",
        "layers.1.post_attention_layernorm": "5a512588f3c2b367",
        "layers.1.q_proj.b": "397bf16f711f3d14",
        "layers.1.q_proj.w": "a977bc1609267a51",
        "layers.1.v_proj.b": "b45fdccf03f7c981",
        "layers.1.v_proj.w": "86c6208e1e05c630",
        "lm_head": "5055edfab46f0b02",
        "norm": "91af0a38085f41df",
        "prompts": "ab12d1552d333fba",
        "first": "f54b4ed95c1d4c53",
        "cache.0.k": "5de51f08af11dfb2",
        "cache.0.v": "194d70112cad12e1",
        "cache.1.k": "d1a959289d9d7fa5",
        "cache.1.v": "4763cd70e64ca44b",
    },
    ("tiny-dense", 2**31 + 7): {
        "embed_tokens": "c83d42a9e9331b8d",
        "layers.0.input_layernorm": "aa8b1b0ae87f1ed7",
        "layers.0.k_proj.b": "180d8363fb2035e2",
        "layers.0.k_proj.w": "5c6fad9548f110cd",
        "layers.0.mlp.down_proj": "1a4c8ae7caa6c16c",
        "layers.0.mlp.gate_proj": "baf39022973059aa",
        "layers.0.mlp.up_proj": "29215e8a446948c6",
        "layers.0.o_proj.w": "a7dc357d1e90ee9a",
        "layers.0.post_attention_layernorm": "9a76de36f6dc2ce9",
        "layers.0.q_proj.b": "105a142a92db5481",
        "layers.0.q_proj.w": "161bc1d8b002f779",
        "layers.0.v_proj.b": "1032f7158a76af2c",
        "layers.0.v_proj.w": "76e681866b431100",
        "layers.1.input_layernorm": "8c0f6d1d7fab18f1",
        "layers.1.k_proj.b": "58f5839dfc2304e6",
        "layers.1.k_proj.w": "86f72d66720626d6",
        "layers.1.mlp.down_proj": "73624f20ea3dccfb",
        "layers.1.mlp.gate_proj": "80d11495cb82b725",
        "layers.1.mlp.up_proj": "f5f95f1a3a7fd977",
        "layers.1.o_proj.w": "99f873512bbbd89f",
        "layers.1.post_attention_layernorm": "220010f001a7157a",
        "layers.1.q_proj.b": "b35c6bc0b49c162b",
        "layers.1.q_proj.w": "c6f27a94401de254",
        "layers.1.v_proj.b": "793f3b688a56c7de",
        "layers.1.v_proj.w": "2fab7d7649b5019b",
        "lm_head": "e5f155340e92c6d5",
        "norm": "f5978d3df9b100f4",
        "prompts": "f23d30cd911a11c4",
        "first": "47c6d20e097b4d21",
        "cache.0.k": "368f8a90f9455dc8",
        "cache.0.v": "c41c204701e2b05c",
        "cache.1.k": "4747f7ad6d4fb3c7",
        "cache.1.v": "e4d5619a51dc0ea6",
    },
    ("tiny-moe", 5): {
        "embed_tokens": "a12146e88b57ac44",
        "layers.0.input_layernorm": "aec175a35fc97ef2",
        "layers.0.k_norm": "e230185b02a99214",
        "layers.0.k_proj.w": "d7714d98f8c959e2",
        "layers.0.mlp.experts.down_proj": "844de9370ceb7db3",
        "layers.0.mlp.experts.gate_proj": "12018a728caa4944",
        "layers.0.mlp.experts.up_proj": "79457a75df89d69e",
        "layers.0.mlp.router": "8152e849730a1c89",
        "layers.0.o_proj.w": "3351b747f0fa8f95",
        "layers.0.post_attention_layernorm": "80bceab9a1e8943b",
        "layers.0.q_norm": "e13decdcb66d7190",
        "layers.0.q_proj.w": "9c434cd6efecc405",
        "layers.0.v_proj.w": "b4cde6c6c27b541b",
        "layers.1.input_layernorm": "b026a446d2d74f2a",
        "layers.1.k_norm": "610408b435a16943",
        "layers.1.k_proj.w": "701ab6ab663e1678",
        "layers.1.mlp.experts.down_proj": "2c87f5b4fc04a26e",
        "layers.1.mlp.experts.gate_proj": "a5e4f8587bbc3d72",
        "layers.1.mlp.experts.up_proj": "3a275307d9197d18",
        "layers.1.mlp.router": "c97db05307304e61",
        "layers.1.o_proj.w": "acc291e9185c16bc",
        "layers.1.post_attention_layernorm": "36331a0b3477865a",
        "layers.1.q_norm": "686fb24764a02c2d",
        "layers.1.q_proj.w": "a977bc1609267a51",
        "layers.1.v_proj.w": "fa104e375e671303",
        "lm_head": "5055edfab46f0b02",
        "norm": "91af0a38085f41df",
        "prompts": "d530ba0d0c1a4446",
        "first": "9c34bad10cd72556",
        "cache.0.k": "5de51f08af11dfb2",
        "cache.0.v": "194d70112cad12e1",
        "cache.1.k": "d1a959289d9d7fa5",
        "cache.1.v": "4763cd70e64ca44b",
    },
    ("tiny-moe", 2**31 + 7): {
        "embed_tokens": "c83d42a9e9331b8d",
        "layers.0.input_layernorm": "aa8b1b0ae87f1ed7",
        "layers.0.k_norm": "23cca3c028633918",
        "layers.0.k_proj.w": "4cba40272102652d",
        "layers.0.mlp.experts.down_proj": "e70c4651cc27dc9b",
        "layers.0.mlp.experts.gate_proj": "4644e8d617feac1a",
        "layers.0.mlp.experts.up_proj": "4c93a61a74cb0095",
        "layers.0.mlp.router": "32dceae4ff40e001",
        "layers.0.o_proj.w": "7827bf4378510e52",
        "layers.0.post_attention_layernorm": "3aacbda462342a02",
        "layers.0.q_norm": "c472252911b773fb",
        "layers.0.q_proj.w": "161bc1d8b002f779",
        "layers.0.v_proj.w": "091a24691f0844ff",
        "layers.1.input_layernorm": "8c0f6d1d7fab18f1",
        "layers.1.k_norm": "0c85581284627ff8",
        "layers.1.k_proj.w": "ed3c7fac3320a39d",
        "layers.1.mlp.experts.down_proj": "6f19e95849c19986",
        "layers.1.mlp.experts.gate_proj": "6ab39d00cbf3bff7",
        "layers.1.mlp.experts.up_proj": "79977da8496309a5",
        "layers.1.mlp.router": "95035edf3e5be5f8",
        "layers.1.o_proj.w": "efc75136cecbdc58",
        "layers.1.post_attention_layernorm": "b3eb1291d57701e1",
        "layers.1.q_norm": "847e8e76f6b89dce",
        "layers.1.q_proj.w": "c6f27a94401de254",
        "layers.1.v_proj.w": "2c44e839bcc55fb9",
        "lm_head": "e5f155340e92c6d5",
        "norm": "f5978d3df9b100f4",
        "prompts": "21447289d469bbdf",
        "first": "447d72c515b2aa7e",
        "cache.0.k": "368f8a90f9455dc8",
        "cache.0.v": "c41c204701e2b05c",
        "cache.1.k": "4747f7ad6d4fb3c7",
        "cache.1.v": "e4d5619a51dc0ea6",
    },
}

#: The counts of each case, exactly as the parent computed them.
COUNTS = {
    "tiny-dense": {
        "prefill 4x16": {
            "flops": 9977856.0,
            "f32_flops": 0.0,
            "bytes": 227072.0,
            "bound_s": 6.778268656716417e-08,
        },
        "k5 4x16": 1.4672238805970149e-08,
        "prefill 2x32": {
            "flops": 10108928.0,
            "f32_flops": 0.0,
            "bytes": 225024.0,
            "bound_s": 6.717134328358209e-08,
        },
        "k5 2x32": 1.4672238805970149e-08,
        "prefill 1x64": {
            "flops": 10567680.0,
            "f32_flops": 0.0,
            "bytes": 224000.0,
            "bound_s": 6.686567164179105e-08,
        },
        "k5 1x64": 1.4672238805970149e-08,
        "decode 4@40": {
            "flops": 935936.0,
            "bytes": 262400.0,
            "bound_s": 7.832835820895522e-08,
        },
        "k4 4@40": 1.3143880597014925e-08,
        "decode 4@44": {
            "flops": 944128.0,
            "bytes": 266496.0,
            "bound_s": 7.95510447761194e-08,
        },
        "k4 4@44": 1.4366567164179104e-08,
        "decode 4@47": {
            "flops": 950272.0,
            "bytes": 269568.0,
            "bound_s": 8.046805970149254e-08,
        },
        "k4 4@47": 1.528358208955224e-08,
    },
    "tiny-moe": {
        "prefill 2x32": {
            "flops": 13365248.0,
            "f32_flops": 262144.0,
            "bytes": 232960.0,
            "bound_s": 6.954029850746269e-08,
        },
        "k5 2x32": 1.4672238805970149e-08,
    },
    "qwen2-7b": {
        "prefill 4x2048": {
            "flops": 110283584438272.0,
            "f32_flops": 0.0,
            "bytes": 14201583616.0,
            "bound_s": 0.1115101966008817,
        },
        "k5 4x2048": 0.003406368581629929,
        "prefill 2x4096": {
            "flops": 113648658808832.0,
            "f32_flops": 0.0,
            "bytes": 14200975360.0,
            "bound_s": 0.11491269849224671,
        },
        "k5 2x4096": 0.0068110747090960565,
        "prefill 1x8192": {
            "flops": 120382077534208.0,
            "f32_flops": 0.0,
            "bytes": 14200671232.0,
            "bound_s": 0.12172100862912841,
        },
        "k5 1x8192": 0.013620486964028311,
        "decode 24@31744": {
            "flops": 645198446592.0,
            "bytes": 57839740928.0,
            "bound_s": 0.01726559430686567,
        },
        "k4 24@31744": 0.013044441943880597,
        "decode 24@32255": {
            "flops": 650121314304.0,
            "bytes": 58543007744.0,
            "bound_s": 0.017475524699701494,
        },
        "k4 24@32255": 0.013254372336716417,
        "decode 24@32767": {
            "flops": 655053815808.0,
            "bytes": 59247650816.0,
            "bound_s": 0.01768586591522388,
        },
        "k4 24@32767": 0.013464713552238806,
    },
    "qwen3-moe-235b-a22b.ep16": {
        "prefill 2x4096": {
            "flops": 88021269479424.0,
            "f32_flops": 403726925824.0,
            "bytes": 22309618688.0,
            "bound_s": 0.09502604748896584,
        },
        "k5 2x4096": 0.02613228663898079,
    },
}

#: Each logits row's (L2 norm, max, argmax, logit 17, logit 300), to
#: nine digits, and an MoE call's kept pairs or a decode's written K/V
#: rows' L2 norms, a layer.
REFERENCE = {
    "tiny-dense prefill 4x16 fp8=False": {
        "rows": [
            (24.0512104, 2.73071289, 316, 0.698570788, -0.498036236),
            (21.3813496, 2.87043667, 225, -0.250921637, -1.06384575),
            (22.5407391, 3.24233651, 256, 1.13321149, -1.2571789),
            (21.4514599, 2.56779003, 492, -0.794699728, -2.58512473),
        ],
        "kept": 0,
    },
    "tiny-dense prefill 2x32 fp8=False": {
        "rows": [
            (22.9265842, 2.86198449, 375, 0.712483048, -1.22418976),
            (22.0368538, 2.92355013, 275, 0.561942399, -2.12456727),
        ],
        "kept": 0,
    },
    "tiny-dense prefill 2x32 fp8=True": {
        "rows": [
            (23.0062828, 3.04615664, 375, 0.728001714, -1.3226831),
            (21.7789497, 2.97660327, 275, 0.452046007, -1.6695714),
        ],
        "kept": 0,
    },
    "tiny-dense prefill 1x64 fp8=False": {
        "rows": [
            (23.9304008, 3.86459589, 186, 1.13652968, -1.0254308),
        ],
        "kept": 0,
    },
    "tiny-moe prefill 2x32 fp8=False": {
        "rows": [
            (22.6726036, 2.90999985, 250, -0.249071792, -1.18029368),
            (22.6169205, 2.62556672, 99, 0.69351083, -1.06558406),
        ],
        "kept": 130,
    },
    "tiny-moe prefill 2x32 fp8=True": {
        "rows": [
            (22.5615273, 2.78853583, 250, -0.360536247, -1.63139272),
            (22.3962212, 2.52152991, 75, 0.0465160795, -0.934351861),
        ],
        "kept": 134,
    },
    "tiny-dense decode fp8=False": {
        "rows": [
            (23.0394459, 3.32115293, 399, 0.14867042, 0.12624532),
            (23.0084019, 3.15130687, 406, -0.365187377, 0.351780772),
            (20.597086, 2.93130589, 23, -0.180059463, -0.566273272),
            (23.0832157, 2.88607907, 118, -0.768084288, 1.76924956),
            (21.7827301, 2.80703735, 16, -0.00836595707, 0.280437917),
            (22.545023, 2.93026757, 15, -1.06186283, -1.41473567),
            (22.3772278, 2.60287786, 428, 0.59917587, -0.655246317),
            (23.2440186, 2.70969009, 261, 0.518810451, -0.100486808),
            (24.0749073, 2.77029657, 291, 0.219583184, -1.31447971),
            (22.9795818, 3.33584666, 48, -0.137603074, -1.37923622),
            (22.8331165, 2.66418672, 194, 0.651593745, -1.94608843),
            (23.6085243, 3.77570987, 162, -0.348835379, 1.0725944),
            (23.260931, 2.91612887, 476, 0.404680133, -0.0713146776),
            (23.5206566, 2.97385263, 382, -0.00966509432, -0.633568347),
            (23.3133621, 3.44729495, 162, 0.56809032, 1.42302549),
            (23.141571, 3.21360087, 408, 0.07648132, -1.01495337),
        ],
        "kv": [(23.164196, 23.2357903), (23.5437107, 23.6647797)],
    },
}


def digest(t: torch.Tensor) -> str:
    raw = t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16
                              else torch.uint8)
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()[:16]


@pytest.mark.parametrize("name,seed", list(DRAWS))
def test_draws(name, seed):
    g = GEOMETRY[name]
    got = {k: digest(v)
           for k, v in W.draw_weights(qwen, g, seed, CPU).items()}
    got["prompts"] = digest(W.token_pool(seed, "prompts", 8, 64, g.vocab,
                                         CPU))
    got["first"] = digest(W.token_pool(seed, "first", 4, 4, g.vocab, CPU))
    for i in range(g.n_layers):
        for leaf, shape, tag in qwen.cache_leaves(g, i, 4, 64):
            got[f"cache.{i}.{leaf}"] = digest(W.cache_tensor(
                shape, torch.bfloat16, CPU, seed, i, tag))
    assert got == DRAWS[name, seed]


@pytest.mark.parametrize("name", list(COUNTS))
def test_counts(name):
    g = GEOMETRY[name]
    shapes, batch, positions, kept = CASES[name]
    got = {}
    for b, s in shapes:
        got[f"prefill {b}x{s}"] = qwen.prefill_call(g, b, s, kept)
        got[f"k5 {b}x{s}"] = qwen.kernel_bounds(g, "prefill", b, s)[
            "flash_attention"]
    for i in positions:
        got[f"decode {batch}@{i}"] = qwen.decode_step(g, batch, i)
        got[f"k4 {batch}@{i}"] = qwen.kernel_bounds(g, "decode", batch, i)[
            "decode_attention"]
    assert got == COUNTS[name]


def summary(logits: torch.Tensor) -> list[tuple]:
    return [(float(r.norm()), float(r.max()), int(r.argmax()),
             float(r[17]), float(r[300])) for r in logits.float()]


def close(got, want) -> None:
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(b, int):
            assert a == b
        else:
            assert a == pytest.approx(b, rel=1e-6, abs=1e-7)


def reference_case(key: str):
    """What the reference gives for the case ``key``."""
    name, what, *rest = key.split()
    g = GEOMETRY[name]
    fp8 = key.endswith("fp8=True")
    ref = qwen.Reference(g, W.draw_weights(qwen, g, SEED, CPU), fp8=fp8)
    if what == "prefill":
        b, s = map(int, rest[0].split("x"))
        tokens = W.token_pool(SEED, "prompts", 1, 64, g.vocab, CPU).view(b, s)
        logits, kept = ref.prefill_last(tokens)
        return {"rows": summary(logits), "kept": kept}
    B, P, n, rows = 4, 40, 8, torch.tensor([1, 3])
    inputs = W.token_pool(SEED, "in", 2, n, g.vocab, CPU).long()

    def prefix_of(i):
        return 0, tuple(W.cache_tensor((B, 64, g.n_kv_heads, g.head_dim),
                                       torch.bfloat16, CPU, SEED, i,
                                       tag)[rows, :P] for tag in ("k", "v"))
    logits, kv = ref.decode_chunk(inputs, P, prefix_of)
    return {"rows": summary(logits.reshape(-1, logits.shape[-1])),
            "kv": [(float(k.norm()), float(v.norm())) for k, v in kv]}


@pytest.mark.parametrize("key", list(REFERENCE))
def test_reference(key):
    got, want = reference_case(key), REFERENCE[key]
    assert set(got) == set(want)
    if "kept" in want:
        assert got["kept"] == want["kept"]
    for field in ("rows", "kv"):
        for a, b in zip(got.get(field, []), want.get(field, []),
                        strict=True):
            close(a, b)
