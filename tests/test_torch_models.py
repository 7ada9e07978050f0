"""The port's dense decoder (``repro_torch.models``) against the reference
(``repro.models``) on the CPU, at ``reduced_config`` with two layers, for
stablelm-3b (layernorm, MHA), qwen2-7b (GQA, qkv bias), codeqwen1.5-7b and
command-r-35b (tied embeddings).

The reference's ``init_params(PRNGKey(0))`` goes through
``convert.from_reference`` after every bias and norm parameter is redrawn
from a numpy seed (the reference initialises them to constants, which
would hide a misplaced one), and both packages take the same tokens.
Logits are compared over the real vocabulary only (``[..., :vocab_size]``):
the padding columns are -1e30 in both, and a tolerance relative to them
would pass anything.  Tolerances, relative to max |logit|: f32 2e-5 (one
computation in two orders of summation), bf16 2e-2 (both round every
activation to bf16, 2^-8 relative, at the same places; a few roundings
may fall on the other side of a tie); decode against the port's own
forward 1e-4, the reference's bound for the same check.  The kernel path
runs the port's plain kernel versions (CPU tensors) against the
reference's Pallas kernels in interpret mode.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced_config as ref_reduced
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.configs.shapes import cell_status as ref_cell_status
from repro.models import layers as REF_L
from repro.models import transformer as REF_TF
from repro_torch.configs import ARCHS, list_archs, reduced_config
from repro_torch.configs.shapes import SHAPES, cell_status
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.models.convert import from_reference, load, to_serving

DENSE = ["stablelm-3b", "qwen2-7b", "codeqwen1.5-7b", "command-r-35b"]
B, S = 2, 16
F32_TOL, BF16_TOL, DECODE_TOL = 2e-5, 2e-2, 1e-4


def _perturb(params, seed=1):
    """Every bias and norm parameter redrawn from a numpy seed, and the
    recurrent blocks' zero-initialized gates (the RG-LRU's ``gate_r`` and
    ``gate_i``, the sLSTM's ``r``): with zero gates r = i = 1/2 whatever
    the input, and a port that ignored the input there would pass."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x)
        name = getattr(path[-1], "key", None)
        if name in ("b", "bias"):
            return (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        if name in ("gate_r", "gate_i", "r"):
            return (0.5 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(leaf, params)


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The reference config (f32) and its perturbed parameters (numpy)."""
    cfg = dataclasses.replace(ref_reduced(REF_ARCHS[arch], layers_scale=2),
                              dtype="float32")
    return cfg, _perturb(REF_TF.init_params(jax.random.PRNGKey(0), cfg))


def _tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S),
                                                dtype=np.int32)


def _configs(arch, dtype, kernels):
    rcfg, params = _weights(arch)
    rcfg = dataclasses.replace(rcfg, dtype=dtype, use_pallas=kernels)
    cfg = dataclasses.replace(reduced_config(ARCHS[arch], layers_scale=2),
                              dtype=dtype, use_kernels=kernels)
    return rcfg, params, cfg


def _port_model(arch, dtype):
    rcfg, params = _weights(arch)
    cfg = dataclasses.replace(reduced_config(ARCHS[arch], layers_scale=2),
                              dtype=dtype)
    model = load(cfg, from_reference(params, rcfg), device="cpu")
    return to_serving(model) if dtype == "bfloat16" else model


@functools.lru_cache(maxsize=None)
def _ref_forward(arch, dtype, kernels):
    rcfg, params, _ = _configs(arch, dtype, kernels)
    jp = jax.tree.map(jnp.asarray, params)
    x = REF_TF.embed_inputs(jp, rcfg, tokens=jnp.asarray(_tokens(rcfg)))
    h, _ = REF_TF.forward_hidden(jp, rcfg, x)
    return np.asarray(REF_TF.logits_fn(jp, rcfg, h).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _ref_decode(arch, dtype, kernels):
    rcfg, params, _ = _configs(arch, dtype, kernels)
    jp = jax.tree.map(jnp.asarray, params)
    toks = jnp.asarray(_tokens(rcfg))
    caches = REF_TF.init_caches(rcfg, B, S)
    step = jax.jit(REF_TF.decode_step, static_argnums=1)
    outs = []
    for i in range(S):
        lg, caches = step(jp, rcfg, toks[:, i:i + 1], caches,
                          jnp.asarray(i, jnp.int32))
        outs.append(np.asarray(lg.astype(jnp.float32)))
    return np.stack(outs, 1)


def _port_forward(arch, dtype, kernels):
    _, _, cfg = _configs(arch, dtype, kernels)
    model = _port_model(arch, dtype)
    with torch.no_grad():
        x = TF.embed_inputs(model, cfg, tokens=torch.from_numpy(_tokens(cfg)))
        h, _ = TF.forward_hidden(model, cfg, x)
        return TF.logits_fn(model, cfg, h).float().numpy()


def _port_decode(arch, dtype, kernels):
    _, _, cfg = _configs(arch, dtype, kernels)
    model = _port_model(arch, dtype)
    toks = torch.from_numpy(_tokens(cfg))
    caches = TF.init_caches(cfg, B, S, device="cpu")
    outs = []
    with torch.no_grad():
        for i in range(S):
            lg, caches = TF.decode_step(model, cfg, toks[:, i:i + 1], caches, i)
            outs.append(lg.float().numpy())
    return np.stack(outs, 1)


def _rel(got, want, vocab):
    got, want = got[..., :vocab], want[..., :vocab]
    assert np.isfinite(got).all() and got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


PATHS = [pytest.param(False, id="xla_path"), pytest.param(True, id="kernel_path")]


@pytest.mark.parametrize("kernels", PATHS)
@pytest.mark.parametrize("arch", DENSE)
class TestParity:
    def test_forward_f32(self, arch, kernels):
        vocab = _configs(arch, "float32", kernels)[2].vocab_size
        rel = _rel(_port_forward(arch, "float32", kernels),
                   _ref_forward(arch, "float32", kernels), vocab)
        assert rel <= F32_TOL, rel

    def test_decode_f32(self, arch, kernels):
        """16 teacher-forced decode steps through the cache."""
        vocab = _configs(arch, "float32", kernels)[2].vocab_size
        rel = _rel(_port_decode(arch, "float32", kernels),
                   _ref_decode(arch, "float32", kernels), vocab)
        assert rel <= F32_TOL, rel

    def test_forward_bf16(self, arch, kernels):
        vocab = _configs(arch, "bfloat16", kernels)[2].vocab_size
        rel = _rel(_port_forward(arch, "bfloat16", kernels),
                   _ref_forward(arch, "bfloat16", kernels), vocab)
        assert rel <= BF16_TOL, rel

    def test_decode_bf16(self, arch, kernels):
        vocab = _configs(arch, "bfloat16", kernels)[2].vocab_size
        rel = _rel(_port_decode(arch, "bfloat16", kernels),
                   _ref_decode(arch, "bfloat16", kernels), vocab)
        assert rel <= BF16_TOL, rel

    def test_decode_matches_forward_f32(self, arch, kernels):
        """Teacher-forced decode logits == the port's full forward."""
        vocab = _configs(arch, "float32", kernels)[2].vocab_size
        rel = _rel(_port_decode(arch, "float32", kernels),
                   _port_forward(arch, "float32", kernels), vocab)
        assert rel <= DECODE_TOL, rel


@pytest.mark.parametrize("arch", DENSE)
def test_loss_matches_reference(arch):
    rcfg, params, cfg = _configs(arch, "float32", False)
    toks = _tokens(cfg)
    labels = np.roll(toks, -1, 1)
    mask = (np.arange(S) < S - 2).astype(np.float32)[None].repeat(B, 0)
    want, want_m = REF_TF.loss_fn(jax.tree.map(jnp.asarray, params), rcfg,
                                  {"tokens": jnp.asarray(toks),
                                   "labels": jnp.asarray(labels),
                                   "mask": jnp.asarray(mask)})
    got, got_m = TF.loss_fn(_port_model(arch, "float32"), cfg,
                            {"tokens": torch.from_numpy(toks),
                             "labels": torch.from_numpy(labels),
                             "mask": torch.from_numpy(mask)})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(got_m["ce"]), float(want_m["ce"]), rtol=1e-5)


#: Parameters the reference uses in f32 whatever the activation dtype: the
#: norms, the RG-LRU's gates and Lambda, the sLSTM's input projection
#: (``u.astype(f32) @ w.astype(f32) + b``) and its recurrent weights.
KEPT_F32 = ("scale", "bias", "gate_r", "gate_i", "lam", "cell.w.w", "cell.b",
            "cell.r")


def _to_serving_casts_what_the_reference_casts_at_use(arch):
    cfg = reduced_config(ARCHS[arch], layers_scale=2)
    model = to_serving(TF.init_params(cfg, device="cpu"))
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    kept = {n for n in dtypes if n.endswith(KEPT_F32)}
    assert kept and {dtypes[n] for n in kept} == {torch.float32}
    assert {dtypes[n] for n in set(dtypes) - kept} == {torch.bfloat16}
    cast = {n.split(".", 2)[-1] for n in set(dtypes) - kept}
    want = {"qwen2-7b": {"attn.wq.w", "attn.wq.b", "mlp.wi.w", "mlp.wo.w"},
            "recurrentgemma-9b": {"rec.wx.w", "rec.wgate.w", "rec.conv",
                                  "rec.wo.w", "attn.wk.w", "mlp.wg.w"},
            "xlstm-1.3b": {"cell.up.w", "cell.up_gate.w", "cell.wif.w",
                           "cell.wq", "cell.wk", "cell.wv", "cell.down.w",
                           "cell.conv", "ffn.wi.w", "ffn.wo.w"}}[arch]
    assert want <= cast, want - cast
    kept_want = {"qwen2-7b": {"ln1.scale", "ln2.scale"},
                 "recurrentgemma-9b": {"rec.gate_r", "rec.gate_i", "rec.lam"},
                 "xlstm-1.3b": {"cell.w.w", "cell.b", "cell.r",
                                "cell.ln_heads.scale", "ln1.bias"}}[arch]
    assert kept_want <= {n.split(".", 2)[-1] for n in kept}


def test_to_serving_casts_what_the_reference_casts_at_use():
    _to_serving_casts_what_the_reference_casts_at_use("qwen2-7b")


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-1.3b"])
def test_to_serving_keeps_f32_what_the_reference_uses_in_f32(arch):
    _to_serving_casts_what_the_reference_casts_at_use(arch)


def _qkv(shape_q, shape_kv, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in (shape_q, shape_kv, shape_kv)]


class TestAttentionMath:
    @pytest.mark.parametrize("kwargs", [
        dict(causal=True), dict(causal=False),
        dict(causal=True, window=7), dict(causal=True, softcap=10.0),
    ])
    def test_blocked_equals_dense(self, kwargs):
        """The reference's four masks: blocked == dense (atol 3e-6, the
        reference's bound), and the port's blocked == the reference's."""
        q, k, v = _qkv((2, 50, 8, 16), (2, 50, 2, 16))
        tq, tk, tv = map(torch.from_numpy, (q, k, v))
        a = L.blocked_attention(tq, tk, tv, block_q=16, block_kv=8, **kwargs)
        b = L.dense_attention(tq, tk, tv, **kwargs)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=3e-6)
        want = REF_L.blocked_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), block_q=16, block_kv=8,
                                       head_axis=None, **kwargs)
        np.testing.assert_allclose(a.numpy(), np.asarray(want), atol=3e-6)

    def test_decode_offset_masking(self):
        """dense_attention with kv_len masks future cache slots."""
        q, k, v = _qkv((1, 1, 2, 8), (1, 12, 2, 8))
        tq, tk, tv = map(torch.from_numpy, (q, k, v))
        out5 = L.dense_attention(tq, tk, tv, causal=False, kv_len=5)
        k2, v2 = tk.clone(), tv.clone()
        k2[:, 5:] = 999.0                   # garbage beyond kv_len
        v2[:, 5:] = 999.0
        out5b = L.dense_attention(tq, k2, v2, causal=False,
                                  kv_len=torch.tensor([5]))
        np.testing.assert_allclose(out5.numpy(), out5b.numpy(), atol=1e-6)
        want = REF_L.dense_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=False, kv_len=5)
        np.testing.assert_allclose(out5.numpy(), np.asarray(want), atol=1e-6)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_rope_matches_reference(self, dtype):
        """Positions of a prefill and of one decode step; f32 to 1e-6 (sin
        and cos of two libraries), bf16 to one rounding of the result."""
        x = np.random.default_rng(3).standard_normal((2, 9, 3, 16)).astype(np.float32)
        pos = np.arange(9)[None].repeat(2, 0) + np.array([[0], [4000]])
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        want = REF_L.rope(jnp.asarray(x).astype(jdt), jnp.asarray(pos), 1e6)
        got = L.rope(torch.from_numpy(x).to(tdt), torch.from_numpy(pos), 1e6)
        assert got.dtype == tdt
        tol = 1e-5 if dtype == "float32" else 2 ** -7
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   rtol=tol, atol=tol)

    @pytest.mark.parametrize("causal,window,q_offset", [
        (True, None, 0), (True, 24, 0), (False, None, 0), (True, None, 40)])
    def test_block_schedule_matches_reference(self, causal, window, q_offset):
        got = L._block_schedule(4, 6, 16, 8, causal=causal, window=window,
                                q_offset=q_offset)
        want = REF_L._block_schedule(4, 6, 16, 8, causal=causal, window=window,
                                     q_offset=q_offset)
        np.testing.assert_array_equal(got, want)


class TestSkipRules:
    def test_cell_status_covers_40_cells(self):
        total = skipped = 0
        for arch in list_archs():
            for s in SHAPES.values():
                total += 1
                ok, reason = cell_status(ARCHS[arch], s)
                assert (ok, reason) == ref_cell_status(REF_ARCHS[arch],
                                                       REF_SHAPES[s.name])
                if not ok:
                    skipped += 1
                    assert reason
        assert total == 40
        # 7 full-attention long_500k skips + hubert decode/long
        assert skipped == 9

    def test_subquadratic_archs_run_long(self):
        for arch in ("recurrentgemma-9b", "xlstm-1.3b"):
            ok, _ = cell_status(ARCHS[arch], SHAPES["long_500k"])
            assert ok, arch
