"""The port's recurrent decoders against the reference on the CPU:
recurrentgemma-9b (RG-LRU and local-attention blocks) and xlstm-1.3b (sLSTM
and mLSTM blocks), at ``reduced_config`` with two pattern periods (eight
layers and sixteen), over S = 40 positions: more than twice the reduced
local window of 16, so the decode ring wraps.

Parameters are the reference's ``init_params(PRNGKey(0))`` through
``convert.from_reference``, with every bias and norm parameter and the
zero-initialized gates (the RG-LRU's ``gate_r``/``gate_i``, the sLSTM's
``r``) redrawn from a numpy seed: with zero gates r = i = 1/2 whatever x
is, and a port that ignored x in them would pass.  Logits are compared over
the real vocabulary only.

Layer by layer.  Every layer takes the reference forward's input to that
layer, both on the full sequence and, one position a step, through the
teacher-forced decode step that carries its own state; so a comparison
measures one layer's arithmetic.  The model-level comparisons of
tests/test_torch_models.py do not bound these models: in xlstm-1.3b an
mLSTM head whose q.k nearly cancels (h_0 = i (q.k) v at the first
position) is scaled up by the head norm, and the reference's own decode
and forward logits differ by 1.9e-4 of max |logit| in f32 and 0.93 in
bf16 here; recurrentgemma-9b's differ by 3.5e-2 in bf16.  Only
recurrentgemma-9b's f32 logits are compared whole (``TestModelF32``).

Tolerances, relative to the largest reference value compared: f32 2e-5
(one computation in two orders of summation); bf16 2e-2 for the sequence
mixer (attention, RG-LRU, mLSTM, sLSTM) on its normalized input, the
bf16 roundings of the reference's own model tests; a layer's decode
against its own forward 1e-4, the reference's bound for the model.  The
kernel path runs the port's plain kernel versions (CPU tensors) against
the reference's Pallas kernels in interpret mode.
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
from repro.kernels.rglru.ops import scan as ref_rglru_scan
from repro.models import attention as REF_ATT
from repro.models import layers as REF_L
from repro.models import recurrent as REF_REC
from repro.models import transformer as REF_TF
from repro.models import xlstm as REF_XL
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.kernels.mlstm_chunk import ops as ML
from repro_torch.kernels.rglru import ops as RG
from repro_torch.models import attention as ATT
from repro_torch.models import layers as L
from repro_torch.models import recurrent as REC
from repro_torch.models import transformer as TF
from repro_torch.models import xlstm as XL
from repro_torch.models.convert import from_reference, load, to_serving
from test_torch_models import _perturb

RECURRENT = ["recurrentgemma-9b", "xlstm-1.3b"]
B, S = 2, 40
F32_TOL, BF16_TOL, DECODE_TOL = 2e-5, 2e-2, 1e-4
PATHS = [pytest.param(False, id="xla_path"), pytest.param(True, id="kernel_path")]


@functools.lru_cache(maxsize=None)
def _weights(arch):
    cfg = dataclasses.replace(ref_reduced(REF_ARCHS[arch], layers_scale=2),
                              dtype="float32")
    return cfg, _perturb(REF_TF.init_params(jax.random.PRNGKey(0), cfg))


def _configs(arch, dtype, kernels):
    rcfg, params = _weights(arch)
    rcfg = dataclasses.replace(rcfg, dtype=dtype, use_pallas=kernels)
    cfg = dataclasses.replace(reduced_config(ARCHS[arch], layers_scale=2),
                              dtype=dtype, use_kernels=kernels)
    return rcfg, params, cfg


@functools.lru_cache(maxsize=None)
def _port_model(arch, dtype):
    rcfg, params = _weights(arch)
    cfg = dataclasses.replace(reduced_config(ARCHS[arch], layers_scale=2),
                              dtype=dtype)
    model = load(cfg, from_reference(params, rcfg), device="cpu")
    return to_serving(model) if dtype == "bfloat16" else model


def _tokens(cfg):
    return np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S),
                                             dtype=np.int32)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _torch(x, dtype) -> torch.Tensor:
    return torch.tensor(_np(x)).to(getattr(torch, dtype))


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    assert np.isfinite(got).all() and got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _ref_layer(params, rcfg, i):
    """The reference's parameters of layer i (a slice of its stacked group,
    or an entry of ``rest``)."""
    n = len(rcfg.block_pattern)
    g, j = divmod(i, n)
    if g < rcfg.pattern_repeats:
        return jax.tree.map(lambda a: a[g], params["groups"][f"b{j}"])
    return params["rest"][i - rcfg.pattern_repeats * n]


# ---------------------------------------------------------------------------
# the sequence mixers of each block kind, reference and port
# ---------------------------------------------------------------------------

def _ref_mix(p, rcfg, kind, h):
    if kind in ("attn", "local"):
        return REF_ATT.forward(p["attn"], rcfg, h, local=(kind == "local"))
    if kind == "rglru":
        return REF_REC.forward(p["rec"], rcfg, h)
    if kind == "mlstm":
        return REF_XL.mlstm_forward(p["cell"], rcfg, h)
    return REF_XL.slstm_forward(p["cell"], rcfg, h)


def _ref_mix_decode(p, rcfg, kind, h, state, index):
    if kind in ("attn", "local"):
        return REF_ATT.decode_step(p["attn"], rcfg, h, state, index,
                                   local=(kind == "local"))
    if kind == "rglru":
        return REF_REC.decode_step(p["rec"], rcfg, h, state)
    if kind == "mlstm":
        return REF_XL.mlstm_decode_step(p["cell"], rcfg, h, state)
    return REF_XL.slstm_decode_step(p["cell"], rcfg, h, state)


def _port_mix(layer, cfg, kind, h):
    if kind in ("attn", "local"):
        return ATT.forward(layer.attn, cfg, h, local=(kind == "local"))
    if kind == "rglru":
        return REC.forward(layer.rec, cfg, h)
    if kind == "mlstm":
        return XL.mlstm_forward(layer.cell, cfg, h)
    return XL.slstm_forward(layer.cell, cfg, h)


def _port_mix_decode(layer, cfg, kind, h, state, index):
    if kind in ("attn", "local"):
        return ATT.decode_step(layer.attn, cfg, h, state, index,
                               local=(kind == "local"))[0]
    if kind == "rglru":
        return REC.decode_step(layer.rec, cfg, h, state)[0]
    if kind == "mlstm":
        return XL.mlstm_decode_step(layer.cell, cfg, h, state)[0]
    return XL.slstm_decode_step(layer.cell, cfg, h, state)[0]


_ref_block = jax.jit(lambda p, rcfg, kind, x: REF_TF._block_forward(
    p, rcfg, kind, x)[0], static_argnums=(1, 2))
_ref_block_decode = jax.jit(REF_TF._block_decode, static_argnums=(1, 2))
_ref_norm = jax.jit(lambda p, rcfg, x: REF_L.apply_norm(p["ln1"], x, rcfg.norm),
                    static_argnums=1)
_ref_mix_jit = jax.jit(_ref_mix, static_argnums=(1, 2))
_ref_mix_decode_jit = jax.jit(_ref_mix_decode, static_argnums=(1, 2))


@functools.lru_cache(maxsize=None)
def _ref_layers(arch, dtype, kernels, mixer):
    """Layer by layer, the reference's input to each layer on the full
    sequence, its output, and its teacher-forced decode outputs (the decode
    step fed the same inputs one position a step).  With ``mixer`` the
    layer is its sequence mixer alone, fed the normalized input."""
    rcfg, params, _ = _configs(arch, dtype, kernels)
    jp = jax.tree.map(jnp.asarray, params)
    x = REF_TF.embed_inputs(jp, rcfg, tokens=jnp.asarray(_tokens(rcfg)))
    rows = []
    for i, kind in enumerate(rcfg.block_kinds):
        p = _ref_layer(jp, rcfg, i)
        if mixer:
            xin = _ref_norm(p, rcfg, x)
            out = _ref_mix_jit(p, rcfg, kind, xin)
            step = functools.partial(_ref_mix_decode_jit, p, rcfg, kind)
        else:
            xin = x
            out = _ref_block(p, rcfg, kind, xin)
            step = functools.partial(_ref_block_decode, p, rcfg, kind)
        cache = REF_TF._block_cache(rcfg, kind, B, S)
        dec = []
        for t in range(S):
            y, cache = step(xin[:, t:t + 1], cache, jnp.asarray(t, jnp.int32))
            dec.append(_np(y.astype(jnp.float32)))
        rows.append((kind, _np(xin.astype(jnp.float32)),
                     _np(out.astype(jnp.float32)), np.concatenate(dec, 1)))
        x = _ref_block(p, rcfg, kind, x)
    return rows


@functools.lru_cache(maxsize=None)
def _port_layers(arch, dtype, kernels, mixer):
    """The port's counterpart of ``_ref_layers`` on the reference's inputs:
    per layer (forward output, teacher-forced decode outputs)."""
    _, _, cfg = _configs(arch, dtype, kernels)
    model = _port_model(arch, dtype)
    out = []
    with torch.no_grad():
        for i, (kind, xin, _, _) in enumerate(_ref_layers(arch, dtype, kernels,
                                                          mixer)):
            layer = model.layers[i]
            x = _torch(xin, dtype)
            if mixer:
                fwd = _port_mix(layer, cfg, kind, x)
            else:
                rot = ATT.rotary(cfg, torch.arange(S)[None]) \
                    if kind in ("attn", "local") else None
                fwd = TF._block_forward(layer, cfg, kind, x, rot)[0]
            state = TF.block_cache(cfg, kind, B, S, device="cpu")
            dec = []
            for t in range(S):
                idx = torch.tensor([t])
                if mixer:
                    y = _port_mix_decode(layer, cfg, kind, x[:, t:t + 1],
                                         state, idx)
                else:
                    rot = ATT.rotary(cfg, idx.reshape(1, 1)) \
                        if kind in ("attn", "local") else None
                    y = TF._block_decode(layer, cfg, kind, x[:, t:t + 1],
                                         state, idx, rot)
                dec.append(_np(y))
            out.append((_np(fwd), np.concatenate(dec, 1)))
    return out


def _worst(arch, dtype, kernels, mixer, what):
    """max over layers of the relative distance ``what`` compares."""
    ref = _ref_layers(arch, dtype, kernels, mixer)
    port = _port_layers(arch, dtype, kernels, mixer)
    rels = []
    for (kind, _, r_fwd, r_dec), (p_fwd, p_dec) in zip(ref, port):
        pair = {"forward": (p_fwd, r_fwd), "decode": (p_dec, r_dec),
                "decode_vs_forward": (p_dec, p_fwd)}[what]
        rels.append((_rel(*pair), kind))
    assert {k for _, k in rels} == set(_configs(arch, dtype, kernels)[2].block_kinds)
    return max(rels)


@pytest.mark.parametrize("kernels", PATHS)
@pytest.mark.parametrize("arch", RECURRENT)
class TestLayerParity:
    def test_forward_f32(self, arch, kernels):
        rel, kind = _worst(arch, "float32", kernels, False, "forward")
        assert rel <= F32_TOL, (rel, kind)

    def test_decode_f32(self, arch, kernels):
        """Every layer's teacher-forced decode over 40 positions."""
        rel, kind = _worst(arch, "float32", kernels, False, "decode")
        assert rel <= F32_TOL, (rel, kind)

    def test_decode_matches_forward_f32(self, arch, kernels):
        rel, kind = _worst(arch, "float32", kernels, False, "decode_vs_forward")
        assert rel <= DECODE_TOL, (rel, kind)

    def test_mixer_forward_bf16(self, arch, kernels):
        rel, kind = _worst(arch, "bfloat16", kernels, True, "forward")
        assert rel <= BF16_TOL, (rel, kind)

    def test_mixer_decode_bf16(self, arch, kernels):
        rel, kind = _worst(arch, "bfloat16", kernels, True, "decode")
        assert rel <= BF16_TOL, (rel, kind)


# ---------------------------------------------------------------------------
# recurrentgemma-9b whole, f32
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_logits(arch, kernels, decode):
    rcfg, params, _ = _configs(arch, "float32", kernels)
    jp = jax.tree.map(jnp.asarray, params)
    toks = jnp.asarray(_tokens(rcfg))
    if not decode:
        h, _ = REF_TF.forward_hidden(jp, rcfg, REF_TF.embed_inputs(
            jp, rcfg, tokens=toks))
        return _np(REF_TF.logits_fn(jp, rcfg, h))
    caches = REF_TF.init_caches(rcfg, B, S)
    step = jax.jit(REF_TF.decode_step, static_argnums=1)
    outs = []
    for i in range(S):
        lg, caches = step(jp, rcfg, toks[:, i:i + 1], caches,
                          jnp.asarray(i, jnp.int32))
        outs.append(_np(lg))
    return np.stack(outs, 1)


@functools.lru_cache(maxsize=None)
def _port_logits(arch, kernels, decode):
    _, _, cfg = _configs(arch, "float32", kernels)
    model = _port_model(arch, "float32")
    toks = torch.from_numpy(_tokens(cfg))
    with torch.no_grad():
        if not decode:
            h, _ = TF.forward_hidden(model, cfg, TF.embed_inputs(
                model, cfg, tokens=toks))
            return _np(TF.logits_fn(model, cfg, h))
        caches = TF.init_caches(cfg, B, S, device="cpu")
        outs = []
        for i in range(S):
            lg, caches = TF.decode_step(model, cfg, toks[:, i:i + 1], caches, i)
            outs.append(_np(lg))
    return np.stack(outs, 1)


@pytest.mark.parametrize("kernels", PATHS)
class TestModelF32:
    arch = "recurrentgemma-9b"

    def _rel(self, got, want):
        vocab = _configs(self.arch, "float32", False)[2].vocab_size
        return _rel(got[..., :vocab], want[..., :vocab])

    def test_forward(self, kernels):
        rel = self._rel(_port_logits(self.arch, kernels, False),
                        _ref_logits(self.arch, kernels, False))
        assert rel <= F32_TOL, rel

    def test_decode(self, kernels):
        """40 teacher-forced decode steps: the 16-row rings wrap twice."""
        rel = self._rel(_port_logits(self.arch, kernels, True),
                        _ref_logits(self.arch, kernels, True))
        assert rel <= F32_TOL, rel

    def test_decode_matches_forward(self, kernels):
        rel = self._rel(_port_logits(self.arch, kernels, True),
                        _port_logits(self.arch, kernels, False))
        assert rel <= DECODE_TOL, rel


# ---------------------------------------------------------------------------
# units: the conv, the gates, the scans, the chunkwise mLSTM, the sLSTM
# ---------------------------------------------------------------------------

def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_conv_matches_reference(dtype, with_state):
    """Shifted adds in the activation dtype, with and without the carried
    trailing inputs: the same additions in the same order (f32 to 1e-6;
    bf16 to one rounding of the result)."""
    x, conv, st = _x((2, 9, 24), 1), _x((4, 24), 2), _x((2, 3, 24), 3)
    jdt = getattr(jnp, dtype)
    want, want_st = REF_REC._conv({"conv": jnp.asarray(conv)},
                                  jnp.asarray(x).astype(jdt),
                                  jnp.asarray(st).astype(jdt) if with_state else None)
    got, got_st = REC._conv(torch.from_numpy(conv), _torch(x, dtype),
                            _torch(st, dtype) if with_state else None)
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(_np(got), _np(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    np.testing.assert_array_equal(_np(got_st), _np(want_st.astype(jnp.float32)))


def test_decay_and_input_matches_reference():
    rcfg, params = _weights("recurrentgemma-9b")
    p = _ref_layer(jax.tree.map(jnp.asarray, params), rcfg, 0)["rec"]
    layer = _port_model("recurrentgemma-9b", "float32").layers[0].rec
    x = _x((2, 7, rcfg.rnn_width), 4)
    wa, wb = REF_REC._decay_and_input(p, jnp.asarray(x))
    ga, gb = REC._decay_and_input(layer, torch.from_numpy(x))
    assert ga.dtype == gb.dtype == torch.float32
    np.testing.assert_allclose(ga.numpy(), np.asarray(wa), rtol=2e-6, atol=1e-7)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=2e-5, atol=1e-6)
    assert float(ga.std()) > 0.01   # the redrawn gates read x


@pytest.mark.parametrize("S_", [1, 2, 7, 64, 97])
def test_associative_scan(S_):
    """The log-depth scan against K6's plain loop (f32, 1e-6) and against
    the reference's ``lax.associative_scan`` (the same recursion)."""
    rng = np.random.default_rng(S_)
    a = rng.uniform(0.5, 1.0, (2, S_, 24)).astype(np.float32)
    b = rng.standard_normal((2, S_, 24)).astype(np.float32)
    _, h = L.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    want = RG.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(h.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)

    def combine(left, right):
        return left[0] * right[0], right[0] * left[1] + right[1]
    _, ref = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)),
                                      axis=1)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_rglru_scan(
        jnp.asarray(a), jnp.asarray(b))), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kernels", PATHS)
def test_chunkwise_mlstm_matches_sequential_and_reference(kernels):
    """The mLSTM cell on a random input (no residual stream, so no head
    whose q.k cancels by construction): the chunked form against the
    port's step-by-step oracle and the reference's chunked form, f32."""
    rcfg, params, cfg = _configs("xlstm-1.3b", "float32", kernels)
    p = _ref_layer(jax.tree.map(jnp.asarray, params), rcfg, 1)["cell"]
    cell = _port_model("xlstm-1.3b", "float32").layers[1].cell
    x = _x((2, 32, rcfg.d_model), 5)
    with torch.no_grad():
        got = XL.mlstm_forward(cell, cfg, torch.from_numpy(x))
        seq = XL.mlstm_sequential(cell, cfg, torch.from_numpy(x))
    want = REF_XL.mlstm_forward(p, rcfg, jnp.asarray(x))
    assert _rel(got, seq) <= 1e-5
    assert _rel(got, want) <= F32_TOL
    assert _rel(seq, REF_XL.mlstm_sequential(p, rcfg, jnp.asarray(x))) <= F32_TOL


def test_slstm_forward_matches_reference():
    rcfg, params = _weights("xlstm-1.3b")
    p = _ref_layer(jax.tree.map(jnp.asarray, params), rcfg, 0)["cell"]
    cfg = reduced_config(ARCHS["xlstm-1.3b"], layers_scale=2)
    cell = _port_model("xlstm-1.3b", "float32").layers[0].cell
    x = _x((2, 33, rcfg.d_model), 6)
    with torch.no_grad():
        got = XL.slstm_forward(cell, dataclasses.replace(cfg, dtype="float32"),
                               torch.from_numpy(x))
    want = REF_XL.slstm_forward(p, dataclasses.replace(rcfg, dtype="float32"),
                                jnp.asarray(x))
    assert _rel(got, want) <= F32_TOL


def test_mlstm_kernel_path_takes_head_first_views():
    """K7's wrapper takes (B, H, S, dh) views of the model's (B, S, H, dh)
    projections as they are (no copy: one stride layout for q, k, v)."""
    cfg = dataclasses.replace(reduced_config(ARCHS["xlstm-1.3b"]),
                              dtype="float32")
    cell = _port_model("xlstm-1.3b", "float32").layers[1].cell
    x = torch.from_numpy(_x((2, 16, cfg.d_model), 7))
    q, k, v, li, lf, _ = XL._mlstm_qkvif(cell, cfg, x)
    assert q.stride() == k.stride() == v.stride() and q.stride(3) == 1
    assert li.dtype == lf.dtype == torch.float32 and li.stride() == lf.stride()
    np.testing.assert_array_equal(
        ML.chunked_mlstm(q, k, v, li, lf, chunk=8).numpy(),
        ML.chunked_mlstm_ref(q, k, v, li, lf, chunk=8).numpy())
