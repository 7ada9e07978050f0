"""The port's stub-frontend models against the reference on the CPU, at
``reduced_config`` with two layers: hubert-xlarge (audio features through
``frontend``; an encoder: no RoPE, no causal mask, no decode) and
internvl2-2b (vision-patch features prepended to the token embeddings;
a decoder).

Parameters are the reference's ``init_params(PRNGKey(0))`` with
``_perturb`` through ``convert.from_reference``; features and tokens come
from numpy seeds.  Logits over the real vocabulary, tolerances relative
to max |logit| as for the dense archs (tests/test_torch_models.py): f32
2e-5, bf16 2e-2; internvl2-2b's decode against the reference's decode,
and the losses (internvl2-2b's over the trailing text positions) to 1e-5.
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
from repro.models import transformer as REF_TF
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.configs.shapes import vision_patches
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import transformer as TF
from repro_torch.models.convert import from_reference, load, to_serving
from test_torch_models import _perturb

FRONTENDS = ["hubert-xlarge", "internvl2-2b"]
B, S = 2, 16
F32_TOL, BF16_TOL = 2e-5, 2e-2
PATHS = [pytest.param(False, id="xla_path"), pytest.param(True, id="kernel_path")]
DTYPES = ["float32", "bfloat16"]


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


def _inputs(cfg, seed=0) -> dict:
    """The stub frontends' inputs (``configs.shapes``' layout): hubert S
    feature rows; internvl2 ``vision_patches(S)`` patch rows and the
    rest text tokens."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        return {"features": rng.standard_normal(
            (B, S, cfg.frontend_dim)).astype(np.float32)}
    patches = vision_patches(S)
    return {"features": rng.standard_normal(
        (B, patches, cfg.frontend_dim)).astype(np.float32),
        "tokens": rng.integers(0, cfg.vocab_size, (B, S - patches),
                               dtype=np.int32)}


def _vocab(logits, cfg) -> np.ndarray:
    if isinstance(logits, torch.Tensor):
        logits = logits.float().numpy()
    return np.asarray(logits, np.float32)[..., :cfg.vocab_size]


def _rel(got, want) -> float:
    assert np.isfinite(got).all() and got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _ref_forward(arch, dtype, kernels):
    rcfg, params, cfg = _configs(arch, dtype, kernels)
    jp = jax.tree.map(jnp.asarray, params)
    x = REF_TF.embed_inputs(jp, rcfg, **{k: jnp.asarray(v) for k, v in
                                         _inputs(cfg).items()})
    h, _ = REF_TF.forward_hidden(jp, rcfg, x)
    return _vocab(REF_TF.logits_fn(jp, rcfg, h).astype(jnp.float32), cfg)


def _port_forward(arch, dtype, kernels):
    _, _, cfg = _configs(arch, dtype, kernels)
    model = _port_model(arch, dtype)
    with torch.no_grad():
        x = TF.embed_inputs(model, cfg, **{k: torch.from_numpy(v) for k, v in
                                           _inputs(cfg).items()})
        h, _ = TF.forward_hidden(model, cfg, x)
        return _vocab(TF.logits_fn(model, cfg, h), cfg)


@pytest.mark.parametrize("kernels", PATHS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", FRONTENDS)
def test_forward_matches_reference(arch, dtype, kernels):
    got = _port_forward(arch, dtype, kernels)
    want = _ref_forward(arch, dtype, kernels)
    assert got.shape == (B, S, _configs(arch, dtype, kernels)[2].vocab_size)
    assert _rel(got, want) <= (F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("arch", FRONTENDS)
def test_prefill_step_takes_features(arch):
    """``make_prefill_step`` on the frontends' batch: the forward's last
    position."""
    _, _, cfg = _configs(arch, "float32", True)
    batch = {k: torch.from_numpy(v) for k, v in _inputs(cfg).items()}
    last = make_prefill_step(cfg)(_port_model(arch, "float32"), batch)
    assert last.shape == (B, 1, cfg.padded_vocab)
    np.testing.assert_allclose(_vocab(last, cfg)[:, 0],
                               _port_forward(arch, "float32", True)[:, -1],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", FRONTENDS)
def test_loss_matches_reference(arch):
    """hubert: labels and a mask on every feature row; internvl2: labels
    on the text alone, the loss over the trailing text positions."""
    rcfg, params, cfg = _configs(arch, "float32", False)
    inputs = _inputs(cfg, seed=3)
    rng = np.random.default_rng(4)
    n = S if cfg.frontend == "audio" else S - vision_patches(S)
    batch = {**inputs, "labels": rng.integers(0, cfg.vocab_size, (B, n),
                                              dtype=np.int32)}
    if cfg.frontend == "audio":
        batch["mask"] = (np.arange(n) < n - 3).astype(np.float32)[None].repeat(B, 0)
    want, want_m = REF_TF.loss_fn(jax.tree.map(jnp.asarray, params), rcfg,
                                  {k: jnp.asarray(v) for k, v in batch.items()})
    got, got_m = TF.loss_fn(_port_model(arch, "float32"), cfg,
                            {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(got_m["ce"]), float(want_m["ce"]), rtol=1e-5)
    assert float(got_m["aux"]) == 0.0


@pytest.mark.parametrize("kernels", PATHS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_internvl2_decode_matches_reference(dtype, kernels):
    """The VLM decodes text tokens through its cache, as the dense archs."""
    rcfg, params, cfg = _configs("internvl2-2b", dtype, kernels)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S),
                                             dtype=np.int32)
    jp = jax.tree.map(jnp.asarray, params)
    caches = REF_TF.init_caches(rcfg, B, S)
    step = jax.jit(REF_TF.decode_step, static_argnums=1)
    model = _port_model("internvl2-2b", dtype)
    tcaches = TF.init_caches(cfg, B, S, device="cpu")
    want, got = [], []
    with torch.no_grad():
        for i in range(S):
            lg, caches = step(jp, rcfg, jnp.asarray(toks[:, i:i + 1]), caches,
                              jnp.asarray(i, jnp.int32))
            want.append(_vocab(lg.astype(jnp.float32), cfg))
            tl, tcaches = TF.decode_step(model, cfg,
                                         torch.from_numpy(toks[:, i:i + 1]),
                                         tcaches, i)
            got.append(_vocab(tl, cfg))
    assert _rel(np.stack(got, 1), np.stack(want, 1)) <= \
        (F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("arch", FRONTENDS)
def test_state_dict_loads_strictly(arch):
    """``frontend.w`` and (internvl2 only) ``embed`` land in the port;
    every element of the reference's tree is held."""
    rcfg, params = _weights(arch)
    sd = from_reference(params, rcfg)
    assert sum(t.numel() for t in sd.values()) == sum(
        int(np.prod(np.shape(x))) for x in jax.tree.leaves(params))
    model = _port_model(arch, "float32")
    np.testing.assert_array_equal(model.frontend.w.numpy(),
                                  np.asarray(params["frontend"]["w"]))
    assert (model.embed is None) == (arch == "hubert-xlarge") == \
        ("embed" not in params)
    np.testing.assert_array_equal(model.layers[1].mlp.wi.w.numpy(),
                                  np.asarray(params["groups"]["b0"]["mlp"]
                                             ["wi"]["w"][1]))


@pytest.mark.parametrize("arch", FRONTENDS)
def test_full_width_parameters_match_reference_tree(arch):
    with torch.device("meta"):
        model = TF.Transformer(ARCHS[arch])
    ref = jax.eval_shape(lambda: REF_TF.init_params(jax.random.PRNGKey(0),
                                                    REF_ARCHS[arch]))
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(ref))


@pytest.mark.parametrize("arch", FRONTENDS)
def test_to_serving_casts_the_frontend(arch):
    """The reference casts the features and the frontend weight to the
    activation dtype at use; ``to_serving`` casts the weight once."""
    cfg = reduced_config(ARCHS[arch], layers_scale=2)
    model = to_serving(TF.init_params(cfg, device="cpu"))
    assert model.frontend.w.dtype == torch.bfloat16
    assert model.ln_f.scale.dtype == torch.float32
