"""The port's MoE layer and MoE decoders (``repro_torch.models.moe``)
against the reference (``repro.models.moe``) on the CPU, at
``reduced_config`` for qwen3-moe-235b-a22b (SwiGLU experts, qk norm) and
grok-1-314b (gelu experts, softcap 30): 4 experts, top-2.

The layer.  Parameters are drawn from a numpy seed (the router N(0, 4/d)
so that its top-k is decided, not a near tie; or zero, so that every
probability ties and the top-k must take the lower expert first, as
``jax.lax.top_k`` does), inputs too.  The reference's two semantics
(``forward_einsum``, ``forward_sort``) and ``forward(decode=)`` are held
to the port's at capacity factors 0.25 (pairs dropped) and 8.0 (none):
the chosen experts, each pair's position in its expert's queue and the
keep mask equal, as integers, a numpy transcription of the reference's
own assignment (its one-hot loop; its stable argsort and bincount) on the
reference router's experts; the outputs within 1e-5 of max |out| in f32
(one computation in two orders of summation) and 2e-2 in bf16 (the
attention tolerance of tests/test_kernels.py: both round the expert
products and the combine to bf16); the aux loss to 1e-6.

Shares.  ``MoE(experts=(lo, hi))`` computes its experts' part of the
layer: four shares of one expert, and two of two, add up to the uncut
reference layer (f32, 1e-5 of max), in both semantics.

The model.  The reference's ``init_params(PRNGKey(0))`` at two layers
with ``_perturb`` through ``convert.from_reference``: f32 logits of
prefill and teacher-forced decode to 2e-5 of max |logit| over the real
vocabulary, as the dense archs; decode against the port's own forward to
1e-4, at capacity factor 8.0 only (below it the reference's own einsum
prefill and sort decode drop different pairs).  In bf16 a rounding can
flip a top-k choice where two router probabilities nearly tie (grok-1's
second layer here: a gap of 1.3e-4 in probability), and a flipped expert
moves a token's output far past any rounding bound: the reference's own
bf16 XLA and kernel paths give logits 0.44 of max |logit| apart. So bf16
is held layer by layer: each layer's attention on the reference's input
to that layer, and its MoE on the reference's normed input to the MoE,
each to 2e-2 of max, with the same experts chosen.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced_config as ref_reduced
from repro.models import attention as REF_ATT
from repro.models import layers as REF_L
from repro.models import moe as REF_MOE
from repro.models import transformer as REF_TF
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.models import attention as ATT
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as TF
from repro_torch.models.convert import from_reference, load, to_serving
from test_torch_models import _perturb

MOE_ARCHS = ["qwen3-moe-235b-a22b", "grok-1-314b"]
F32_TOL, BF16_TOL, DECODE_TOL, MODEL_F32_TOL = 1e-5, 2e-2, 1e-4, 2e-5
PATHS = [pytest.param(False, id="xla_path"), pytest.param(True, id="kernel_path")]
IMPLS = ["einsum", "sort"]
ROUTERS = ["random", "zero"]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want) -> float:
    got, want = _np(got), _np(want)
    assert np.isfinite(got).all() and got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def _cfgs(arch, dtype="float32", cf=1.25):
    rcfg = dataclasses.replace(ref_reduced(REF_ARCHS[arch]), dtype=dtype,
                               capacity_factor=cf)
    cfg = dataclasses.replace(reduced_config(ARCHS[arch]), dtype=dtype,
                              capacity_factor=cf)
    return rcfg, cfg


def _layer_params(cfg, router="random", seed=0) -> dict:
    rng = np.random.default_rng(seed)
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    w = (np.zeros((d, E)) if router == "zero"
         else rng.standard_normal((d, E)) * 2.0 / math.sqrt(d))
    return {"router": {"w": w.astype(np.float32)},
            "wi": (rng.standard_normal((E, d, f)) / math.sqrt(d)).astype(np.float32),
            "wg": (rng.standard_normal((E, d, f)) / math.sqrt(d)).astype(np.float32),
            "wo": (rng.standard_normal((E, f, d)) / math.sqrt(f)).astype(np.float32)}


def _port_layer(cfg, p, experts=None) -> MOE.MoE:
    lo, hi = experts or (0, cfg.n_experts)
    with torch.device("meta"):
        layer = MOE.MoE(cfg, experts=experts)
    layer.load_state_dict(
        {"router.w": torch.tensor(p["router"]["w"]),
         **{k: torch.tensor(p[k][lo:hi]) for k in ("wi", "wg", "wo")}},
        strict=True, assign=True)
    return layer


def _x(cfg, shape=(2, 40), seed=1):
    x = np.random.default_rng(seed).standard_normal(shape + (cfg.d_model,))
    return x.astype(np.float32)


def _both(x, dtype):
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _ref_assign(experts: np.ndarray, E: int, C: int, impl: str):
    """The reference's capacity assignment transcribed in numpy (its
    ``forward_einsum`` one-hot loop, its ``forward_sort`` stable argsort and
    bincount) on its router's experts (g, n, k): (positions, keep)."""
    g, n, k = experts.shape
    pos = np.zeros_like(experts)
    for gi in range(g):
        e = experts[gi]
        if impl == "einsum":
            counts = np.zeros(E, np.int64)
            for j in range(k):
                m = np.eye(E, dtype=np.int64)[e[:, j]]
                pos_j = counts[None, :] + np.cumsum(m, 0) - m
                pos[gi, :, j] = pos_j[np.arange(n), e[:, j]]
                counts += m.sum(0)
        else:
            flat = e.reshape(n * k)
            order = np.argsort(flat, kind="stable")
            counts = np.bincount(flat, minlength=E)
            starts = np.cumsum(counts) - counts
            p = np.zeros(n * k, np.int64)
            p[order] = np.arange(n * k) - starts[flat[order]]
            pos[gi] = p.reshape(n, k)
    return pos, pos < C


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_capacity_matches_reference(arch):
    for cf in (0.25, 1.25, 8.0):
        rcfg, cfg = _cfgs(arch, cf=cf)
        for n in (1, 2, 40, 80, 1024, 2048, 8192):
            assert MOE.capacity(cfg, n) == REF_MOE.capacity(rcfg, n)


@pytest.mark.parametrize("router", ROUTERS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_router_matches_reference(arch, router):
    """probs and renormalized weights (f32, 1e-6), the top-k experts
    exactly (the zero router: every token takes experts 0 and 1), the aux
    loss (the zero router: exactly 1, the Switch loss of a uniform
    router)."""
    rcfg, cfg = _cfgs(arch)
    p = _layer_params(cfg, router)
    x = _x(cfg)
    want = REF_MOE._router(jax.tree.map(jnp.asarray, p), rcfg, jnp.asarray(x))
    got = MOE._router(_port_layer(cfg, p), cfg, torch.from_numpy(x))
    for name, w, g in zip(("probs", "weights"), want[:2], got[:2]):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-6)
    if router == "zero":
        assert (got[2].numpy() == np.arange(cfg.experts_per_token)).all()
        assert float(got[3]) == pytest.approx(1.0, rel=1e-6)


@pytest.mark.parametrize("cf", [0.25, 8.0])
@pytest.mark.parametrize("router", ROUTERS)
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_assignment_matches_reference(arch, impl, router, cf):
    """The experts chosen, each pair's position and the keep mask equal the
    reference's as integers; at 0.25 pairs are dropped, at 8.0 none."""
    rcfg, cfg = _cfgs(arch, cf=cf)
    p = _layer_params(cfg, router)
    x = _x(cfg)
    xg, _, experts, pos, C, _ = MOE.assign(_port_layer(cfg, p), cfg,
                                           torch.from_numpy(x), impl)
    g, n = xg.shape[:2]
    want_e = np.asarray(REF_MOE._router(jax.tree.map(jnp.asarray, p), rcfg,
                                        jnp.asarray(x).reshape(g, n, -1))[2])
    want_pos, want_keep = _ref_assign(want_e, cfg.n_experts, C, impl)
    np.testing.assert_array_equal(experts.numpy(), want_e)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal((pos < C).numpy(), want_keep)
    assert (~want_keep).any() == (cf < 1.0)


@pytest.mark.parametrize("cf", [0.25, 8.0])
@pytest.mark.parametrize("router", ROUTERS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_matches_reference(arch, impl, dtype, router, cf):
    rcfg, cfg = _cfgs(arch, dtype, cf)
    p = _layer_params(cfg, router)
    jx, tx = _both(_x(cfg), dtype)
    ref_fn = {"einsum": REF_MOE.forward_einsum, "sort": REF_MOE.forward_sort}
    fn = {"einsum": MOE.forward_einsum, "sort": MOE.forward_sort}
    want, want_aux = ref_fn[impl](jax.tree.map(jnp.asarray, p), rcfg, jx)
    got, got_aux = fn[impl](_port_layer(cfg, p), cfg, tx)
    assert got.dtype == tx.dtype
    assert _rel(got, want) <= (F32_TOL if dtype == "float32" else BF16_TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-6)


@pytest.mark.parametrize("shape", [(2, 40), (2, 1), (1, 5)],
                         ids=["prefill", "step", "one_row"])
@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_decode_flag_selects_as_the_reference(arch, dtype, decode,
                                                      shape):
    """``forward(decode=)``: the config's einsum on prefill, sort on every
    decode step, as the reference's."""
    rcfg, cfg = _cfgs(arch, dtype, cf=0.25)
    p = _layer_params(cfg)
    jx, tx = _both(_x(cfg, shape), dtype)
    want, _ = REF_MOE.forward(jax.tree.map(jnp.asarray, p), rcfg, jx,
                              decode=decode)
    got, _ = MOE.forward(_port_layer(cfg, p), cfg, tx, decode=decode)
    assert _rel(got, want) <= (F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_einsum_groups_span_batch_rows(arch):
    """S 2,560 over B 2: groups of 1,024 tokens (2,048 halved until it
    divides 5,120), the third spanning both rows; capacity 0.25 drops."""
    rcfg, cfg = _cfgs(arch, cf=0.25)
    p = _layer_params(cfg)
    x = _x(cfg, (2, 2560))
    want, _ = REF_MOE.forward_einsum(jax.tree.map(jnp.asarray, p), rcfg,
                                     jnp.asarray(x))
    layer = _port_layer(cfg, p)
    got, _ = MOE.forward_einsum(layer, cfg, torch.from_numpy(x))
    assert _rel(got, want) <= F32_TOL
    xg, _, _, pos, C, _ = MOE.assign(layer, cfg, torch.from_numpy(x), "einsum")
    assert tuple(xg.shape[:2]) == (5, 1024) and bool((pos >= C).any())


@pytest.mark.parametrize("split", [1, 2], ids=["4_shares_of_1", "2_shares_of_2"])
@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_shares_add_up_to_the_uncut_layer(arch, impl, split):
    """Each share computes its experts' part with the whole layer's
    routing, capacity and aux loss; the parts add up to the uncut
    reference layer (capacity 0.25: the dropped pairs are the whole
    layer's)."""
    rcfg, cfg = _cfgs(arch, cf=0.25)
    p = _layer_params(cfg)
    x = _x(cfg)
    ref_fn = {"einsum": REF_MOE.forward_einsum, "sort": REF_MOE.forward_sort}
    want, want_aux = ref_fn[impl](jax.tree.map(jnp.asarray, p), rcfg,
                                  jnp.asarray(x))
    fn = {"einsum": MOE.forward_einsum, "sort": MOE.forward_sort}[impl]
    parts = []
    for lo in range(0, cfg.n_experts, split):
        layer = _port_layer(cfg, p, experts=(lo, lo + split))
        assert tuple(layer.wi.shape) == (split, cfg.d_model, cfg.d_ff)
        out, aux = fn(layer, cfg, torch.from_numpy(x))
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
        parts.append(out)
    assert all(_rel(part, want) > 0.01 for part in parts)
    assert _rel(sum(parts), want) <= F32_TOL


def test_share_is_checked():
    cfg = _cfgs("qwen3-moe-235b-a22b")[1]
    for bad in ((2, 2), (-1, 2), (0, 5)):
        with pytest.raises(ValueError, match="experts"):
            MOE.MoE(cfg, experts=bad, device="meta")


# ---------------------------------------------------------------------------
# the reference's invariants (tests/test_models.py TestMoE) on the port
# ---------------------------------------------------------------------------

class TestInvariants:
    def _layer(self, cf, seed=0):
        cfg = _cfgs("qwen3-moe-235b-a22b", cf=cf)[1]
        return cfg, _port_layer(cfg, _layer_params(cfg, seed=seed))

    def test_batch_vs_single_token_consistent(self):
        cfg, layer = self._layer(8.0)
        x = torch.from_numpy(_x(cfg, (2, 6)))
        full, _ = MOE.forward(layer, cfg, x)
        singles = torch.cat([MOE.forward(layer, cfg, x[:, i:i + 1])[0]
                             for i in range(6)], 1)
        np.testing.assert_allclose(full.numpy(), singles.numpy(), atol=1e-6)

    def test_capacity_drops_tokens(self):
        """A small capacity factor drops pairs (0.25: every token loses its
        second slot here; 0.5: some keep both): a token that kept all its
        slots gets the uncut output, one that lost a slot its kept slots'
        part alone."""
        for cf in (0.25, 0.5):
            cfg, layer = self._layer(cf)
            x = torch.from_numpy(_x(cfg, (1, 64)))
            small, aux = MOE.forward(layer, cfg, x)
            big, _ = MOE.forward(
                layer, dataclasses.replace(cfg, capacity_factor=8.0), x)
            assert torch.isfinite(small).all() and torch.isfinite(aux)
            _, _, _, pos, C, _ = MOE.assign(layer, cfg, x, "einsum")
            dropped = (pos >= C).reshape(64, -1).any(-1)
            assert dropped.all() == (cf == 0.25)
            np.testing.assert_allclose(small[0, ~dropped].numpy(),
                                       big[0, ~dropped].numpy(), atol=1e-6)
            assert (small[0, dropped] - big[0, dropped]).abs().amax(-1).min() > 0.01

    def test_weights_renormalized(self):
        """Identical experts: the output is that one expert's FFN, whatever
        the routing."""
        cfg, layer = self._layer(8.0)
        for name in ("wi", "wg", "wo"):
            w = getattr(layer, name)
            w.data = w.data[:1].expand_as(w).clone()
        x = torch.from_numpy(_x(cfg, (1, 8)))
        out, _ = MOE.forward(layer, cfg, x)
        h = x @ layer.wi[0]
        g = L.activate(x @ layer.wg[0], cfg.act)
        np.testing.assert_allclose(out.numpy(), ((g * h) @ layer.wo[0]).numpy(),
                                   rtol=2e-4, atol=2e-5)

    def test_aux_loss_uniform_router_is_one(self):
        cfg = _cfgs("qwen3-moe-235b-a22b", cf=8.0)[1]
        layer = _port_layer(cfg, _layer_params(cfg, "zero"))
        _, aux = MOE.forward(layer, cfg, torch.from_numpy(_x(cfg, (1, 256))))
        assert float(aux) == pytest.approx(1.0, rel=0.05)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

B, S = 2, 16


@functools.lru_cache(maxsize=None)
def _weights(arch):
    cfg = dataclasses.replace(ref_reduced(REF_ARCHS[arch], layers_scale=2),
                              dtype="float32")
    return cfg, _perturb(REF_TF.init_params(jax.random.PRNGKey(0), cfg))


def _model_cfgs(arch, dtype, kernels, cf=1.25):
    rcfg, params = _weights(arch)
    rcfg = dataclasses.replace(rcfg, dtype=dtype, use_pallas=kernels,
                               capacity_factor=cf)
    cfg = dataclasses.replace(reduced_config(ARCHS[arch], layers_scale=2),
                              dtype=dtype, use_kernels=kernels,
                              capacity_factor=cf)
    return rcfg, params, cfg


@functools.lru_cache(maxsize=None)
def _port_model(arch, dtype, experts=None):
    rcfg, params = _weights(arch)
    cfg = dataclasses.replace(reduced_config(ARCHS[arch], layers_scale=2),
                              dtype=dtype)
    model = load(cfg, from_reference(params, rcfg, experts=experts),
                 device="cpu", experts=experts)
    return to_serving(model) if dtype == "bfloat16" else model


def _tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S),
                                                dtype=np.int32)


def _vocab(logits, cfg):
    return _np(logits)[..., :cfg.vocab_size]


@functools.lru_cache(maxsize=None)
def _ref_logits(arch, kernels, decode, cf=1.25):
    rcfg, params, cfg = _model_cfgs(arch, "float32", kernels, cf)
    jp = jax.tree.map(jnp.asarray, params)
    toks = jnp.asarray(_tokens(cfg))
    if not decode:
        h, _ = REF_TF.forward_hidden(jp, rcfg, REF_TF.embed_inputs(
            jp, rcfg, tokens=toks))
        return _vocab(REF_TF.logits_fn(jp, rcfg, h), cfg)
    caches = REF_TF.init_caches(rcfg, B, S)
    step = jax.jit(REF_TF.decode_step, static_argnums=1)
    outs = []
    for i in range(S):
        lg, caches = step(jp, rcfg, toks[:, i:i + 1], caches,
                          jnp.asarray(i, jnp.int32))
        outs.append(_vocab(lg, cfg))
    return np.stack(outs, 1)


def _port_logits(arch, kernels, decode, cf=1.25):
    _, _, cfg = _model_cfgs(arch, "float32", kernels, cf)
    model = _port_model(arch, "float32")
    toks = torch.from_numpy(_tokens(cfg))
    with torch.no_grad():
        if not decode:
            h, _ = TF.forward_hidden(model, cfg, TF.embed_inputs(
                model, cfg, tokens=toks))
            return _vocab(TF.logits_fn(model, cfg, h), cfg)
        caches = TF.init_caches(cfg, B, S, device="cpu")
        outs = []
        for i in range(S):
            lg, caches = TF.decode_step(model, cfg, toks[:, i:i + 1], caches, i)
            outs.append(_vocab(lg, cfg))
    return np.stack(outs, 1)


@pytest.mark.parametrize("kernels", PATHS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
class TestModelF32:
    def test_forward(self, arch, kernels):
        assert _rel(_port_logits(arch, kernels, False),
                    _ref_logits(arch, kernels, False)) <= MODEL_F32_TOL

    def test_decode(self, arch, kernels):
        """16 teacher-forced decode steps (the sort semantics at T = 2)."""
        assert _rel(_port_logits(arch, kernels, True),
                    _ref_logits(arch, kernels, True)) <= MODEL_F32_TOL

    def test_decode_matches_forward(self, arch, kernels):
        """At capacity factor 8.0 neither semantics drops a pair."""
        assert _rel(_port_logits(arch, kernels, True, 8.0),
                    _port_logits(arch, kernels, False, 8.0)) <= DECODE_TOL


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_loss_with_aux_matches_reference(arch):
    rcfg, params, cfg = _model_cfgs(arch, "float32", False)
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
    # two MoE layers' aux losses, each ~1 (the reference's 0.02 router)
    assert 1.5 < float(got_m["aux"]) < 2.5
    np.testing.assert_allclose(float(got_m["aux"]), float(want_m["aux"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(got_m["ce"]), float(want_m["ce"]), rtol=1e-5)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _ref_layer_inputs(arch, kernels):
    """The reference's bf16 prefill layer by layer: for each layer, its
    input x, its attention branch, its normed MoE input u and the MoE's
    output."""
    rcfg, params, cfg = _model_cfgs(arch, "bfloat16", kernels)
    jp = jax.tree.map(jnp.asarray, params)
    x = REF_TF.embed_inputs(jp, rcfg, tokens=jnp.asarray(_tokens(cfg)))
    out = []
    for i in range(rcfg.n_layers):
        p = jax.tree.map(lambda a: a[i], jp["groups"]["b0"])
        a = REF_ATT.forward(p["attn"], rcfg,
                            REF_L.apply_norm(p["ln1"], x, rcfg.norm))
        u = REF_L.apply_norm(p["ln2"], x + a, rcfg.norm)
        m, _ = REF_MOE.forward(p["moe"], rcfg, u)
        g, n = MOE.groups(cfg, B, S, "einsum")[:2]
        e = REF_MOE._router(p["moe"], rcfg, u.reshape(g, n, -1))[2]
        out.append((x, a, u, m, np.asarray(e)))
        x = x + a + m
    return out


@pytest.mark.parametrize("kernels", PATHS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_layers_bf16(arch, kernels):
    """Each layer's attention on the reference's input to it, and its MoE
    on the reference's normed input to the MoE: 2e-2 of max, the same
    experts chosen."""
    _, _, cfg = _model_cfgs(arch, "bfloat16", kernels)
    model = _port_model(arch, "bfloat16")
    with torch.no_grad():
        for i, (x, a, u, m, e) in enumerate(_ref_layer_inputs(arch, kernels)):
            layer = model.layers[i]
            tx = torch.tensor(_np(x)).bfloat16()
            got_a = ATT.forward(layer.attn, cfg,
                                L.apply_norm(layer.ln1, tx, cfg.norm))
            assert _rel(got_a, a) <= BF16_TOL, (i, "attention")
            tu = torch.tensor(_np(u)).bfloat16()
            got_m, _ = MOE.forward(layer.moe, cfg, tu)
            assert _rel(got_m, m) <= BF16_TOL, (i, "moe")
            np.testing.assert_array_equal(
                MOE.assign(layer.moe, cfg, tu, "einsum")[2].numpy(), e)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def _tree_size(tree) -> int:
    return sum(int(np.prod(np.shape(x))) for x in jax.tree.leaves(tree))


@pytest.mark.parametrize("experts", [None, (1, 3)], ids=["all", "share_1_3"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_from_reference_loads_strictly(arch, experts):
    """Every element of the reference's tree lands in the port (a share:
    its experts and all the rest), ``load`` takes the state dict strictly."""
    rcfg, params = _weights(arch)
    sd = from_reference(params, rcfg, experts=experts)
    model = _port_model(arch, "float32", experts)
    E, held = rcfg.n_experts, (experts[1] - experts[0]) if experts else 4
    moe = params["groups"]["b0"]["moe"]
    expert_elems = sum(int(np.prod(moe[k].shape)) for k in ("wi", "wg", "wo"))
    assert sum(t.numel() for t in sd.values()) == \
        _tree_size(params) - expert_elems * (E - held) // E
    lo = experts[0] if experts else 0
    for g in range(rcfg.n_layers):
        layer = model.layers[g].moe
        assert layer.experts == (lo, lo + held)
        np.testing.assert_array_equal(layer.router.w.numpy(),
                                      np.asarray(moe["router"]["w"][g]))
        for k in ("wi", "wg", "wo"):
            np.testing.assert_array_equal(
                getattr(layer, k).numpy(), np.asarray(moe[k][g][lo:lo + held]))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_to_serving_keeps_the_router_f32(arch):
    """The router is multiplied in f32 (not a ``Dense``); the experts are
    cast to the activation dtype, as the reference casts them at use."""
    cfg = reduced_config(ARCHS[arch], layers_scale=2)
    model = to_serving(TF.init_params(cfg, device="cpu", experts=(0, 2)))
    dtypes = {n.split(".", 2)[-1]: p.dtype for n, p in model.named_parameters()}
    assert dtypes["moe.router.w"] == torch.float32
    assert {dtypes[f"moe.{k}"] for k in ("wi", "wg", "wo")} == {torch.bfloat16}
    assert dtypes["attn.wq.w"] == torch.bfloat16
    assert model.layers[0].moe.wi.shape[0] == 2


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_full_width_parameters_match_reference_tree(arch):
    """At the published widths (meta device): the port holds as many
    elements as the reference's abstract tree, and a share of 8 experts
    holds 8/E of the experts and all the rest."""
    cfg = ARCHS[arch]
    ref = jax.eval_shape(lambda: REF_TF.init_params(jax.random.PRNGKey(0),
                                                    REF_ARCHS[arch]))
    with torch.device("meta"):
        whole = _numel(cfg)
        share = _numel(cfg, experts=(0, min(8, cfg.n_experts)))
    assert whole == _tree_size(ref)
    expert = 3 * cfg.d_model * cfg.d_ff * cfg.n_layers
    assert whole - share == expert * (cfg.n_experts - min(8, cfg.n_experts))


def _numel(cfg, experts=None) -> int:
    return sum(p.numel() for p in TF.Transformer(cfg, experts=experts)
               .parameters())
