"""Gradients of the port's ``loss_fn`` against the reference's, every
family of the zoo, on the CPU.

For each of the ten archs at ``reduced_config`` (f32 activations, the
plain path: ``use_pallas=False`` / ``use_kernels=False``), the reference's
``init_params(PRNGKey(0))`` is redrawn as ``test_torch_models._perturb``
redraws it (every bias and norm, and the zero-initialised RG-LRU and sLSTM
gates, which would otherwise hide a gate the port ignores), carried over
with ``convert.from_reference``, and both packages take one
``SyntheticDataset`` batch: tokens for the decoders, features, labels and
the mask for the audio encoder, patches and text for the VLM.
``jax.value_and_grad(loss_fn)`` and the port's ``torch.autograd.grad``
are compared leaf by leaf, the reference's gradient tree flattened by the
same ``from_reference``.

Tolerances: the loss to 1e-5 relative (two f32 computations in two orders
of summation); each gradient leaf to 1e-4 in relative L2, and 1e-3 for
xlstm-1.3b.  A gradient sums products of f32 terms over every position in
each side's own order; on nine archs the largest leaf error measured is
3.4e-6 (recurrentgemma-9b), so 1e-4 leaves a margin of thirty.  xlstm-1.3b's
f32 backward amplifies rounding: the reference's own jitted and eager
gradients differ by up to 5.4e-5 a leaf there (3.1e-7 on stablelm-3b), as
its forward and decode already differ by 1.9e-4 of max |logit|
(``test_torch_recurrent``); the port sits at 2.3e-4 of the reference,
spread over every leaf from the sLSTM to the head (a wrong term would
concentrate in the leaves it feeds), and 1e-3 is the most any arch is
allowed.  A missing term of one position in 32 moves a leaf by ~3e-2.

The reference's gradients are jitted once per arch (~2-10 s each) and
shared by the loss and gradient tests.
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
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticDataset as RefSynthetic
from repro.models import transformer as REF_TF
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as TF
from repro_torch.models.convert import EXPERT_LEAVES, from_reference, load

from test_torch_models import _perturb

ALL = sorted(ARCHS)
B, S = 2, 32
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4
GRAD_TOL_BY_ARCH = {"xlstm-1.3b": 1e-3}


def _configs(arch):
    rcfg = dataclasses.replace(ref_reduced(REF_ARCHS[arch]), dtype="float32",
                               use_pallas=False)
    cfg = dataclasses.replace(reduced_config(ARCHS[arch]), dtype="float32",
                              use_kernels=False)
    return rcfg, cfg


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """(perturbed reference weights, batch, loss, aux metrics, gradients),
    all numpy."""
    rcfg, _ = _configs(arch)
    params = _perturb(REF_TF.init_params(jax.random.PRNGKey(0), rcfg))
    batch = RefSynthetic(rcfg, RefDataConfig(seq_len=S, batch_size=B,
                                             seed=5)).get_batch(3)
    jp = jax.tree.map(jnp.asarray, params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        REF_TF.loss_fn, has_aux=True), static_argnums=1)(jp, rcfg, jb)
    to_np = functools.partial(jax.tree.map, np.asarray)
    return (params, batch, float(loss), to_np(metrics), to_np(grads))


def _port_grads(arch, experts=None):
    """The port's loss, metrics and gradients by parameter name, from the
    reference's weights (holding ``experts`` of each MoE layer)."""
    rcfg, cfg = _configs(arch)
    params, batch, *_ = _reference(arch)
    model = load(cfg, from_reference(params, rcfg, experts=experts),
                 device="cpu", experts=experts)
    named = dict(model.named_parameters())
    for w in named.values():
        w.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = TF.loss_fn(model, cfg, tb)
    grads = torch.autograd.grad(loss, list(named.values()))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(named, grads)))


@pytest.fixture(scope="module")
def port():
    return functools.lru_cache(maxsize=None)(_port_grads)


def _rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    den = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / den) if den else \
        float(np.linalg.norm(got))


@pytest.mark.parametrize("arch", ALL)
def test_loss_matches_reference(arch, port):
    _, _, ref_loss, ref_metrics, _ = _reference(arch)
    loss, metrics, _ = port(arch)
    assert np.isfinite(ref_loss)
    assert float(loss) == pytest.approx(ref_loss, rel=LOSS_TOL)
    assert float(metrics["ce"]) == pytest.approx(float(ref_metrics["ce"]),
                                                 rel=LOSS_TOL)
    assert float(metrics["aux"]) == pytest.approx(float(ref_metrics["aux"]),
                                                  rel=LOSS_TOL, abs=1e-7)


@pytest.mark.parametrize("arch", ALL)
def test_gradients_match_reference(arch, port):
    rcfg, _ = _configs(arch)
    want = from_reference(_reference(arch)[4], rcfg)
    _, _, got = port(arch)
    assert sorted(got) == sorted(want)
    errs = {k: _rel_l2(got[k].numpy(), want[k].numpy()) for k in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL_BY_ARCH.get(arch, GRAD_TOL), \
        (worst, errs[worst])
    # every leaf carries gradient (the perturbed gates included)
    assert all(np.linalg.norm(want[k].numpy()) > 0 for k in want), \
        [k for k in want if not np.linalg.norm(want[k].numpy())]


MOE_ARCHS = [a for a in ALL if ARCHS[a].is_moe]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_expert_shares_hold_their_own_gradients(arch):
    """One MoE layer split into two expert shares: each share's expert
    gradients are exactly its slice of the whole layer's (the whole
    layer's output is the sum of the shares', and a share's experts reach
    only its own), and a share holds no gradient of another's experts."""
    rcfg, cfg = _configs(arch)
    params = _reference(arch)[0]
    E = cfg.n_experts
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (B, S, cfg.d_model), dtype=np.float32))
    cot = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, S, cfg.d_model), dtype=np.float32))

    def layer_grads(experts):
        model = load(cfg, from_reference(params, rcfg, experts=experts),
                     device="cpu", experts=experts)
        moe = model.layers[0].moe
        leaves = [moe.wi, moe.wg, moe.wo]
        for w in leaves:
            w.requires_grad_(True)
        out, _ = MOE.forward(moe, cfg, x)
        return out, torch.autograd.grad((out * cot).sum(), leaves)

    whole_out, whole = layer_grads(None)
    halves = [(0, E // 2), (E // 2, E)]
    outs = []
    for lo, hi in halves:
        out, share = layer_grads((lo, hi))
        outs.append(out)
        for name, g, w in zip(EXPERT_LEAVES, share, whole):
            assert g.shape[0] == hi - lo, name
            torch.testing.assert_close(g, w[lo:hi], rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(outs[0] + outs[1], whole_out, rtol=1e-5,
                               atol=1e-6)
