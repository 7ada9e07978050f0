"""The port's model zoo registry (``repro_torch.configs``) against the
reference's: every config equal field by field (``use_pallas`` is the
port's ``use_kernels``), ``param_count`` and ``model_bytes`` equal for all
ten archs, the meta-device input specs shaped as the reference's abstract
inputs, the converted state dict as large as the reference's tree, and
every head size an attention arch reaches taken by the port's attention
kernels (flash attention on prefill, decode attention on every decode
step of a decoder)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import all_cells as ref_all_cells
from repro.configs import reduced_config as ref_reduced
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.configs.shapes import input_specs as ref_input_specs
from repro.models import transformer as REF_TF
from repro_torch.configs import (ARCHS, all_cells, get_config, list_archs,
                                 reduced_config)
from repro_torch.configs.shapes import SHAPES, input_specs
from repro_torch.kernels.decode_attention import ops as DA
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.models.convert import from_reference, load
from repro_torch.models.transformer import Transformer

DENSE = ["stablelm-3b", "qwen2-7b", "codeqwen1.5-7b", "command-r-35b"]
#: The attention archs: the dense decoders, the MoE decoders and the
#: stub-frontend models.
ATTENTION = DENSE + ["qwen3-moe-235b-a22b", "grok-1-314b", "hubert-xlarge",
                     "internvl2-2b"]


def _fields(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d.pop("use_pallas", None)
    d.pop("use_kernels", None)
    return d


def test_registry_matches_reference():
    assert list_archs() == sorted(REF_ARCHS) and len(ARCHS) == 10
    assert all_cells() == ref_all_cells()
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")
    for name in ARCHS:
        assert _fields(ARCHS[name]) == _fields(REF_ARCHS[name]), name
        assert _fields(reduced_config(ARCHS[name], layers_scale=2)) == \
            _fields(ref_reduced(REF_ARCHS[name], layers_scale=2)), name


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_param_count_and_model_bytes(arch):
    cfg, ref = ARCHS[arch], REF_ARCHS[arch]
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert cfg.activation_dtype == getattr(torch, ref.dtype)
    for kind, batch, seq in (("train", 1, 0), ("prefill", 1, 0),
                             ("decode", 8, 32768), ("long_decode", 1, 524288)):
        assert cfg.model_bytes(4096, kind=kind, batch=batch, seq_len=seq) == \
            ref.model_bytes(4096, kind=kind, batch=batch, seq_len=seq)
    assert cfg.model_flops(4096, training=True) == ref.model_flops(4096, training=True)


def _attention_archs(decoders_only: bool):
    return [a for a in sorted(ARCHS) if ARCHS[a].has_attention
            and (ARCHS[a].is_decoder or not decoders_only)]


@pytest.mark.parametrize("arch", _attention_archs(False))
def test_flash_attention_takes_every_head_size(arch):
    """Every arch with attn/local blocks runs K5 on prefill at its head
    size (stablelm-3b and hubert-xlarge: 80, on the tensor cores for bf16)."""
    D = ARCHS[arch].head_dim
    assert D in FA.HEAD_DIMS
    assert FA.kernel_path(torch.bfloat16, D) == "wgmma"


@pytest.mark.parametrize("arch", _attention_archs(True))
def test_decode_attention_takes_every_head_size(arch):
    """Every decoder with attention runs K4 on each decode step at its head
    size, natively (80: stablelm-3b; 256: recurrentgemma-9b's local
    attention over its 2,048-row ring)."""
    assert ARCHS[arch].head_dim in DA.HEAD_DIMS


def test_zoo_head_sizes():
    dims = {a: ARCHS[a].head_dim for a in _attention_archs(False)}
    assert {dims["stablelm-3b"], dims["hubert-xlarge"]} == {80}
    assert dims["recurrentgemma-9b"] == 256
    assert set(dims.values()) == {80, 128, 256}


def _tree_size(tree) -> int:
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_converted_state_dict_holds_every_element(arch):
    cfg = ref_reduced(REF_ARCHS[arch], layers_scale=2)
    params = REF_TF.init_params(jax.random.PRNGKey(0), cfg)
    sd = from_reference(params, cfg)
    assert sum(t.numel() for t in sd.values()) == _tree_size(params)


@pytest.mark.parametrize("arch", DENSE)
def test_converted_state_dict_loads_strictly(arch):
    cfg = reduced_config(ARCHS[arch], layers_scale=2)
    params = REF_TF.init_params(jax.random.PRNGKey(0), ref_reduced(
        REF_ARCHS[arch], layers_scale=2))
    model = load(cfg, from_reference(params, cfg), device="cpu")
    np.testing.assert_array_equal(
        model.layers[1].attn.wq.w.numpy(),
        np.asarray(params["groups"]["b0"]["attn"]["wq"]["w"][1]))


@pytest.mark.parametrize("arch", DENSE)
def test_full_width_parameters_match_reference_tree(arch):
    """The port's parameters at the published widths, on the meta device,
    hold as many elements as the reference's abstract tree."""
    with torch.device("meta"):
        model = Transformer(ARCHS[arch])
    ref = jax.eval_shape(lambda: REF_TF.init_params(jax.random.PRNGKey(0),
                                                    REF_ARCHS[arch]))
    assert sum(p.numel() for p in model.parameters()) == _tree_size(ref)


@pytest.mark.parametrize("arch", ATTENTION)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_input_specs_match_reference(arch, shape):
    got = input_specs(ARCHS[arch], SHAPES[shape])
    want = ref_input_specs(REF_ARCHS[arch], REF_SHAPES[shape])
    if "batch" in want:
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in got["batch"].items()} == \
            {k: (tuple(v.shape), str(v.dtype)) for k, v in want["batch"].items()}
        return
    assert tuple(got["tokens"].shape) == tuple(want["tokens"].shape)
    assert got["index"].shape == () and got["index"].device.type == "meta"
    stacked = want["caches"]["groups"]["b0"]["k"].shape
    assert len(got["caches"]) == stacked[0] == ARCHS[arch].n_layers
    for cache in got["caches"]:
        assert tuple(cache["k"].shape) == tuple(stacked[1:])
        assert cache["v"].shape == cache["k"].shape
        assert cache["k"].device.type == "meta"


RECURRENT = ["recurrentgemma-9b", "xlstm-1.3b"]


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_state_dict_loads_strictly(arch):
    """Stacked 3-D leaves (the mLSTM's per-head maps) and the unscanned
    ``rest`` layers land on their layers."""
    rcfg = ref_reduced(REF_ARCHS[arch], layers_scale=2)
    params = REF_TF.init_params(jax.random.PRNGKey(0), rcfg)
    model = load(reduced_config(ARCHS[arch], layers_scale=2),
                 from_reference(params, rcfg), device="cpu")
    n = len(rcfg.block_pattern)
    if arch == "xlstm-1.3b":
        got = model.layers[n + 1].cell.wq
        want = params["groups"]["b1"]["cell"]["wq"][1]
        assert got.dim() == 3 and model.layers[n + 1].cell.down.w.dim() == 3
    else:
        got = model.layers[-1].rec.lam
        want = params["rest"][1]["rec"]["lam"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_full_width_parameters_match_reference_tree(arch):
    with torch.device("meta"):
        model = Transformer(ARCHS[arch])
    ref = jax.eval_shape(lambda: REF_TF.init_params(jax.random.PRNGKey(0),
                                                    REF_ARCHS[arch]))
    assert sum(p.numel() for p in model.parameters()) == _tree_size(ref)


@pytest.mark.parametrize("arch", RECURRENT)
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_recurrent_input_specs_match_reference(arch, shape):
    """Decode inputs hold each layer's state on the meta device in
    ``init_caches``' layout, shaped and typed as the reference's abstract
    caches (layer g * len(pattern) + j is the stacked group's b{j} at
    index g, then ``rest``): the rings of ``local_window`` rows, the
    RG-LRU's h and conv, the mLSTM's C and n, the sLSTM's c, n, h, m and
    conv (bf16, the full config's activation dtype)."""
    cfg, spec = ARCHS[arch], SHAPES[shape]
    got = input_specs(cfg, spec)["caches"]
    want = ref_input_specs(REF_ARCHS[arch], REF_SHAPES[shape])["caches"]
    n = len(cfg.block_pattern)
    assert len(got) == cfg.n_layers
    for i, state in enumerate(got):
        g, j = divmod(i, n)
        ref = (jax.tree.map(lambda a: (a.shape[1:], a.dtype),
                            want["groups"][f"b{j}"])
               if g < cfg.pattern_repeats else
               jax.tree.map(lambda a: (a.shape, a.dtype),
                            want["rest"][i - n * cfg.pattern_repeats]))
        assert set(state) == set(ref)
        for key, t in state.items():
            assert t.device.type == "meta" and t.shape[0] == spec.global_batch
            assert (tuple(t.shape), str(t.dtype).split(".")[-1]) == \
                (tuple(ref[key][0]), str(ref[key][1]))
